// Nearest-pixel image binning for NVIDIA Hopper (sm_90a): K2.
//
// Replaces the TPU kernel xicsrt_tpu/ops/pallas_binning.py::_bin_kernel
// (bin_image_pallas), which forms one-hot tiles and contracts them on the
// MXU. On this card a histogram is a scatter: each ray rounds its pixel
// (round half to even) and adds one shared-memory atomic into a
// block-private image; each block then flushes its image with global
// atomics. Images beyond the shared-memory budget accumulate with global
// atomics directly.
//
// One launch bins every image of an iteration (the eager engine hands the
// crystal's and the detector's together, ops/binning.bin_images_fused): the
// items are packed as offsets into one output, and blockIdx.y picks the
// item, so each block stages one item's image. A warp reads the mask of
// 512 rays in one 16-byte load a lane, skips them when none is set, and
// reads x, y (and the weight) only of the rays that are set, at
// consecutive rays across its lanes (bin_images_kernel). The main path's
// eager images take about 1.3 % of their rays, so the mask stream, 1 byte
// a ray, is what the kernel must read. A shared float atomicAdd compiles
// to a compare-and-swap loop on sm_90 (ATOMS.CAST in the SASS); where the
// host knows the weights are ones (mc transport), the block counts in
// unsigned shared counters (a native integer add) and flushes them as
// floats: integer counts below 2^24 are exact in float32, so the images
// are the float sums' bit for bit.
//
// What bounds it: the mask stream and the set rays' 12 bytes of device
// memory; on dense inputs the shared-memory atomics (a hot pixel
// serialises the warp's adds). The flush adds one global atomic per
// non-zero pixel per block, so the grid is held to the blocks that are
// resident at once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "binning.cuh"

// The images one launch bins.
#define XRT_BIN_MAX_ITEMS 8

namespace {

// One image: rays x (n, 3) float32, mask (n,) bool, weight (n,) float32;
// an (nx, ny) grid at out[offset:], pixel coordinate fma(x, inv_ps, half).
struct XrtBinItem {
    const float* x;
    const unsigned char* mask;
    const float* w;
    long long n;
    int nx, ny, offset;
    float inv_ps, half_x, half_y;
};

struct XrtBinItems {
    XrtBinItem item[XRT_BIN_MAX_ITEMS];
};

// The mask bytes of rays r0 .. r0 + 15 as four words, byte k of the group
// in byte k & 3 of word k >> 2; rays past n read as 0.
__device__ __forceinline__ uint4 xrt_mask16(const unsigned char* __restrict__ mask,
                                            long long r0, long long n, bool aligned) {
    if (aligned && r0 + 16 <= n) return __ldg(reinterpret_cast<const uint4*>(mask + r0));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        if (r0 + k < n) w[k >> 2] |= (uint32_t)__ldg(mask + r0 + k) << (8 * (k & 3));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// Adds one set ray r of item it to its image: unit counts (kUnit) or the
// weights into the block's shared image, or straight into the global one.
template <bool kUnit>
__device__ __forceinline__ void xrt_bin_ray(const XrtBinItem& it, long long r, bool staged,
                                            float* s_img, float* g_img) {
    // x / ps + (n-1)/2 as XLA evaluates binning.py:36 under jit: a multiply
    // by the float32 reciprocal, fused with the add.
    const float fx = fmaf(__ldg(it.x + 3 * r), it.inv_ps, it.half_x);
    const float fy = fmaf(__ldg(it.x + 3 * r + 1), it.inv_ps, it.half_y);
    int flat;
    if (!xrt_nearest_pixel(fx, fy, it.nx, it.ny, &flat)) return;
    const float w = kUnit ? 1.0f : __ldg(it.w + r);
    if (!staged) {
        atomicAdd(g_img + flat, w);
    } else if (kUnit) {
        atomicAdd(reinterpret_cast<unsigned int*>(s_img) + flat, 1u);
    } else {
        atomicAdd(s_img + flat, w);
    }
}

// kUnit: every weight is one; the staged image then counts in unsigned
// ints (aliasing s_img), and a global image adds 1.0f.
//
// A warp takes tiles of 512 rays: lane l loads the 16 mask bytes of rays
// 16 l .. 16 l + 15 in one 16-byte load, and a tile with no set ray is
// skipped after one ballot. Its rays are then binned in 16 rounds, round k
// taking ray 32 k + l in lane l (its mask byte shuffled from lane 2 k + l /
// 16), so that the lanes read x and the weights at consecutive rays, as a
// ray a thread would; a round whose two source lanes hold no set ray is
// skipped.
template <bool kUnit>
__global__ void bin_images_kernel(const XrtBinItems items, float* __restrict__ out,
                                  int use_smem) {
    extern __shared__ float s_img[];
    // The block's item, selected with constant indices: indexed by the
    // run-time blockIdx.y, the parameter block would be copied to local
    // memory.
    XrtBinItem it = items.item[0];
#pragma unroll
    for (int i = 1; i < XRT_BIN_MAX_ITEMS; ++i) {
        if ((int)blockIdx.y == i) it = items.item[i];
    }
    const int n_pix = it.nx * it.ny;
    const bool staged = use_smem != 0;
    if (staged) {
        xrt_smem_zero(s_img, n_pix);
        __syncthreads();
    }
    float* g_img = out + it.offset;
    const unsigned int all = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const bool aligned = (reinterpret_cast<uintptr_t>(it.mask) & 15) == 0;
    const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
    for (long long t0 = 512 * warp; t0 < it.n; t0 += 512 * warps) {
        const uint4 m = xrt_mask16(it.mask, t0 + 16 * lane, it.n, aligned);
        const unsigned int any = __ballot_sync(all, (m.x | m.y | m.z | m.w) != 0u);
        if (!any) continue;
        const int b = lane & 15;
        for (int k = 0; k < 16; ++k) {
            if (!((any >> (2 * k)) & 3u)) continue;
            const int src = 2 * k + (lane >> 4);
            const uint32_t w0 = __shfl_sync(all, m.x, src);
            const uint32_t w1 = __shfl_sync(all, m.y, src);
            const uint32_t w2 = __shfl_sync(all, m.z, src);
            const uint32_t w3 = __shfl_sync(all, m.w, src);
            const uint32_t word = (b & 8) ? ((b & 4) ? w3 : w2) : ((b & 4) ? w1 : w0);
            if ((word >> (8 * (b & 3))) & 0xffu) {
                xrt_bin_ray<kUnit>(it, t0 + 32 * k + lane, staged, s_img, g_img);
            }
        }
    }
    if (staged) {
        __syncthreads();
        const unsigned int* counts = reinterpret_cast<const unsigned int*>(s_img);
        for (int i = threadIdx.x; i < n_pix; i += blockDim.x) {
            const float v = kUnit ? (float)counts[i] : s_img[i];
            if (v != 0.0f) atomicAdd(g_img + i, v);
        }
    }
}

using BinKernel = decltype(&bin_images_kernel<false>);

// The build and dynamic shared memory of a launch whose largest image has
// max_pix pixels.
inline BinKernel xrt_bin_pick(int unit, long long max_pix, size_t* smem, int* use_smem) {
    *use_smem = max_pix <= XRT_SMEM_IMAGE_MAX_FLOATS;
    *smem = *use_smem ? (size_t)max_pix * sizeof(float) : 0;
    return unit ? bin_images_kernel<true> : bin_images_kernel<false>;
}

}  // namespace

// Bins n_items (1 .. XRT_BIN_MAX_ITEMS) images in one launch. Host arrays,
// one entry an item: ptrs (x_local (n, 3) float32, mask (n,) bool, weight
// (n,) float32 or null where unit; any null where n is 0) three device
// pointers; n its rays;
// shape (nx, ny, offset) three ints, its image at out[offset : offset + nx
// ny]; scale (inv_ps = 1 / (float)pixel_size rounded to float32, (nx -
// 1) / 2, (ny - 1) / 2) three floats. unit: every weight is one. out:
// out_total float32 zeroed by the caller. Returns cudaGetLastError() of the
// launch.
extern "C" int xrt_bin_images(const unsigned long long* ptrs, const long long* n,
                              const int* shape, const float* scale, int n_items, int unit,
                              float* out, long long out_total, void* stream) {
    if (n_items <= 0 || n_items > XRT_BIN_MAX_ITEMS) return (int)cudaErrorInvalidValue;
    XrtBinItems items = {};
    long long max_pix = 0, max_n = 0;
    for (int i = 0; i < n_items; ++i) {
        XrtBinItem& it = items.item[i];
        it.x = reinterpret_cast<const float*>(ptrs[3 * i]);
        it.mask = reinterpret_cast<const unsigned char*>(ptrs[3 * i + 1]);
        it.w = reinterpret_cast<const float*>(ptrs[3 * i + 2]);
        it.n = n[i];
        it.nx = shape[3 * i];
        it.ny = shape[3 * i + 1];
        it.offset = shape[3 * i + 2];
        it.inv_ps = scale[3 * i];
        it.half_x = scale[3 * i + 1];
        it.half_y = scale[3 * i + 2];
        const long long pix = (long long)it.nx * it.ny;
        if (it.n < 0 || it.nx <= 0 || it.ny <= 0 || it.offset < 0 ||
            it.offset + pix > out_total ||
            (it.n > 0 && (it.x == nullptr || it.mask == nullptr ||
                          (!unit && it.w == nullptr)))) {
            return (int)cudaErrorInvalidValue;
        }
        max_pix = pix > max_pix ? pix : max_pix;
        max_n = it.n > max_n ? it.n : max_n;
    }
    if (max_n == 0) return (int)cudaSuccess;
    const int threads = 256;
    size_t smem;
    int use_smem;
    const BinKernel kernel = xrt_bin_pick(unit, max_pix, &smem, &use_smem);
    cudaError_t err = xrt_set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    // The resident blocks, shared among the items; each item's blocks take
    // tiles of 512 rays a warp (16 a thread).
    const int resident = xrt_grid_size(kernel, threads, smem, 1LL << 40);
    const long long want = (max_n + 16LL * threads - 1) / (16LL * threads);
    long long per_item = resident / n_items;
    per_item = per_item < want ? per_item : want;
    const dim3 grid((unsigned)(per_item > 0 ? per_item : 1), (unsigned)n_items);
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(items, out, use_smem);
    return (int)cudaGetLastError();
}

// Blocks of 256 a multiprocessor holds of K2's launch whose largest image
// has max_pix pixels (cudaOccupancyMaxActiveBlocksPerMultiprocessor as the
// launcher calls it); -1 where the query fails.
extern "C" int xrt_bin_images_occupancy(long long max_pix, int unit) {
    size_t smem;
    int use_smem, blocks = 0;
    const BinKernel kernel = xrt_bin_pick(unit, max_pix, &smem, &use_smem);
    if (xrt_set_smem(kernel, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 256, smem) !=
            cudaSuccess) {
        return -1;
    }
    return blocks;
}
