// Nearest-pixel image binning for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel xicsrt_tpu/ops/pallas_binning.py::_bin_kernel
// (bin_image_pallas), which forms one-hot tiles and contracts them on the
// MXU. On this card a histogram is a scatter: one grid-stride pass over the
// rays, each ray rounds its pixel (round half to even) and does one
// shared-memory atomicAdd into a block-private image; each block then
// flushes its image with global atomicAdd. Images beyond the shared-memory
// budget accumulate with global atomics directly.
//
// What bounds it: the ray stream is 17 bytes per ray of device memory, far
// below what the atomics cost; the limit is shared-memory atomic
// throughput, worst on hot pixels (a narrow spectral line sends many rays
// of a warp to one address, which the hardware serialises) and on bank
// conflicts between them. The flush adds one global atomic per non-zero
// pixel per block, so the grid is held to the blocks that are resident at
// once.
#include <cuda_runtime.h>

#include "binning.cuh"

namespace {

__global__ void bin_image_kernel(const float* __restrict__ x_local,
                                 const unsigned char* __restrict__ mask,
                                 const float* __restrict__ weight, long long n,
                                 int nx, int ny, float inv_ps, float half_x,
                                 float half_y, float* __restrict__ out,
                                 int use_smem) {
    extern __shared__ float s_img[];
    const int n_pix = nx * ny;
    if (use_smem) {
        xrt_smem_zero(s_img, n_pix);
        __syncthreads();
    }
    float* img = use_smem ? s_img : out;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
         r += stride) {
        if (!mask[r]) continue;
        // x / ps + (n-1)/2 as XLA evaluates binning.py:36 under jit: a
        // multiply by the float32 reciprocal, fused with the add.
        const float fx = fmaf(x_local[3 * r], inv_ps, half_x);
        const float fy = fmaf(x_local[3 * r + 1], inv_ps, half_y);
        int flat;
        if (xrt_nearest_pixel(fx, fy, nx, ny, &flat)) {
            atomicAdd(img + flat, weight[r]);
        }
    }
    if (use_smem) {
        __syncthreads();
        xrt_smem_flush(s_img, out, n_pix);
    }
}

}  // namespace

// x_local: (n, 3) float32, mask: (n,) bool, weight: (n,) float32, out: (nx,
// ny) float32 zeroed by the caller; inv_ps = 1 / (float)pixel_size rounded to
// float32. Returns cudaGetLastError() of the launch.
extern "C" int xrt_bin_image(const float* x_local, const unsigned char* mask,
                             const float* weight, long long n, int nx, int ny,
                             float inv_ps, float half_x, float half_y,
                             float* out, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    const int threads = 256;
    const long long n_pix = (long long)nx * ny;
    const int use_smem = n_pix <= XRT_SMEM_IMAGE_MAX_FLOATS;
    const size_t smem = use_smem ? (size_t)n_pix * sizeof(float) : 0;
    cudaError_t err = xrt_set_smem(bin_image_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = xrt_grid_size(bin_image_kernel, threads, smem, n);
    bin_image_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        x_local, mask, weight, n, nx, ny, inv_ps, half_x, half_y, out,
        use_smem);
    return (int)cudaGetLastError();
}
