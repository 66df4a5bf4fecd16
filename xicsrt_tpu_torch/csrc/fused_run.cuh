// The kernel K1 and its launcher, shared by fused_trace.cu (its builds
// without history) and fused_history.cu (its builds that mark the chunks
// with a found ray, for the history reservoir K1e). The kernel is
// described in fused_trace.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "binning.cuh"
#include "bundle_lookup.cuh"
#include "trace_chain.cuh"
#include "trace_common.cuh"

// The source kinds of K1's builds (kSrc): the generic sampler's
// point-source cut (which gives a point source the same values), the whole
// generic sampler, a plasma of bundle tables. A build holds only its own
// sampler: the plasma's lookup and sampler cost the others no registers,
// nor the generic sampler the plasma's. XRT_K1_ANY, for K1e's record
// kernel, branches at run time between the plasma and the whole generic
// sampler.
#define XRT_K1_POINT 0
#define XRT_K1_GENERIC 1
#define XRT_K1_PLASMA 2
#define XRT_K1_ANY 3

// Ray r's source in K1: a plasma ray's bundle and the plasma sampler, or
// the generic sampler (its point-source cut in the XRT_K1_POINT builds).
// draw is keyed by the ray index clamped to n_total - 1, so rays past the
// end take that ray's draws and are dead. Every lane of the warp calls it
// (the bundle search is the warp's). Returns whether the ray is alive at
// the source.
template <int kSrc>
__device__ __forceinline__ bool xrt_k1_source(
    const float* fp, const int* ip, bool voxel, bool cauchy, Draws& draw, long long r,
    long long count, const int* __restrict__ cum, const float* __restrict__ table,
    int n_bundles, int n_per_iter, int lane, float& px, float& py, float& pz, float& dx,
    float& dy, float& dz, float& wl) {
    const bool in_range = r < draw.n_total;
    wl = 0.0f;
    const bool plasma = kSrc == XRT_K1_ANY ? ip[5] == XRT_SRC_PLASMA : kSrc == XRT_K1_PLASMA;
    bool keep;
    if (kSrc == XRT_K1_POINT) {
        xrt_sample_source<false>(fp, ip, draw, px, py, pz, dx, dy, dz, wl, keep);
        return in_range && r < count && keep;
    }
    if (plasma) {
        DrawsAhead ahead(draw, ip[3] > 4);  // the Philox calls before the lookup's loads
        const long long j = draw.ray / n_per_iter;
        const int local = (int)(draw.ray - j * n_per_iter);
        const int* cum_j = cum + j * n_bundles;
        const bool alive = in_range && local < __ldg(cum_j + n_bundles - 1);
        const int b = xrt_warp_bundle(cum_j, n_bundles, local, alive, lane);
        float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
        if (alive) xrt_bundle_row(table + j * n_bundles * 8, b, &lo, &hi);
        xrt_sample_plasma(fp, voxel, cauchy, ahead, lo, hi, px, py, pz, dx, dy, dz, wl);
        ahead.finish();
        return alive;
    }
    xrt_sample_source<true>(fp, ip, draw, px, py, pz, dx, dy, dz, wl, keep);
    return in_range && r < count && keep;
}

namespace {

// K1's kernel parameters (xrt_fused_trace, fused_trace.cu), and their
// names as its builds pass them on.
#define XRT_K1_PARAMS                                                              \
    const float *__restrict__ g_fp, int n_fp, const int *__restrict__ g_ip, int n_ip, \
        const float *__restrict__ aux, long long n_total, long long count,          \
        const float *__restrict__ uniforms, uint32_t seed0, uint32_t seed1,         \
        const int *__restrict__ cum, const float *__restrict__ table, int n_bundles, \
        int n_per_iter, unsigned long long *__restrict__ counts,                    \
        void *__restrict__ images, int img_total, int use_smem,                     \
        int *__restrict__ marks, int chunk, int win_lo, int win_n
#define XRT_K1_ARGS                                                                  \
    g_fp, n_fp, g_ip, n_ip, aux, n_total, count, uniforms, seed0, seed1, cum, table, \
        n_bundles, n_per_iter, counts, images, img_total, use_smem, marks, chunk,    \
        win_lo, win_n

// kSrc: the source's build (xrt_k1_source). kCheb: the chain's mesh stage;
// kStages: its weight and bilinear stages (1), and the mosaic's (2)
// (trace_chain.cuh). kMark: set marks[c] = 1 for each chunk c of `chunk`
// rays whose final element keeps a ray (K1e's 'found' mode); a chunk is a
// multiple of 32 rays, so a warp's rays lie in one chunk and one ballot
// decides it; its index takes a 32-bit division (n_total < 2^31). Where
// marks are given, the int past the last chunk's, marks[ceil(n_total /
// chunk)], is K1e's flag (fused_history.cu): a kMark build runs while it is
// clear, a build without marks (then given marks too) where it is set, and
// the other leaves at once; so a 'found' run issues both, and K1e's probe,
// which sets the flag on finding the kept chunks, picks one on the card.
// The flag is read before the loop: a flag kept across it spilled the flat
// build at its 48 registers. kShapes: the curved shapes the chain compiles
// (XRT_SHAPES_*, trace_chain.cuh; fused_trace_flat_kernel compiles none,
// fused_trace_cylinder_kernel the cylinder). images: float32 pixels at
// kStages 0, float64 from 1 (XrtImage, trace_chain.cuh), staged in the
// block's float32 shared histogram where use_smem is set (kStages 0, and
// kStaged: xrt_fused_pick); kWindow (kStages 0): pixels [win_lo, win_lo +
// win_n) staged as integer counts, the rest in global memory
// (XrtWindowImage), win_n 0 for none.
template <int kSrc, bool kCheb, int kStages, bool kMark, int kShapes, bool kWindow>
__device__ __forceinline__ void xrt_fused_trace_body(XRT_K1_PARAMS) {
    static_assert(!kWindow || kStages == 0, "a window stages unit adds");
    constexpr bool kStaged = kSrc == XRT_K1_POINT && !kCheb && kStages == 1 && kShapes != 0;
    // The head of the dynamic shared memory (xrt_head_floats): the
    // per-element counters, ip and fp, sized by the run; the staged image
    // or window follows it.
    extern __shared__ __align__(16) float s_dyn[];
    unsigned int* const s_counts = reinterpret_cast<unsigned int*>(s_dyn);
    int* const ip = reinterpret_cast<int*>(s_dyn + XRT_HEAD_COUNTS);
    float* const fp = s_dyn + XRT_HEAD_COUNTS + xrt_round4(n_ip);
    float* const s_img = s_dyn + xrt_head_floats(n_fp, n_ip);
    unsigned int* const s_win = reinterpret_cast<unsigned int*>(s_img);

    if (marks != nullptr) {  // uniform over the launch
        const unsigned int n_chunks =
            ((unsigned int)n_total + (unsigned int)chunk - 1u) / (unsigned int)chunk;
        if ((__ldg(marks + n_chunks) != 0) == kMark) return;
    }
    xrt_head_load(fp, g_fp, n_fp, ip, g_ip, n_ip, s_counts, XRT_HEAD_COUNTS);
    if constexpr (kWindow) {
        for (int i = threadIdx.x; i < win_n; i += blockDim.x) s_win[i] = 0u;
    } else if constexpr (kStages == 0 || kStaged) {
        if (use_smem) xrt_smem_zero(s_img, img_total);
    }
    __syncthreads();

    using Pixel = typename std::conditional<(kStages >= 1), double, float>::type;
    using Image = typename std::conditional<
        kWindow, XrtWindowImage,
        typename std::conditional<kStaged, XrtStagedImage, XrtImage<Pixel>>::type>::type;
    Pixel* const out = static_cast<Pixel*>(images);
    Image img{out};
    if constexpr (kWindow) {
        img.counts = s_win;
        img.lo = win_lo;
        img.n = win_n;
    } else if constexpr (kStaged) {
        if (use_smem) img.staged = s_img;
    } else if constexpr (kStages == 0) {
        if (use_smem) img.pix = s_img;
    }
    const int n_opt = ip[0];
    const bool voxel = ip[6] != 0, cauchy = ip[7] != 0;
    const bool per_ray_wl = ip[XRT_H_PER_RAY_WL] != 0;
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * blockDim.x;

    // Whole warps step together (blockDim is a multiple of 32), so every
    // lane reaches every __ballot_sync; lanes past the end carry dead rays.
    for (long long r0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
         r0 < n_total; r0 += stride) {
        const long long r = r0 + lane;
        const long long ray = r < n_total ? r : n_total - 1;
        Draws draw{uniforms, n_total, ray, seed0, seed1, 0, -1, {0u, 0u, 0u, 0u}};
        float px, py, pz, dx, dy, dz, wl;
        const bool alive = xrt_k1_source<kSrc>(fp, ip, voxel, cauchy, draw, r, count, cum,
                                               table, n_bundles, n_per_iter, lane, px, py,
                                               pz, dx, dy, dz, wl);
        xrt_count_source(s_counts, alive, lane);
        const bool found = xrt_trace_chain<kCheb, kStages, XrtNoRecord, kShapes>(
            fp, ip, aux, draw, px, py, pz, dx, dy, dz, wl, per_ray_wl, alive, 1.0f,
            s_counts, img, lane);
        if constexpr (kMark) {
            if (__ballot_sync(0xffffffffu, found) && lane == 0) {
                marks[(unsigned int)r0 / (unsigned int)chunk] = 1;
            }
        }
    }

    __syncthreads();
    xrt_flush_counts(s_counts, n_opt, counts);
    if constexpr (kWindow) {
        float* const g = out + win_lo;
        for (int i = threadIdx.x; i < win_n; i += blockDim.x) {
            if (s_win[i]) atomicAdd(g + i, (float)s_win[i]);
        }
    } else if constexpr (kStages == 0 || kStaged) {
        if (use_smem) xrt_smem_flush(s_img, out, img_total);
    }
}

template <int kSrc, bool kCheb, int kStages, bool kMark>
__global__ void fused_trace_kernel(XRT_K1_PARAMS) {
    xrt_fused_trace_body<kSrc, kCheb, kStages, kMark, XRT_SHAPES_ALL, false>(XRT_K1_ARGS);
}

// The point source's builds without the Chebyshev or mosaic stages and
// without the torus and cylinder code, for chains of planes and spheres
// (the flagship's): kStages 0, and 1 (weight mode, bilinear images; 1.04x
// against the build with that code, chip_ab.py `k1d_curved`). Without that
// code ptxas took the kStages 0 build from 63 registers to 76 (3 blocks of
// 256 a multiprocessor), so it is held to 5 blocks, 48 registers, where it
// spills nothing. The kStages 1 build takes 58 unbounded; held to 4 blocks
// it takes 53 and runs up to 2 % faster, and at 5 (48) it spills (chip_ab.py
// `k1d_unbounded`, `k1d_bounds_5`, PERF.md). A kernel of its own, as launch
// bounds on fused_trace_kernel would bound every build (ptxas took the
// Chebyshev builds from 74 to 117 registers under bounds of one block).
template <int kStages, bool kMark>
__global__ void __launch_bounds__(256, kStages == 0 ? 5 : 4)
    fused_trace_flat_kernel(XRT_K1_PARAMS) {
    xrt_fused_trace_body<XRT_K1_POINT, false, kStages, kMark, 0, false>(XRT_K1_ARGS);
}

// The point source's builds for chains whose curved shapes are cylinders
// (no torus), without the Chebyshev or mosaic stages: the torus's root and
// normal, which took the general build to 63 registers (4 blocks of 256),
// are not compiled. Held like fused_trace_flat_kernel, kStages 0 to 5
// blocks, with a window of its images staged (kWindow: the cylinder
// crystal's 10800 image floats do not fit beside 5 blocks, its detector's
// 800 do); kStages 1 to 4, its images staged whole (kStaged).
template <int kStages, bool kMark>
__global__ void __launch_bounds__(256, kStages == 0 ? 5 : 4)
    fused_trace_cylinder_kernel(XRT_K1_PARAMS) {
    xrt_fused_trace_body<XRT_K1_POINT, false, kStages, kMark, XRT_SHAPES_CYLINDER,
                         kStages == 0>(XRT_K1_ARGS);
}

// The point source's kStages 0 build for chains of planes and spheres
// whose rays reach an image with no Bragg or mosaic crystal to thin them
// (FusedParams.dense_images: the mirror chains): a window of its images
// staged (kWindow), at 5 blocks. A build of its own, so that K1a's build
// and its registers stay as they are.
template <bool kMark>
__global__ void __launch_bounds__(256, 5) fused_trace_dense_kernel(XRT_K1_PARAMS) {
    xrt_fused_trace_body<XRT_K1_POINT, false, 0, kMark, 0, true>(XRT_K1_ARGS);
}

// The build of K1 a run takes (the arguments of xrt_fused_trace,
// fused_trace.cu; xrt_fused_build), and the dynamic shared memory of its
// launch. Weighted and bilinear images
// (stages 1 and 2) are float sums of many terms: each term goes to a
// float64 pixel in global memory (XrtImage), unstaged, so they cost no
// resident block, and each pixel is rounded to float32 once (the bilinear
// flagship's detector image of 2^28 rays sums to its 3575015 rays within
// 1e-9; float32 global atomics alone summed it 48 short). Staged in each
// block's float32 shared histogram, the flagship's 15000 image floats
// (58.6 KB) beside K1's packed buffers held a build to 3 blocks of 256:
// the flagship 1.11-1.13x slower, the plasma's, the generic source's and
// the mosaic's builds 1-10 % slower; split over a cluster of
// 2 blocks, whose remote adds are compare-and-swap loops, 1.15-1.27x
// slower. Two builds keep staging: the point source's stage-1 builds with a
// curved shape's code, the torus chains' and fused_trace_cylinder_kernel<1>
// (XrtStagedImage, flushed into the float64 pixels), whose focusing chains
// put most terms on a few pixels; a cylinder in weight mode ran 2.6x slower
// on global float64 atomics
// (chip_ab.py `k1d_staged`, `k1d_cluster`, `k1d_curved_unstaged`,
// PERF.md).
// The nearest mc images of the builds without further stages add 1.0f,
// exact in any order: they are staged in a block-private float32 histogram
// only where that costs no resident block against the build's registers,
// else each hit is a float32 global atomic (1.12x, chip_ab.py
// `staged_images`). The threshold is the image that fits beside the blocks
// the registers allow: 228 KB over the blocks, less the head (the packed
// buffers and counters, sized by the run: 1472 bytes for the flagship) and
// the 1 KB the card keeps a block, about 13970 floats at 4 blocks and 11050
// at 5 for the flagship's head. The window builds (kWindow: fused_trace_cylinder_kernel<0>,
// fused_trace_dense_kernel) stage integer counts: of every pixel where
// that costs no block, or one block for a dense chain (dense: every ray
// reaches its images unthinned), else of the window the host asks for
// ([win_lo, win_hi): FusedParams.stage_window, the one image whose rays
// crowd onto a few pixels) where that costs none, else of none. Global
// atomics from every warp onto those few pixels wait on each other: the
// plane fold's mirror image took 0.27 of its 0.37 ms a 2^22 rays, and the
// convex cylinder mirror ran 2x slower with its detector alone staged at
// 5 blocks than with both images at 4; the mirror flagship ran 1.14x
// slower with both at 3 than with its detector alone at 5 (chip_ab.py
// `no_image_adds`, `cylinder_bounds_4`, `dense_spare_off`, PERF.md).
template <bool kMark>
struct XrtFusedPick {
    using Kernel = decltype(&fused_trace_kernel<XRT_K1_POINT, false, 0, kMark>);
    Kernel kernel;
    int threads;
    size_t smem;
    int use_smem;
    int win_lo, win_n;
};

// xrt_fused_pick's table of K1's builds: fused_trace_kernel's 18 (6 src +
// 3 cheb + stages), then fused_trace_flat_kernel<0, 1>,
// fused_trace_cylinder_kernel<0, 1> and fused_trace_dense_kernel.
constexpr int kXrtK1Flat = 18, kXrtK1Cylinder = 20, kXrtK1Dense = 22, kXrtK1Builds = 23;

// The build a run takes (the arguments of xrt_fused_pick): a point source's
// cut without the Chebyshev or mosaic stages and with no torus takes a
// build without the torus code: with the cylinder's where the chain holds
// one (shapes: XRT_SHAPES_*), else the plane's and the sphere's alone, with
// dense images where they are asked for (dense, stages 0); every other run
// fused_trace_kernel.
inline int xrt_fused_build(int src, int cheb, int stages, int shapes, int dense) {
    const bool point =
        src == XRT_K1_POINT && !cheb && stages <= 1 && !(shapes & XRT_SHAPES_TORUS);
    if (!point) return 6 * src + (cheb ? 3 : 0) + stages;
    if (shapes) return kXrtK1Cylinder + stages;
    return dense && stages == 0 ? kXrtK1Dense : kXrtK1Flat + stages;
}

// The threads of a block of the build a run takes. The point source's
// Chebyshev build of the weight and bilinear stages (a mesh crystal in
// weight mode or with bilinear images) takes 85 registers: 2 blocks of 256
// a multiprocessor (16 warps), 5 of 128 (20). A block's warps share out
// over the multiprocessor's 4 quarters of 16384 registers, so 3 blocks of
// 224 do not fit (6 warps of 88 registers in a quarter); held to 3 blocks
// of 256 (80 registers) it spilled (chip_ab.py `k1d_cheb_256`,
// `k1d_cheb_160`, PERF.md). Every other build, 256.
inline int xrt_fused_threads(int src, int cheb, int stages) {
    return src == XRT_K1_POINT && cheb && stages == 1 ? 128 : 256;
}

// Whether `floats` staged floats or counts beside the head's `head` bytes
// cost the build more than `spare` resident blocks (stages 0) or do not fit
// (after setting the kernel's dynamic shared memory to them).
template <class Kernel>
inline bool xrt_costs_a_block(Kernel kernel, int threads, int stages, size_t head,
                              int floats, int spare = 0) {
    const size_t bytes = head + (size_t)floats * sizeof(float);
    if (floats > XRT_SMEM_IMAGE_MAX_FLOATS || xrt_set_smem(kernel, bytes) != cudaSuccess) {
        return true;
    }
    int staged = 0, unstaged = 0;
    return stages == 0 &&
           cudaOccupancyMaxActiveBlocksPerMultiprocessor(&staged, kernel, threads, bytes) ==
               cudaSuccess &&
           cudaOccupancyMaxActiveBlocksPerMultiprocessor(&unstaged, kernel, threads, head) ==
               cudaSuccess &&
           staged < unstaged - spare;
}

// The bytes of K1's head (xrt_head_floats: the counters, ip and fp).
inline size_t xrt_k1_head_bytes(int n_fp, int n_ip) {
    return (size_t)xrt_head_floats(n_fp, n_ip) * sizeof(float);
}

// smem: the head's bytes (xrt_k1_head_bytes) and what the launch stages.
template <bool kMark>
inline XrtFusedPick<kMark> xrt_fused_pick(int src, int cheb, int stages, int shapes,
                                          int dense, int win_lo, int win_hi,
                                          int img_total, size_t head) {
    using Kernel = typename XrtFusedPick<kMark>::Kernel;
#define XRT_K1_STAGES(S, CHEB)                                                    \
    fused_trace_kernel<S, CHEB, 0, kMark>, fused_trace_kernel<S, CHEB, 1, kMark>, \
        fused_trace_kernel<S, CHEB, 2, kMark>
    const Kernel kernels[kXrtK1Builds] = {
        XRT_K1_STAGES(XRT_K1_POINT, false), XRT_K1_STAGES(XRT_K1_POINT, true),
        XRT_K1_STAGES(XRT_K1_GENERIC, false), XRT_K1_STAGES(XRT_K1_GENERIC, true),
        XRT_K1_STAGES(XRT_K1_PLASMA, false), XRT_K1_STAGES(XRT_K1_PLASMA, true),
        fused_trace_flat_kernel<0, kMark>, fused_trace_flat_kernel<1, kMark>,
        fused_trace_cylinder_kernel<0, kMark>, fused_trace_cylinder_kernel<1, kMark>,
        fused_trace_dense_kernel<kMark>};
#undef XRT_K1_STAGES
    const int build = xrt_fused_build(src, cheb, stages, shapes, dense);
    const int threads = xrt_fused_threads(src, cheb, stages);
    XrtFusedPick<kMark> pick{kernels[build], threads, head, 0, 0, 0};
    if (build == kXrtK1Cylinder || build == kXrtK1Dense) {  // kWindow
        const int lo[2] = {0, win_lo}, n[2] = {img_total, win_hi - win_lo};
        // A dense chain's whole image is worth one resident block.
        const int spare[2] = {dense ? 1 : 0, 0};
        for (int k = 0; k < 2; ++k) {
            if (n[k] > 0 && lo[k] >= 0 && lo[k] + n[k] <= img_total &&
                !xrt_costs_a_block(pick.kernel, threads, stages, head, n[k], spare[k])) {
                pick.smem = head + (size_t)n[k] * sizeof(float);
                pick.win_lo = lo[k];
                pick.win_n = n[k];
                break;
            }
        }
        return pick;
    }
    // kStaged of xrt_fused_trace_body: the point builds of stage 1 with a
    // curved shape's code and without the Chebyshev stage.
    const bool staged_float64 = build == 1 || build == kXrtK1Cylinder + 1;
    if (stages >= 1 && !staged_float64) return pick;  // float64 sums in global memory
    if (!xrt_costs_a_block(pick.kernel, threads, stages, head, img_total)) {
        pick.smem = head + (size_t)img_total * sizeof(float);
        pick.use_smem = 1;
    }
    return pick;
}

// Blocks a multiprocessor holds of the build and launch xrt_fused_pick
// makes for packed buffers of n_fp floats and n_ip ints
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor as the launcher calls it,
// blocks of xrt_fused_threads), with its dynamic shared bytes, the head's
// included, in *dyn_smem; -1 where the query fails.
template <bool kMark>
inline int xrt_fused_occupancy(int src, int cheb, int stages, int shapes, int dense,
                               int win_lo, int win_hi, int img_total, int n_fp, int n_ip,
                               int* dyn_smem) {
    const XrtFusedPick<kMark> pick = xrt_fused_pick<kMark>(
        src, cheb, stages, shapes, dense, win_lo, win_hi, img_total,
        xrt_k1_head_bytes(n_fp, n_ip));
    int blocks = 0;
    if (xrt_set_smem(pick.kernel, pick.smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pick.kernel, pick.threads,
                                                      pick.smem) != cudaSuccess) {
        return -1;
    }
    *dyn_smem = (int)pick.smem;
    return blocks;
}

// Launches the build of K1 the run takes (the arguments of xrt_fused_trace,
// fused_trace.cu), with kMark the builds that also mark the chunks of
// `chunk` rays that keep a ray at the final element into marks
// (ceil(n_total / chunk) + 1 int32, zeroed by the caller, the last K1e's
// flag: the kMark build runs while it is clear, the build without marks,
// given marks, where it is set; null for a run without history). images:
// img_total float32 pixels at stages 0, float64 at stages 1 and 2, zeroed
// by the caller. Returns cudaGetLastError() of the launch.
template <bool kMark>
inline int xrt_fused_launch(const float* fp, int n_fp, const int* ip, int n_ip,
                            const float* aux, int n_aux, long long n_total,
                            long long count, const float* uniforms, unsigned int seed0,
                            unsigned int seed1, const int* cum, const float* table,
                            int n_bundles, long long n_per_iter,
                            unsigned long long* counts, void* images, int img_total,
                            int full_source, int cheb, int stages, int shapes,
                            int dense, int win_lo, int win_hi, int* marks, int chunk,
                            void* stream) {
    if (n_fp < XRT_SRC_F || n_ip < XRT_HDR_I || aux == nullptr || n_aux <= 0 ||
        stages < 0 || stages > 2) {
        return (int)cudaErrorInvalidValue;
    }
    if (cum != nullptr && (n_bundles <= 0 || n_per_iter <= 0 ||
                           n_per_iter >= (1LL << 31) || n_total % n_per_iter)) {
        return (int)cudaErrorInvalidValue;
    }
    if ((kMark || marks != nullptr) && (marks == nullptr || chunk <= 0 || chunk % 32)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_total <= 0) return (int)cudaSuccess;
    const int src = cum != nullptr ? XRT_K1_PLASMA
                                   : full_source ? XRT_K1_GENERIC : XRT_K1_POINT;
    // A head too large for a block's shared memory fails xrt_set_smem.
    const XrtFusedPick<kMark> pick =
        xrt_fused_pick<kMark>(src, cheb, stages, shapes, dense, win_lo, win_hi, img_total,
                              xrt_k1_head_bytes(n_fp, n_ip));
    cudaError_t err = xrt_set_smem(pick.kernel, pick.smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = xrt_grid_size(pick.kernel, pick.threads, pick.smem, n_total);
    pick.kernel<<<blocks, pick.threads, pick.smem, (cudaStream_t)stream>>>(
        fp, n_fp, ip, n_ip, aux, n_total, count, uniforms, seed0, seed1, cum,
        table, n_bundles, (int)n_per_iter, counts, images, img_total,
        pick.use_smem, marks, chunk, pick.win_lo, pick.win_n);
    return (int)cudaGetLastError();
}

}  // namespace
