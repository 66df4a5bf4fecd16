// The kernel K1 and its launcher, shared by fused_trace.cu (its builds
// without history) and fused_history.cu (its builds that mark the chunks
// with a found ray, for the history reservoir K1e). The kernel is
// described in fused_trace.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// kSrc: the source's build (xrt_k1_source). kCheb: the chain's mesh stage;
// kStages: its weight and bilinear stages (1), and the mosaic's (2)
// (trace_chain.cuh). kMark: set marks[c] = 1 for each chunk c of `chunk`
// rays whose final element keeps a ray (K1e's 'found' mode); a chunk is a
// multiple of 32 rays, so a warp's rays lie in one chunk and one ballot
// decides it.
template <int kSrc, bool kCheb, int kStages, bool kMark>
__global__ void fused_trace_kernel(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip,
    int n_ip, const float* __restrict__ aux, long long n_total, long long count,
    const float* __restrict__ uniforms, uint32_t seed0, uint32_t seed1,
    const int* __restrict__ cum, const float* __restrict__ table,
    int n_bundles, int n_per_iter, unsigned long long* __restrict__ counts,
    float* __restrict__ images, int img_total, int use_smem,
    int* __restrict__ marks, int chunk) {
    extern __shared__ float s_img[];
    __shared__ float fp[XRT_MAX_FP];
    __shared__ int ip[XRT_MAX_IP];
    __shared__ unsigned int s_counts[XRT_MAX_OPTICS + 1];

    for (int i = threadIdx.x; i < n_fp; i += blockDim.x) fp[i] = g_fp[i];
    for (int i = threadIdx.x; i < n_ip; i += blockDim.x) ip[i] = g_ip[i];
    for (int i = threadIdx.x; i < XRT_MAX_OPTICS + 1; i += blockDim.x) {
        s_counts[i] = 0u;
    }
    if (use_smem) xrt_smem_zero(s_img, img_total);
    __syncthreads();

    float* img = use_smem ? s_img : images;
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
        xrt_count_warp(s_counts, 0, alive, lane);
        const bool found = xrt_trace_chain<kCheb, kStages>(
            fp, ip, aux, draw, px, py, pz, dx, dy, dz, wl, per_ray_wl, alive, 1.0f,
            s_counts, img, lane);
        if constexpr (kMark) {
            if (__ballot_sync(0xffffffffu, found) && lane == 0) marks[r0 / chunk] = 1;
        }
    }

    __syncthreads();
    for (int i = threadIdx.x; i <= n_opt; i += blockDim.x) {
        if (s_counts[i]) {
            atomicAdd(counts + i, (unsigned long long)s_counts[i]);
        }
    }
    if (use_smem) xrt_smem_flush(s_img, images, img_total);
}

// Launches the build of K1 the run takes (the arguments of xrt_fused_trace,
// fused_trace.cu), with kMark the builds that also mark the chunks of
// `chunk` rays that keep a ray at the final element into marks
// (ceil(n_total / chunk) int32, zeroed by the caller). Returns
// cudaGetLastError() of the launch.
template <bool kMark>
inline int xrt_fused_launch(const float* fp, int n_fp, const int* ip, int n_ip,
                            const float* aux, int n_aux, long long n_total,
                            long long count, const float* uniforms, unsigned int seed0,
                            unsigned int seed1, const int* cum, const float* table,
                            int n_bundles, long long n_per_iter,
                            unsigned long long* counts, float* images, int img_total,
                            int full_source, int cheb, int stages, int* marks,
                            int chunk, void* stream) {
    if (n_fp > XRT_MAX_FP || n_ip > XRT_MAX_IP || aux == nullptr || n_aux <= 0 ||
        stages < 0 || stages > 2) {
        return (int)cudaErrorInvalidValue;
    }
    if (cum != nullptr && (n_bundles <= 0 || n_per_iter <= 0 ||
                           n_per_iter >= (1LL << 31) || n_total % n_per_iter)) {
        return (int)cudaErrorInvalidValue;
    }
    if (kMark && (marks == nullptr || chunk <= 0 || chunk % 32)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_total <= 0) return (int)cudaSuccess;
    const int threads = 256;
    const int use_smem = img_total <= XRT_SMEM_IMAGE_MAX_FLOATS;
    const size_t smem = use_smem ? (size_t)img_total * sizeof(float) : 0;
    using Kernel = decltype(&fused_trace_kernel<XRT_K1_POINT, false, 0, kMark>);
#define XRT_K1_BUILDS(S)                                                          \
    fused_trace_kernel<S, false, 0, kMark>, fused_trace_kernel<S, false, 1, kMark>, \
        fused_trace_kernel<S, false, 2, kMark>, fused_trace_kernel<S, true, 0, kMark>, \
        fused_trace_kernel<S, true, 1, kMark>, fused_trace_kernel<S, true, 2, kMark>
    const Kernel kernels[18] = {XRT_K1_BUILDS(XRT_K1_POINT), XRT_K1_BUILDS(XRT_K1_GENERIC),
                                XRT_K1_BUILDS(XRT_K1_PLASMA)};
#undef XRT_K1_BUILDS
    const int src = cum != nullptr ? XRT_K1_PLASMA
                                   : full_source ? XRT_K1_GENERIC : XRT_K1_POINT;
    const Kernel kernel = kernels[6 * src + (cheb ? 3 : 0) + stages];
    cudaError_t err = xrt_set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = xrt_grid_size(kernel, threads, smem, n_total);
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        fp, n_fp, ip, n_ip, aux, n_total, count, uniforms, seed0, seed1, cum,
        table, n_bundles, (int)n_per_iter, counts, images, img_total,
        use_smem, marks, chunk);
    return (int)cudaGetLastError();
}

}  // namespace
