// Trace-only kernel K3 for NVIDIA Hopper (sm_90a): rays generated by the
// eager engine, read from device memory, traced through the optic chain
// with per-element counts and nearest-pixel or bilinear images, in mc or
// weight mode.
//
// Replaces xicsrt_tpu/ops/fused_trace.py::build_fused_trace_run (kernel at
// :2081, pallas_call :2156), the TPU's route for sources the megakernel
// cannot generate; on this card that is a plasma of more than 2^22 bundles
// (ops/fused_trace.py: build_fast_run). The chain is K1's own device
// function (trace_chain.cuh), so the two kernels trace alike; every ray
// takes its Bragg angle from its own wavelength, as the TPU kernel does.
//
// One thread carries one ray: 29 bytes read (origin and direction as
// (n, 3) float32 rows, wavelength, a one-byte mask), 33 in weight mode,
// which streams the rays' weights as a ninth array as the TPU kernel does
// (fused_trace.py:2054-2056), then registers only. Draws: the chain's (one
// uniform per crystal in mc mode, three per mosaic layer), from an
// explicit (n_draws, n) float32 tensor or Philox keyed by (seed, ray,
// draw), as in K1. What bounds it:
// the chain's arithmetic (the bytes take about a tenth of the time of the
// flagship chain's operations at the card's rates), plus the image atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "binning.cuh"
#include "trace_chain.cuh"
#include "trace_common.cuh"

namespace {

// One ray as K3 reads it: 29 bytes, 33 with its weight.
struct RayIn {
    float px, py, pz, dx, dy, dz, wl, wt;
    bool alive;
};

// Ray r (clamped to n - 1; a lane past the end carries a dead ray).
template <int kStages>
__device__ __forceinline__ RayIn xrt_load_ray(
    long long r, long long n, const float* __restrict__ origin,
    const float* __restrict__ direction, const float* __restrict__ wavelength,
    const unsigned char* __restrict__ mask, const float* __restrict__ weight) {
    const long long ray = r < n ? r : n - 1;
    RayIn in;
    in.px = origin[3 * ray];
    in.py = origin[3 * ray + 1];
    in.pz = origin[3 * ray + 2];
    in.dx = direction[3 * ray];
    in.dy = direction[3 * ray + 1];
    in.dz = direction[3 * ray + 2];
    in.wl = wavelength[ray];
    in.alive = r < n && mask[ray] != 0;
    in.wt = kStages >= 1 && weight != nullptr ? weight[ray] : 1.0f;
    return in;
}

template <bool kCheb, int kStages>
__global__ void trace_only_kernel(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip,
    int n_ip, const float* __restrict__ aux, long long n,
    const float* __restrict__ origin,
    const float* __restrict__ direction, const float* __restrict__ wavelength,
    const unsigned char* __restrict__ mask, const float* __restrict__ weight,
    const float* __restrict__ uniforms,
    uint32_t seed0, uint32_t seed1, unsigned long long* __restrict__ counts,
    float* __restrict__ images, int img_total, int use_smem) {
    // The head of the dynamic shared memory (xrt_head_floats): the
    // per-element counters, ip and fp, sized by the run; the staged images
    // follow.
    extern __shared__ __align__(16) float s_dyn[];
    unsigned int* const s_counts = reinterpret_cast<unsigned int*>(s_dyn);
    int* const ip = reinterpret_cast<int*>(s_dyn + XRT_HEAD_COUNTS);
    float* const fp = s_dyn + XRT_HEAD_COUNTS + xrt_round4(n_ip);
    float* const s_img = s_dyn + xrt_head_floats(n_fp, n_ip);

    xrt_head_load(fp, g_fp, n_fp, ip, g_ip, n_ip, s_counts, XRT_HEAD_COUNTS);
    if (use_smem) xrt_smem_zero(s_img, img_total);
    __syncthreads();

    const XrtImage<float> img{use_smem ? s_img : images};
    const int n_opt = ip[0];
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * blockDim.x;

    // Whole warps step together, so every lane reaches every __ballot_sync;
    // lanes past the end carry dead rays.
    for (long long r0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
         r0 < n; r0 += stride) {
        const long long r = r0 + lane;
        const RayIn in = xrt_load_ray<kStages>(r, n, origin, direction, wavelength, mask,
                                               weight);
        Draws draw{uniforms, n, r < n ? r : n - 1, seed0, seed1, 0, -1, {0u, 0u, 0u, 0u}};
        xrt_count_source(s_counts, in.alive, lane);
        xrt_trace_chain<kCheb, kStages>(fp, ip, aux, draw, in.px, in.py, in.pz, in.dx,
                                        in.dy, in.dz, in.wl, true, in.alive, in.wt,
                                        s_counts, img, lane);
    }

    __syncthreads();
    xrt_flush_counts(s_counts, n_opt, counts);
    if (use_smem) xrt_smem_flush(s_img, images, img_total);
}

}  // namespace

// fp/ip: the chain packed by ops/fused_trace.py (source kind 3, rays from
// memory). n rays: origin and direction (n, 3) float32, wavelength (n,)
// float32, mask (n,) bytes (0 dead), and in weight mode (header int
// XRT_H_WEIGHT) weight (n,) float32, else null. aux: n_aux float32 of file
// tables and Chebyshev terms (never null); cheb: the chain's mesh stage;
// stages: 0, or 1 for its weight and bilinear stages, 2 with the mosaic's
// too. uniforms: (n_draws, n)
// float32 or null for Philox keyed by (seed0, seed1). counts: (1 +
// n_optics) uint64 and images: (img_total,) float32, both zeroed by the
// caller. Returns cudaGetLastError() of the launch.
extern "C" int xrt_trace_only(const float* fp, int n_fp, const int* ip,
                              int n_ip, const float* aux, int n_aux, long long n,
                              const float* origin, const float* direction,
                              const float* wavelength, const unsigned char* mask,
                              const float* weight, const float* uniforms,
                              unsigned int seed0, unsigned int seed1,
                              unsigned long long* counts, float* images,
                              int img_total, int cheb, int stages, void* stream) {
    if (n_fp < XRT_SRC_F || n_ip < XRT_HDR_I || aux == nullptr || n_aux <= 0 ||
        stages < 0 || stages > 2 || (weight != nullptr && stages == 0)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n <= 0) return (int)cudaSuccess;
    const int threads = 256;
    using Kernel = decltype(&trace_only_kernel<false, 0>);
    const Kernel kernels[6] = {trace_only_kernel<false, 0>, trace_only_kernel<false, 1>,
                               trace_only_kernel<false, 2>, trace_only_kernel<true, 0>,
                               trace_only_kernel<true, 1>,  trace_only_kernel<true, 2>};
    const Kernel kernel = kernels[(cheb ? 3 : 0) + stages];
    // The head, and the images staged behind it where they fit; a head too
    // large for a block's shared memory fails xrt_set_smem.
    const size_t head = (size_t)xrt_head_floats(n_fp, n_ip) * sizeof(float);
    const size_t staged = head + (size_t)img_total * sizeof(float);
    const int use_smem = img_total <= XRT_SMEM_IMAGE_MAX_FLOATS &&
                         xrt_set_smem(kernel, staged) == cudaSuccess;
    const size_t smem = use_smem ? staged : head;
    cudaError_t err = xrt_set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = xrt_grid_size(kernel, threads, smem, n);
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        fp, n_fp, ip, n_ip, aux, n, origin, direction, wavelength, mask, weight,
        uniforms, seed0, seed1, counts, images, img_total, use_smem);
    return (int)cudaGetLastError();
}
