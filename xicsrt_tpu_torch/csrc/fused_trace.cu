// Fused generate -> trace -> count -> image kernel for NVIDIA Hopper
// (sm_90a): K1a (the main spectrometer chain), K1b (the generic source
// matrix), K1f (the plasma source), the torus, cylinder, Chebyshev-mesh
// (K1c-cheb), file rocking (K1c-file), mirror (K1c-mirror) and mosaic
// (K1c-mosaic) stages of K1c, and weight mode with bilinear images (K1d).
//
// Replaces those cuts of the TPU megakernel
// xicsrt_tpu/ops/fused_trace.py::build_fused_run (kernel, with the generic
// sampler at :1538-1713, the plasma sampler at :1428-1537, and the shared
// optic chain _trace_chain with torus_local_quadratic_t at :616 and the
// cylinder at :784 and :903). One thread carries one ray in registers from
// the source through every optic; no per-ray state touches device memory.
//
// The subset: a generic source (point, uniform or gaussian box; isotropic,
// isotropic_xy, flat, flat_xy or gaussian cone; a constant axis or a
// Focused one; one wavelength, a uniform band or an exact Voigt line; bulk
// Doppler; sightline filters tested on the origin, xrt_sample_source), or a
// plasma whose per-iteration bundle tables
// (cum, table) were drawn before the launch; plane, sphere, torus or
// cylinder optics, and Chebyshev surrogates of smooth meshes, with x/y/z
// bounds and aperture logic (none/circle/square/rectangle/ellipse; and,
// not, or, nand, nor, xor, xnor); no interaction, a mirror, a Bragg
// crystal with a gaussian, step or tabulated (file) rocking curve, or a
// mosaic crystal of run-time depth, at each ray's own wavelength where the
// source varies it; Bernoulli (mc) acceptance, or weight mode, where each
// ray carries a weight in a register from 1 (fused_trace.py:1719);
// per-element counts of the rays alive; nearest-pixel or bilinear images of
// the weights. The chain is trace_chain.cuh, shared with the trace-only
// kernel K3 (trace_only.cu).
//
// Plasma: iteration j holds rays [j n, (j + 1) n) of the budget n; ray
// j n + l is alive iff l < cum_j[B-1], finds its bundle by binary search
// over cum_j (bundle_lookup.cuh) and loads its row. The TPU kernel's
// interval one-hot on the MXU, its 256-bundle windows, its page windows
// beyond 4096 bundles, the compaction sort that bounds them and its 4096-ray
// chunk cap all served VMEM; they have no counterpart here.
//
// Geometry and structure arrive at run time in two small buffers (float32
// and int32) packed by xicsrt_tpu_torch/ops/fused_trace.py, so one build
// serves every configuration of the subset; their layout is defined there
// (pack_params) and mirrored by the offsets of trace_common.cuh, which also
// holds the sampler, intersections and aperture logic shared with the
// gradient kernels (fused_grad.cu).
//
// Random numbers: either an explicit (n_draws, n_total) float32 tensor, or
// counter-based Philox4x32-10 keyed by (seed, ray index, draw index), so a
// ray's draws do not depend on the launch configuration. Draw order per
// ray: the source's (generic: one per nonzero box size, the cone's two, 0-2
// for the wavelength; plasma: 3 voxel offsets, u, v, the normal's uniform,
// the Cauchy uniform), then one uniform per crystal in mc mode and three
// per layer of a mosaic crystal.
//
// Numerics follow the TPU kernel and the plain PyTorch twin operation by
// operation: the Bragg deviation is the sine-difference identity with a
// cubic asin correction (fused_trace.py:995-1002), pixels are
// fmaf(lxv, 1/ps, (nx-1)/2) rounded half to even (fused_trace.py:1115-1124
// as XLA evaluates it). The library is built with -fmad=false so that no
// other a*b+c is contracted into an FMA the twin does not make; 1/sqrtf
// replaces rsqrtf for the same reason.
//
// What bounds it: arithmetic and the per-ray sin/exp/sqrt (plasma: also
// cos, tan, erfinv and the torus's 4 Newton steps with a sqrt and two
// divisions each; a mesh: 4 Newton steps over its nonzero Chebyshev terms,
// each an 8-byte load through the read-only cache where the TPU kernel
// unrolled them as constants), plus the image atomics; a file curve
// is two cached loads where the TPU kernel ran a tent matvec on its MXU; a plasma ray adds about
// log2(B) dependent loads of cum and one 32-byte row, served by L2; a
// mosaic crystal two erfinvf, a sqrt and a rocking curve per layer. Counts
// are reduced per warp with __ballot_sync/__popc into
// shared counters, images are block-private shared-memory histograms
// (binning.cuh), a bilinear hit four shared atomics where the TPU kernel
// contracted tent matrices on its MXU, both flushed once per block with
// global atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "binning.cuh"
#include "bundle_lookup.cuh"
#include "trace_chain.cuh"
#include "trace_common.cuh"

namespace {

// kFull: the generic source's whole sampler (xrt_sample_source), else its
// point-source cut; a plasma takes neither. kCheb: the chain's mesh stage;
// kStages: its weight and bilinear stages (1), and the mosaic's (2)
// (trace_chain.cuh).
template <bool kFull, bool kCheb, int kStages>
__global__ void fused_trace_kernel(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip,
    int n_ip, const float* __restrict__ aux, long long n_total, long long count,
    const float* __restrict__ uniforms, uint32_t seed0, uint32_t seed1,
    const int* __restrict__ cum, const float* __restrict__ table,
    int n_bundles, int n_per_iter, unsigned long long* __restrict__ counts,
    float* __restrict__ images, int img_total, int use_smem) {
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
    const bool plasma = ip[5] == XRT_SRC_PLASMA;
    const bool voxel = ip[6] != 0, cauchy = ip[7] != 0;
    const bool per_ray_wl = ip[XRT_H_PER_RAY_WL] != 0;
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * blockDim.x;

    // Whole warps step together (blockDim is a multiple of 32), so every
    // lane reaches every __ballot_sync; lanes past the end carry dead rays.
    for (long long r0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
         r0 < n_total; r0 += stride) {
        const long long r = r0 + lane;
        const bool in_range = r < n_total;
        const long long ray = in_range ? r : n_total - 1;
        Draws draw{uniforms, n_total, ray, seed0, seed1, 0, -1, {0u, 0u, 0u, 0u}};
        bool alive;
        float px, py, pz, dx, dy, dz, wl = 0.0f;
        if (plasma) {
            // ---- source: the ray's bundle, then the plasma sampler -----
            const long long j = ray / n_per_iter;
            const int local = (int)(ray - j * n_per_iter);
            const int* cum_j = cum + j * n_bundles;
            alive = in_range && local < __ldg(cum_j + n_bundles - 1);
            float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
            if (alive) {
                const int b = min(xrt_upper_bound(cum_j, n_bundles, local), n_bundles - 1);
                xrt_bundle_row(table + j * n_bundles * 8, b, &lo, &hi);
            }
            xrt_sample_plasma(fp, voxel, cauchy, draw, lo, hi, px, py, pz, dx,
                              dy, dz, wl);
        } else {
            // ---- source: origin, cone, wavelength, sightline filters ---
            bool keep;
            xrt_sample_source<kFull>(fp, ip, draw, px, py, pz, dx, dy, dz, wl,
                                     keep);
            alive = in_range && r < count && keep;
        }
        xrt_count_warp(s_counts, 0, alive, lane);
        xrt_trace_chain<kCheb, kStages>(fp, ip, aux, draw, px, py, pz, dx, dy, dz,
                                     wl, per_ray_wl, alive, 1.0f, s_counts, img,
                                     lane);
    }

    __syncthreads();
    for (int i = threadIdx.x; i <= n_opt; i += blockDim.x) {
        if (s_counts[i]) {
            atomicAdd(counts + i, (unsigned long long)s_counts[i]);
        }
    }
    if (use_smem) xrt_smem_flush(s_img, images, img_total);
}

}  // namespace

// fp/ip: packed parameters (n_fp floats, n_ip ints) on the device. Rays
// [0, n_total) are traced. A point source's rays at index >= count are dead
// at the source (a Poisson budget's realised count). A plasma's
// per-iteration tables: cum (n_total / n_per_iter, n_bundles) int32 and
// table (n_total / n_per_iter, n_bundles, 8) float32, 16-byte aligned
// (null and 0 for a point source). uniforms: (n_draws, n_total) float32 or
// null for Philox keyed by (seed0, seed1). counts: (1 + n_optics) uint64
// and images: (img_total,) float32, both zeroed by the caller. full_source:
// the generic source's whole sampler (a box, a Focused axis, the other cones,
// per-ray wavelengths or filters), else its point-source cut. aux: n_aux
// float32 of file tables and Chebyshev terms (never null); cheb: the
// chain's mesh stage; stages: 0, or 1 for its weight and bilinear stages,
// 2 with the mosaic's too. Returns cudaGetLastError() of the launch.
extern "C" int xrt_fused_trace(const float* fp, int n_fp, const int* ip,
                               int n_ip, const float* aux, int n_aux,
                               long long n_total, long long count,
                               const float* uniforms, unsigned int seed0,
                               unsigned int seed1, const int* cum,
                               const float* table, int n_bundles,
                               long long n_per_iter, unsigned long long* counts,
                               float* images, int img_total, int full_source,
                               int cheb, int stages, void* stream) {
    if (n_fp > XRT_MAX_FP || n_ip > XRT_MAX_IP || aux == nullptr || n_aux <= 0 ||
        stages < 0 || stages > 2) {
        return (int)cudaErrorInvalidValue;
    }
    if (cum != nullptr && (n_bundles <= 0 || n_per_iter <= 0 ||
                           n_per_iter >= (1LL << 31) || n_total % n_per_iter)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_total <= 0) return (int)cudaSuccess;
    const int threads = 256;
    const int use_smem = img_total <= XRT_SMEM_IMAGE_MAX_FLOATS;
    const size_t smem = use_smem ? (size_t)img_total * sizeof(float) : 0;
    using Kernel = decltype(&fused_trace_kernel<false, false, 0>);
    const Kernel kernels[12] = {
        fused_trace_kernel<false, false, 0>, fused_trace_kernel<false, false, 1>,
        fused_trace_kernel<false, false, 2>, fused_trace_kernel<false, true, 0>,
        fused_trace_kernel<false, true, 1>,  fused_trace_kernel<false, true, 2>,
        fused_trace_kernel<true, false, 0>,  fused_trace_kernel<true, false, 1>,
        fused_trace_kernel<true, false, 2>,  fused_trace_kernel<true, true, 0>,
        fused_trace_kernel<true, true, 1>,   fused_trace_kernel<true, true, 2>};
    const Kernel kernel = kernels[(full_source ? 6 : 0) + (cheb ? 3 : 0) + stages];
    cudaError_t err = xrt_set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = xrt_grid_size(kernel, threads, smem, n_total);
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        fp, n_fp, ip, n_ip, aux, n_total, count, uniforms, seed0, seed1, cum,
        table, n_bundles, (int)n_per_iter, counts, images, img_total,
        use_smem);
    return (int)cudaGetLastError();
}
