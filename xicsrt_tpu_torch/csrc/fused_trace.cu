// Fused generate -> trace -> count -> image kernel for NVIDIA Hopper
// (sm_90a): the main spectrometer chain.
//
// Replaces the main-chain cut of the TPU megakernel
// xicsrt_tpu/ops/fused_trace.py::build_fused_run (kernel, and the shared
// optic chain _trace_chain). One thread carries one ray in registers from
// the source through every optic; no per-ray state touches device memory.
//
// The subset: a point source with an isotropic or symmetric isotropic_xy
// cone and one wavelength; plane or sphere optics with x/y/z bounds and
// aperture logic (none/circle/square/rectangle/ellipse; and, not, or, nand,
// nor, xor, xnor); no interaction or a Bragg crystal with a gaussian or
// step rocking curve and Bernoulli (mc) acceptance; per-element counts;
// nearest-pixel images.
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
// ray: source u, v, then one uniform per crystal.
//
// Numerics follow the TPU kernel and the plain PyTorch twin operation by
// operation: the Bragg deviation is the sine-difference identity with a
// cubic asin correction (fused_trace.py:995-1002), pixels are
// fmaf(lxv, 1/ps, (nx-1)/2) rounded half to even (fused_trace.py:1115-1124
// as XLA evaluates it). The library is built with -fmad=false so that no
// other a*b+c is contracted into an FMA the twin does not make; 1/sqrtf
// replaces rsqrtf for the same reason.
//
// What bounds it: arithmetic and the per-ray sin/exp/sqrt, plus the image
// atomics. Counts are reduced per warp with __ballot_sync/__popc into
// shared counters, images are block-private shared-memory histograms
// (binning.cuh), both flushed once per block with global atomics.
#include <cuda_runtime.h>
#include <stdint.h>

#include "binning.cuh"
#include "trace_common.cuh"

namespace {

__device__ __forceinline__ void count_warp(unsigned int* s_counts, int elem,
                                           bool alive, int lane) {
    const unsigned int b = __ballot_sync(0xffffffffu, alive);
    if (lane == 0 && b) atomicAdd(s_counts + elem, (unsigned int)__popc(b));
}

__global__ void fused_trace_kernel(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip,
    int n_ip, long long n_total, long long count,
    const float* __restrict__ uniforms, uint32_t seed0, uint32_t seed1,
    unsigned long long* __restrict__ counts, float* __restrict__ images,
    int img_total, int use_smem) {
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
    const int dist = ip[2];
    const float* apf = fp + XRT_SRC_F + n_opt * XRT_OPT_F;
    const int* api = ip + XRT_HDR_I + n_opt * XRT_OPT_I;
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * blockDim.x;

    // Whole warps step together (blockDim is a multiple of 32), so every
    // lane reaches every __ballot_sync; lanes past the end carry dead rays.
    for (long long r0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
         r0 < n_total; r0 += stride) {
        const long long r = r0 + lane;
        const bool in_range = r < n_total;
        Draws draw{uniforms, n_total, in_range ? r : n_total - 1,
                   seed0, seed1, 0, -1, {0u, 0u, 0u, 0u}};
        bool alive = in_range && r < count;
        count_warp(s_counts, 0, alive, lane);

        // ---- source: point origin, cone about the emission axis -------
        float px, py, pz, dx, dy, dz;
        xrt_sample_source(fp, dist, draw, px, py, pz, dx, dy, dz);

        // ---- optic chain ----------------------------------------------
        for (int e = 0; e < n_opt; ++e) {
            const float* o = fp + XRT_SRC_F + e * XRT_OPT_F;
            const int* oi = ip + XRT_HDR_I + e * XRT_OPT_I;
            float t, nxv, nyv, nzv;
            bool m_int;
            if (oi[0] == 0) {  // plane through o[0:3], normal bz
                float denom;
                bool nz;
                t = xrt_plane_hit(o[0], o[1], o[2], o[9], o[10], o[11], px, py,
                                  pz, dx, dy, dz, &denom, &nz);
                m_int = alive && t >= 0.0f && nz;
                nxv = o[9];
                nyv = o[10];
                nzv = o[11];
            } else {  // sphere of center o[12:15], radius^2 o[15]
                const SphereHit h = xrt_sphere_hit(o[12], o[13], o[14], o[15],
                                                   0.0f, oi[1] != 0, px, py,
                                                   pz, dx, dy, dz);
                m_int = alive && h.d2 <= o[15];
                t = h.t;
                nxv = nyv = nzv = 0.0f;
            }
            const float qx = m_int ? px + t * dx : px;
            const float qy = m_int ? py + t * dy : py;
            const float qz = m_int ? pz + t * dz : pz;
            if (oi[0] != 0) {  // sphere normal points to the center
                nxv = o[12] - qx;
                nyv = o[13] - qy;
                nzv = o[14] - qz;
                const float inv =
                    inv_sqrt(fmaxf(nxv * nxv + nyv * nyv + nzv * nzv, 1e-30f));
                nxv = nxv * inv;
                nyv = nyv * inv;
                nzv = nzv * inv;
            }
            const float rx = qx - o[0], ry = qy - o[1], rz = qz - o[2];
            const float lxv = rx * o[3] + ry * o[4] + rz * o[5];
            const float lyv = rx * o[6] + ry * o[7] + rz * o[8];

            const bool m_in = xrt_bounds(m_int, oi[4], o + 16, lxv, lyv, rx,
                                         ry, rz, o[9], o[10], o[11]);
            bool mask = xrt_apertures(apf, api, oi[6], oi[5], lxv, lyv, m_in);

            if (oi[2] == 1) {  // Bragg crystal, mc acceptance
                const float dot = dx * nxv + dy * nyv + dz * nzv;
                const float adot = fabsf(dot);
                const float cosi = sqrtf(fmaxf(1.0f - adot * adot, 0.0f));
                const float sd = adot * o[22] - cosi * o[21];
                const float delta = sd + sd * sd * sd * (1.0f / 6.0f);
                float prob;
                if (oi[3] == 0) {  // gaussian, o[20] = sigma
                    const float z = delta / o[20];
                    prob = o[19] * expf(-0.5f * (z * z));
                } else {  // step, o[20] = fwhm / 2
                    prob = fabsf(delta) <= o[20] ? o[19] : 0.0f;
                }
                const float uacc = draw();
                mask = mask && prob >= uacc;
                if (mask) {
                    const float kk = 2.0f * dot;
                    dx = dx - kk * nxv;
                    dy = dy - kk * nyv;
                    dz = dz - kk * nzv;
                }
            }
            px = qx;
            py = qy;
            pz = qz;
            alive = mask;
            count_warp(s_counts, 1 + e, alive, lane);

            if (oi[7] >= 0 && alive) {
                const float fx = fmaf(lxv, o[23], o[24]);
                const float fy = fmaf(lyv, o[23], o[25]);
                int flat;
                if (xrt_nearest_pixel(fx, fy, oi[8], oi[9], &flat)) {
                    atomicAdd(img + oi[7] + flat, 1.0f);
                }
            }
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

}  // namespace

// fp/ip: packed parameters (n_fp floats, n_ip ints) on the device. Rays
// [0, n_total) are traced; rays at index >= count are dead at the source
// (a Poisson budget's realised count). uniforms: (n_draws, n_total) float32
// or null for Philox keyed by (seed0, seed1). counts: (1 + n_optics) uint64
// and images: (img_total,) float32, both zeroed by the caller. Returns
// cudaGetLastError() of the launch.
extern "C" int xrt_fused_trace(const float* fp, int n_fp, const int* ip,
                               int n_ip, long long n_total, long long count,
                               const float* uniforms, unsigned int seed0,
                               unsigned int seed1, unsigned long long* counts,
                               float* images, int img_total, void* stream) {
    if (n_fp > XRT_MAX_FP || n_ip > XRT_MAX_IP) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_total <= 0) return (int)cudaSuccess;
    const int threads = 256;
    const int use_smem = img_total <= XRT_SMEM_IMAGE_MAX_FLOATS;
    const size_t smem = use_smem ? (size_t)img_total * sizeof(float) : 0;
    cudaError_t err = xrt_set_smem(fused_trace_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = xrt_grid_size(fused_trace_kernel, threads, smem, n_total);
    fused_trace_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        fp, n_fp, ip, n_ip, n_total, count, uniforms, seed0, seed1, counts,
        images, img_total, use_smem);
    return (int)cudaGetLastError();
}
