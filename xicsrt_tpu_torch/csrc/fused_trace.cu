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
// (pack_params) and mirrored by the offsets below.
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

#define XRT_MAX_OPTICS 16
#define XRT_MAX_APERTURES 64
#define XRT_SRC_F 24
#define XRT_OPT_F 32
#define XRT_AP_F 4
#define XRT_HDR_I 8
#define XRT_OPT_I 16
#define XRT_AP_I 2
#define XRT_MAX_FP \
    (XRT_SRC_F + XRT_MAX_OPTICS * XRT_OPT_F + XRT_MAX_APERTURES * XRT_AP_F)
#define XRT_MAX_IP \
    (XRT_HDR_I + XRT_MAX_OPTICS * XRT_OPT_I + XRT_MAX_APERTURES * XRT_AP_I)

namespace {

// Philox4x32-10 (Salmon et al., SC'11).
__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t out[4]) {
    for (int i = 0; i < 10; ++i) {
        if (i > 0) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t lo0 = 0xD2511F53u * c0;
        const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
        const uint32_t lo1 = 0xCD9E8D57u * c2;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
        c0 = hi1 ^ c1 ^ k0;
        c1 = lo1;
        c2 = hi0 ^ c3 ^ k1;
        c3 = lo0;
    }
    out[0] = c0;
    out[1] = c1;
    out[2] = c2;
    out[3] = c3;
}

struct Draws {
    const float* uniforms;  // (n_draws, n_total), or null for Philox
    long long n_total;
    long long ray;
    uint32_t k0, k1;
    int next, group;
    uint32_t words[4];

    // Uniform in [0, 1): 24 random bits, as the TPU hardware PRNG gives.
    __device__ __forceinline__ float operator()() {
        const int k = next++;
        if (uniforms) return uniforms[(long long)k * n_total + ray];
        if ((k >> 2) != group) {
            group = k >> 2;
            philox4x32_10((uint32_t)ray, (uint32_t)(ray >> 32),
                          (uint32_t)group, 0u, k0, k1, words);
        }
        return (float)(words[k & 3] >> 8) * (1.0f / 16777216.0f);
    }
};

__device__ __forceinline__ void count_warp(unsigned int* s_counts, int elem,
                                           bool alive, int lane) {
    const unsigned int b = __ballot_sync(0xffffffffu, alive);
    if (lane == 0 && b) atomicAdd(s_counts + elem, (unsigned int)__popc(b));
}

__device__ __forceinline__ float inv_sqrt(float x) { return 1.0f / sqrtf(x); }

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
        float px = fp[0], py = fp[1], pz = fp[2];
        const float u = draw();
        const float v = draw();
        float lx, ly, lz;
        if (dist == 0) {  // isotropic: z uniform in [cos t, 1]
            lz = fp[12] + u * fp[13];
            const float rho = sqrtf(fmaxf(1.0f - lz * lz, 0.0f));
            const float phi = v * 6.283185307179586f;
            lx = rho * cosf(phi);
            ly = rho * sinf(phi);
        } else {  // isotropic_xy, symmetric y: closed-form inverse CDF
            const float sx = sinf((fp[12] + u * fp[13]) * 0.5f) / fp[14];
            const float tx = sx * inv_sqrt(fmaxf(1.0f - sx * sx, 1e-12f));
            const float k2 = 1.0f + tx * tx;
            const float h0 = fp[15] * inv_sqrt(k2 + fp[16]);
            const float h1 = fp[17] * inv_sqrt(k2 + fp[18]);
            const float h = h0 + v * (h1 - h0);
            const float ty =
                sqrtf(k2) * h * inv_sqrt(fmaxf(1.0f - h * h, 1e-12f));
            const float w = inv_sqrt(1.0f + tx * tx + ty * ty);
            lx = tx * w;
            ly = ty * w;
            lz = w;
        }
        float dx = lx * fp[3] + ly * fp[6] + lz * fp[9];
        float dy = lx * fp[4] + ly * fp[7] + lz * fp[10];
        float dz = lx * fp[5] + ly * fp[8] + lz * fp[11];

        // ---- optic chain ----------------------------------------------
        for (int e = 0; e < n_opt; ++e) {
            const float* o = fp + XRT_SRC_F + e * XRT_OPT_F;
            const int* oi = ip + XRT_HDR_I + e * XRT_OPT_I;
            float t, nxv, nyv, nzv;
            bool m_int;
            if (oi[0] == 0) {  // plane through o[0:3], normal bz
                const float denom = dx * o[9] + dy * o[10] + dz * o[11];
                const float numer = (o[0] - px) * o[9] + (o[1] - py) * o[10] +
                                    (o[2] - pz) * o[11];
                const bool nz = fabsf(denom) > 1e-30f;
                t = numer / (nz ? denom : 1e-30f);
                m_int = alive && t >= 0.0f && nz;
                nxv = o[9];
                nyv = o[10];
                nzv = o[11];
            } else {  // sphere of center o[12:15], radius^2 o[15]
                const float Lx = o[12] - px, Ly = o[13] - py, Lz = o[14] - pz;
                const float t_ca = Lx * dx + Ly * dy + Lz * dz;
                const float d2 = Lx * Lx + Ly * Ly + Lz * Lz - t_ca * t_ca;
                m_int = alive && d2 <= o[15];
                const float t_hc = sqrtf(fmaxf(o[15] - d2, 0.0f));
                t = oi[1] ? t_ca - t_hc : t_ca + t_hc;
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

            bool mask = m_int;
            const int checks = oi[4];
            if (checks & 1) mask = mask && fabsf(lxv) < o[16];
            if (checks & 2) mask = mask && fabsf(lyv) < o[17];
            if (checks & 4) {
                const float lzv = rx * o[9] + ry * o[10] + rz * o[11];
                mask = mask && fabsf(lzv) < o[18];
            }
            // Aperture logic (ops/aperture.py): m_in is the bounds mask,
            // m_out the running value; updates apply only inside m_in.
            const bool m_in = mask;
            bool m_out = m_in;
            for (int a = oi[6]; a < oi[6] + oi[5]; ++a) {
                const float ax = lxv - apf[a * XRT_AP_F];
                const float ay = lyv - apf[a * XRT_AP_F + 1];
                const float p0 = apf[a * XRT_AP_F + 2];
                const float p1 = apf[a * XRT_AP_F + 3];
                bool test;
                switch (api[a * XRT_AP_I]) {
                    case 0: test = true; break;
                    case 1: test = ax * ax + ay * ay < p0; break;
                    case 2: test = fabsf(ax) < p0 && fabsf(ay) < p0; break;
                    case 3: test = fabsf(ax) < p0 && fabsf(ay) < p1; break;
                    default: {
                        const float ex = ax / p0, ey = ay / p1;
                        test = ex * ex + ey * ey < 1.0f;
                    }
                }
                test = test && m_in;
                bool nv;
                switch (api[a * XRT_AP_I + 1]) {
                    case 0: nv = m_out && test; break;
                    case 1: nv = m_out && !test; break;
                    case 2: nv = m_out || test; break;
                    case 3: nv = !(m_out && test); break;
                    case 4: nv = !(m_out || test); break;
                    case 5: nv = m_out != test; break;
                    default: nv = m_out == test;
                }
                m_out = m_in ? nv : m_out;
            }
            mask = m_out && m_in;

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
