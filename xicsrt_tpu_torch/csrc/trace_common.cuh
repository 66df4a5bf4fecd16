// Device code shared by the fused trace kernel (fused_trace.cu, K1a) and
// the fused gradient kernels (fused_grad.cu, K5f/K5b): the packed buffer
// layout, the counter-based random numbers, the point-source sampler, the
// plane and sphere intersections, and the bounds and aperture logic.
//
// Every helper is the float32 operation sequence its plain PyTorch twin
// performs (xicsrt_tpu_torch/ops/fused_trace.py); the library is built with
// -fmad=false, so inlining a helper changes no rounding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Buffer layout, mirrored by ops/fused_trace.py (pack_params).
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

// The draws of one ray: an explicit (n_draws, n_total) float32 tensor, or
// Philox keyed by (seed0, seed1) with counter (ray, draw / 4), so a ray's
// draws do not depend on the launch configuration.
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

__device__ __forceinline__ float inv_sqrt(float x) { return 1.0f / sqrtf(x); }

// Point source with a cone about the emission axis (fp[0:24]): dist 0 is
// isotropic (z uniform in [cos t, 1]), 1 the symmetric isotropic_xy closed
// form. Draws u, v; writes the origin and the unit direction.
__device__ __forceinline__ void xrt_sample_source(const float* fp, int dist,
                                                  Draws& draw, float& px,
                                                  float& py, float& pz,
                                                  float& dx, float& dy,
                                                  float& dz) {
    px = fp[0];
    py = fp[1];
    pz = fp[2];
    const float u = draw();
    const float v = draw();
    float lx, ly, lz;
    if (dist == 0) {
        lz = fp[12] + u * fp[13];
        const float rho = sqrtf(fmaxf(1.0f - lz * lz, 0.0f));
        const float phi = v * 6.283185307179586f;
        lx = rho * cosf(phi);
        ly = rho * sinf(phi);
    } else {
        const float sx = sinf((fp[12] + u * fp[13]) * 0.5f) / fp[14];
        const float tx = sx * inv_sqrt(fmaxf(1.0f - sx * sx, 1e-12f));
        const float k2 = 1.0f + tx * tx;
        const float h0 = fp[15] * inv_sqrt(k2 + fp[16]);
        const float h1 = fp[17] * inv_sqrt(k2 + fp[18]);
        const float h = h0 + v * (h1 - h0);
        const float ty = sqrtf(k2) * h * inv_sqrt(fmaxf(1.0f - h * h, 1e-12f));
        const float w = inv_sqrt(1.0f + tx * tx + ty * ty);
        lx = tx * w;
        ly = ty * w;
        lz = w;
    }
    dx = lx * fp[3] + ly * fp[6] + lz * fp[9];
    dy = lx * fp[4] + ly * fp[7] + lz * fp[10];
    dz = lx * fp[5] + ly * fp[8] + lz * fp[11];
}

// Plane through (ox, oy, oz) with normal (nx, ny, nz): the distance along
// the ray, dividing by 1e-30 where the ray runs parallel. *denom gets the
// divisor used, *nonzero whether the ray was not parallel.
__device__ __forceinline__ float xrt_plane_hit(float ox, float oy, float oz,
                                               float nx, float ny, float nz,
                                               float px, float py, float pz,
                                               float dx, float dy, float dz,
                                               float* denom, bool* nonzero) {
    const float d = dx * nx + dy * ny + dz * nz;
    const float numer = (ox - px) * nx + (oy - py) * ny + (oz - pz) * nz;
    *nonzero = fabsf(d) > 1e-30f;
    *denom = *nonzero ? d : 1e-30f;
    return numer / *denom;
}

// Sphere of center C and squared radius r2: the far root (concave) or the
// near root (convex). floor_ clamps r2 - d2 under the square root. Writes
// L = C - p, t_ca, t_hc and d2; the ray hits where d2 <= r2.
struct SphereHit {
    float Lx, Ly, Lz, t_ca, d2, t_hc, t;
};

__device__ __forceinline__ SphereHit xrt_sphere_hit(
    float Cx, float Cy, float Cz, float r2, float floor_, bool convex,
    float px, float py, float pz, float dx, float dy, float dz) {
    SphereHit h;
    h.Lx = Cx - px;
    h.Ly = Cy - py;
    h.Lz = Cz - pz;
    h.t_ca = h.Lx * dx + h.Ly * dy + h.Lz * dz;
    h.d2 = h.Lx * h.Lx + h.Ly * h.Ly + h.Lz * h.Lz - h.t_ca * h.t_ca;
    h.t_hc = sqrtf(fmaxf(r2 - h.d2, floor_));
    h.t = convex ? h.t_ca - h.t_hc : h.t_ca + h.t_hc;
    return h;
}

// x/y/z bounds (checks: bit 0 x, 1 y, 2 z; half: the half sizes) of a hit
// with local coordinates (lxv, lyv) and offset r from the optic origin;
// bz is the optic's z axis.
__device__ __forceinline__ bool xrt_bounds(bool mask, int checks,
                                           const float* half, float lxv,
                                           float lyv, float rx, float ry,
                                           float rz, float bzx, float bzy,
                                           float bzz) {
    if (checks & 1) mask = mask && fabsf(lxv) < half[0];
    if (checks & 2) mask = mask && fabsf(lyv) < half[1];
    if (checks & 4) {
        const float lzv = rx * bzx + ry * bzy + rz * bzz;
        mask = mask && fabsf(lzv) < half[2];
    }
    return mask;
}

// Aperture logic (ops/aperture.py) over apertures [first, first + count)
// of the packed aperture block: m_in is the bounds mask, m_out the running
// value; updates apply only inside m_in. Returns m_out && m_in.
__device__ __forceinline__ bool xrt_apertures(const float* apf,
                                              const int* api, int first,
                                              int count, float lxv, float lyv,
                                              bool m_in) {
    bool m_out = m_in;
    for (int a = first; a < first + count; ++a) {
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
    return m_out && m_in;
}
