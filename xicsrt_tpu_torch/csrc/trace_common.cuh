// Device code shared by the fused trace kernels (fused_trace.cu, K1;
// trace_only.cu, K3) and the fused gradient kernels (fused_grad.cu,
// K5f/K5b): the packed buffer layout, the counter-based random numbers, the
// generic source sampler with its sightline filters, the plasma cone and
// line, the plane, sphere, cylinder and torus intersections, and the bounds
// and aperture logic.
//
// Every helper is the float32 operation sequence its plain PyTorch twin
// performs (xicsrt_tpu_torch/ops/fused_trace.py); the library is built with
// -fmad=false, so inlining a helper changes no rounding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Buffer layout, mirrored by ops/fused_trace.py (pack_params): the source
// block, one block per optic, one per aperture, one per source filter.
// K1, K1e and K3 take chains of up to XRT_MAX_OPTICS optics (JAX's K1 takes
// 127, xicsrt_tpu/ops/fused_trace.py:1296-1298), K5 up to
// XRT_GRAD_MAX_OPTICS (fused_grad.cu). Apertures and source filters have no
// count limit: every kernel copies the buffers, sized by the run, into the
// head of its dynamic shared memory (xrt_head_floats), and a launcher
// refuses a head that does not fit the shared memory of a block.
#define XRT_MAX_OPTICS 127
#define XRT_SRC_F 64
#define XRT_OPT_F 32
#define XRT_AP_F 4
#define XRT_FILT_F 8
#define XRT_HDR_I 18
#define XRT_OPT_I 16
#define XRT_AP_I 2
// Header ints 0-7: n_optics, n_apertures, cone kind, n_draws, image floats,
// source kind, voxel draws, Cauchy draw. Source kinds: 0 a generic source,
// 1 a plasma of bundle tables (K1), 2 a plasma of one bundle per ray (K5),
// 3 rays read from device memory (K3).
#define XRT_SRC_PLASMA 1
#define XRT_SRC_PLASMA_RAY 2
#define XRT_SRC_RAYS 3
// Header ints 8-15: source filters; the box (0 point, 1 uniform, 2
// gaussian); a per-ray axis to a target (Focused); the wavelength (0 one
// line, 1 uniform band, 2 exact Voigt) with its Gauss and Cauchy parts; a
// bulk velocity; wavelengths per ray (the crystals take per-ray Bragg
// angles).
#define XRT_H_FILTERS 8
#define XRT_H_SPATIAL 9
#define XRT_H_FOCUSED 10
#define XRT_H_WAVE 11
#define XRT_H_GAUSS 12
#define XRT_H_CAUCHY 13
#define XRT_H_VELOCITY 14
#define XRT_H_PER_RAY_WL 15
// Header ints 16-17: the run's modes. Weight mode: each ray carries a
// weight, a crystal multiplies it by its probability and draws nothing, the
// images add it; bilinear images: each hit splats onto four pixels.
#define XRT_H_WEIGHT 16
#define XRT_H_BILINEAR 17
// Cone kinds (header int 2).
#define XRT_CONE_ISOTROPIC 0
#define XRT_CONE_XY 1
#define XRT_CONE_XY_ASYM 2
#define XRT_CONE_FLAT 3
#define XRT_CONE_FLAT_XY 4
#define XRT_CONE_GAUSSIAN 5
// Generic source floats: origin 0:3, rotation rows (o2, o1, axis) 3:12, the
// cone's constants 12:24, then these.
#define XRT_S_CONE 12
#define XRT_S_BASIS 24
#define XRT_S_SIZES 33
#define XRT_S_TARGET 36
#define XRT_S_HINT 39
#define XRT_S_WAVE 42
#define XRT_S_VELOCITY 45
#define XRT_S_CINV 48
// Optic floats beyond the sphere's: torus r_minor^2 and convergence
// tolerance, and 1 / (2 d) for per-ray Bragg angles.
#define XRT_O_RMIN2 26
#define XRT_O_TOL 27
#define XRT_O_INV2D 28
// Torus floats read by the gradient kernels: major_adjust and center_sign,
// the convex pair folded (optics/shapes.py ShapeTorus).
#define XRT_O_MADJ 29
#define XRT_O_CSIGN 30
// A file rocking curve: the table's first deviation (in the rocking width's
// float) and 1 / grid step; the table's offset in the aux buffer and its
// length K in the optic's ints. A Chebyshev surface (shape 4): centre and
// scales in floats 12-15, mid-plane and tolerance in XRT_O_RMIN2 and
// XRT_O_TOL; in the optic's ints its nonzero terms' aux offset (even),
// degree (at most XRT_CHEB_MAX_DEG) and term count, and the aux offset
// (a multiple of 4) of its dense coefficients, which the kernels sum.
#define XRT_O_LO 20
#define XRT_O_INV_STEP 31
#define XRT_OI_TABLE 10
#define XRT_OI_K 11
#define XRT_OI_CHEB 12
#define XRT_OI_DEG 13
#define XRT_OI_TERMS 14
#define XRT_OI_DENSE 1
#define XRT_CHEB_MAX_DEG 12
#define XRT_SHAPE_CHEB 4
#define XRT_ROCK_FILE 2
// A mosaic crystal (interact code 3): its crystallite sigma and cutoff
// angle (negative without a cutoff) in the torus's floats, which no mosaic
// composite uses, and its depth in the optic's int 15.
#define XRT_INTERACT_MOSAIC 3
#define XRT_O_MSIGMA 29
#define XRT_O_MCUT 30
#define XRT_OI_DEPTH 15

// The head of the trace kernels' dynamic shared memory (K1, K1e's probe
// and record, K3): XRT_HEAD_COUNTS per-element counters (K1's and K3's, as
// many as a chain of XRT_MAX_OPTICS may have: pack_params refuses a longer
// one, so ip[0] <= XRT_MAX_OPTICS), ip (n_ip ints) at a fixed
// offset, then fp (n_fp floats), each rounded up to 16 bytes; what a
// launch stages (images, K1's window) follows it. ip's fixed offset keeps
// the flat build within its 48 registers: with ip behind fp, or the
// counters behind both, it spilled 12 bytes (PERF.md). fp's offset
// is a multiple of 16 bytes the compiler can see (xrt_round4), so it loads
// an optic's floats 16 bytes at a time as from the static arrays: at a
// run-time offset it cannot align, K1a's build issued 95 shared loads
// where it had 57, and ran 4 % slower. The flagship's head is 1472 bytes;
// at 127 optics and no aperture, 25.7 KB.
#define XRT_HEAD_COUNTS (XRT_MAX_OPTICS + 1)
__host__ __device__ inline int xrt_round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int xrt_head_floats(int n_fp, int n_ip) {
    return XRT_HEAD_COUNTS + xrt_round4(n_ip) + xrt_round4(n_fp);
}

// fp and ip copied from device memory into a head, and n_words counters
// zeroed (no __syncthreads).
__device__ __forceinline__ void xrt_head_load(float* fp, const float* __restrict__ g_fp,
                                              int n_fp, int* ip,
                                              const int* __restrict__ g_ip, int n_ip,
                                              unsigned int* words, int n_words) {
    for (int i = threadIdx.x; i < n_fp; i += blockDim.x) fp[i] = g_fp[i];
    for (int i = threadIdx.x; i < n_ip; i += blockDim.x) ip[i] = g_ip[i];
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) words[i] = 0u;
}

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
    // The word is selected with constant indices: indexed by the run-time
    // k & 3, words would live in local memory.
    __device__ __forceinline__ float operator()() {
        const int k = next++;
        if (uniforms) return uniforms[(long long)k * n_total + ray];
        if ((k >> 2) != group) {
            group = k >> 2;
            philox4x32_10((uint32_t)ray, (uint32_t)(ray >> 32),
                          (uint32_t)group, 0u, k0, k1, words);
        }
        const uint32_t lo = (k & 1) ? words[1] : words[0];
        const uint32_t hi = (k & 1) ? words[3] : words[2];
        return (float)(((k & 2) ? hi : lo) >> 8) * (1.0f / 16777216.0f);
    }
};

// A plasma source's draws (at most seven, draws 0-6: groups 0 and 1) with
// both of their Philox calls issued at once, before the bundle search's
// loads and the sampler's math: the calls are independent, so their rounds
// interleave and share the key schedule, where Draws would make the second
// at draw 4, behind the sampler's dependent arithmetic. two: the launch's
// draws pass four (the header's draw count, the same for every ray), so a
// ray makes no call it would not make anyway. The words are selected with
// constant indices (k < 8). finish() leaves in d the group the chain's
// next draw falls in, so the chain's draws (Draws) go on from there as
// they would have. The generic sampler takes Draws: with both calls up
// front, K1b ran 2-3 % slower (its build 76 registers, not 71).
struct DrawsAhead {
    Draws& d;
    bool two;
    uint32_t ahead[4];

    __device__ __forceinline__ DrawsAhead(Draws& draws, bool two_groups)
        : d(draws), two(two_groups && draws.uniforms == nullptr) {
        if (!two) return;
        d.group = 0;
        philox4x32_10((uint32_t)d.ray, (uint32_t)(d.ray >> 32), 0u, 0u, d.k0, d.k1,
                      d.words);
        philox4x32_10((uint32_t)d.ray, (uint32_t)(d.ray >> 32), 1u, 0u, d.k0, d.k1,
                      ahead);
    }

    __device__ __forceinline__ float operator()() {
        if (!two) return d();
        const int k = d.next++;
        const uint32_t w0 = (k & 4) ? ahead[0] : d.words[0];
        const uint32_t w1 = (k & 4) ? ahead[1] : d.words[1];
        const uint32_t w2 = (k & 4) ? ahead[2] : d.words[2];
        const uint32_t w3 = (k & 4) ? ahead[3] : d.words[3];
        const uint32_t lo = (k & 1) ? w1 : w0;
        const uint32_t hi = (k & 1) ? w3 : w2;
        return (float)(((k & 2) ? hi : lo) >> 8) * (1.0f / 16777216.0f);
    }

    __device__ __forceinline__ void finish() {
        if (!two || (d.next >> 2) != 1) return;
        d.group = 1;
        d.words[0] = ahead[0];
        d.words[1] = ahead[1];
        d.words[2] = ahead[2];
        d.words[3] = ahead[3];
    }
};

__device__ __forceinline__ float inv_sqrt(float x) { return 1.0f / sqrtf(x); }

// sinf(x) and cosf(x) of one angle, with one range reduction: sincosf
// rounds each as sinf and cosf do (the kernels and their twins agree ray
// for ray on the card, chip_smoke.py).
__device__ __forceinline__ void xrt_sincos(float x, float& s, float& c) {
    sincosf(x, &s, &c);
}

// A standard normal from one uniform clipped to [1e-7, 1 - 1e-7]:
// sqrt(2) erfinv(2u - 1).
template <class D>
__device__ __forceinline__ float xrt_normal(D& draw) {
    const float lo = (float)1e-7, hi = (float)(1.0 - 1e-7);
    const float un = fminf(fmaxf(draw(), lo), hi);
    return 1.4142135623730951f * erfinvf(2.0f * un - 1.0f);
}

// The natural (Cauchy) part of an exact Voigt line of width gamma.
template <class D>
__device__ __forceinline__ float xrt_cauchy(D& draw, float gamma) {
    const float lo = (float)1e-7, hi = (float)(1.0 - 1e-7);
    const float uc = fminf(fmaxf(draw(), lo), hi);
    return gamma * tanf(3.141592653589793f * (uc - 0.5f));
}

// arcsin as the TPU megakernel takes it: pi/2 - acos_kernel(x), the
// Abramowitz-Stegun 4.4.45 polynomial for acos with one Newton step on
// cos(theta) = |x| (xicsrt_tpu/ops/polynomials.py:53-68), error ~1e-7.
__device__ __forceinline__ float xrt_asin_poly(float x) {
    x = fminf(fmaxf(x, -1.0f), 1.0f);
    const float ax = fminf(fmaxf(fabsf(x), 0.0f), 1.0f);
    float p = -0.0012624911f;
    p = p * ax + 0.0066700901f;
    p = p * ax + -0.0170881256f;
    p = p * ax + 0.0308918810f;
    p = p * ax + -0.0501743046f;
    p = p * ax + 0.0889789874f;
    p = p * ax + -0.2145988016f;
    p = p * ax + 1.5707963050f;
    float theta = p * sqrtf(fmaxf(1.0f - ax, 0.0f));
    float s, c;
    xrt_sincos(theta, s, c);
    theta = theta + (c - ax) / fmaxf(s, 1e-6f);
    const float acos_x = x >= 0.0f ? theta : 3.141592653589793f - theta;
    return 1.5707963267948966f - acos_x;
}

// The conditional in ty of isotropic_xy and the unit vector (tx, ty, 1) / |.|
// from sx = sin(alpha) and the uniform v; c: tan(ty0), its square,
// tan(ty1), its square.
__device__ __forceinline__ void xrt_xy_tail(float sx, float v, const float* c,
                                            float& lx, float& ly, float& lz) {
    const float tx = sx * inv_sqrt(fmaxf(1.0f - sx * sx, 1e-12f));
    const float k2 = 1.0f + tx * tx;
    const float h0 = c[0] * inv_sqrt(k2 + c[1]);
    const float h1 = c[2] * inv_sqrt(k2 + c[3]);
    const float h = h0 + v * (h1 - h0);
    const float ty = sqrtf(k2) * h * inv_sqrt(fmaxf(1.0f - h * h, 1e-12f));
    const float w = inv_sqrt(1.0f + tx * tx + ty * ty);
    lx = tx * w;
    ly = ty * w;
    lz = w;
}

// (dx, dy, dz): the local direction (lx, ly, lz) in the per-ray basis of
// vec.orthogonal_basis about the unit vector from p to the target t, with
// the basis hint h (rows o2, o1, n; JAX fused_trace.py:1649-1673).
__device__ __forceinline__ void xrt_aim(const float* t, const float* h,
                                        float px, float py, float pz,
                                        float lx, float ly, float lz,
                                        float& dx, float& dy, float& dz) {
    float nx = t[0] - px, ny = t[1] - py, nz = t[2] - pz;
    float inv = inv_sqrt(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
    nx = nx * inv;
    ny = ny * inv;
    nz = nz * inv;
    float o1x = ny * h[2] - nz * h[1];
    float o1y = nz * h[0] - nx * h[2];
    float o1z = nx * h[1] - ny * h[0];
    inv = inv_sqrt(fmaxf(o1x * o1x + o1y * o1y + o1z * o1z, 1e-30f));
    o1x = o1x * inv;
    o1y = o1y * inv;
    o1z = o1z * inv;
    const float o2x = ny * o1z - nz * o1y;
    const float o2y = nz * o1x - nx * o1z;
    const float o2z = nx * o1y - ny * o1x;
    dx = lx * o2x + ly * o1x + lz * nx;
    dy = lx * o2y + ly * o1y + lz * ny;
    dz = lx * o2z + ly * o1z + lz * nz;
}

// The generic source (JAX fused_trace.py:1538-1713): the origin, the unit
// direction, the wavelength and whether the source's filters keep the ray.
// kFull = false compiles the point source with an isotropic or symmetric
// isotropic_xy cone, a constant rotation and one wavelength, and nothing
// else; kFull = true the whole matrix: uniform or gaussian boxes (one draw
// per nonzero size), every cone kind, the Focused per-ray basis, uniform
// and exact Voigt wavelengths, the bulk Doppler shift and the sightline
// filters on the origin. Draw order: box, cone (2), wavelength (0-2).
template <bool kFull>
__device__ __forceinline__ void xrt_sample_source(const float* fp, const int* ip,
                                                  Draws& draw, float& px,
                                                  float& py, float& pz,
                                                  float& dx, float& dy,
                                                  float& dz, float& wl,
                                                  bool& keep) {
    px = fp[0];
    py = fp[1];
    pz = fp[2];
    wl = fp[XRT_S_WAVE];
    keep = true;
    if (kFull && ip[XRT_H_SPATIAL] != 0) {
        const bool gaussian = ip[XRT_H_SPATIAL] == 2;
        for (int k = 0; k < 3; ++k) {
            const float s = fp[XRT_S_SIZES + k];
            if (s == 0.0f) continue;
            const float o_l = gaussian ? xrt_normal(draw) * s : (draw() - 0.5f) * s;
            px = px + o_l * fp[XRT_S_BASIS + 3 * k];
            py = py + o_l * fp[XRT_S_BASIS + 3 * k + 1];
            pz = pz + o_l * fp[XRT_S_BASIS + 3 * k + 2];
        }
    }
    const float* c = fp + XRT_S_CONE;
    const int dist = ip[2];
    float lx, ly, lz;
    if (dist == XRT_CONE_ISOTROPIC) {
        const float u = draw();
        const float v = draw();
        lz = c[0] + u * c[1];
        const float rho = sqrtf(fmaxf(1.0f - lz * lz, 0.0f));
        const float phi = v * 6.283185307179586f;
        float sp, cp;
        xrt_sincos(phi, sp, cp);
        lx = rho * cp;
        ly = rho * sp;
    } else if (!kFull || dist == XRT_CONE_XY) {
        // c: g0, g1 - g0, sin(ty1), then the tail's four.
        const float u = draw();
        const float v = draw();
        const float sx = sinf((c[0] + u * c[1]) * 0.5f) / c[2];
        xrt_xy_tail(sx, v, c + 3, lx, ly, lz);
    } else if (dist == XRT_CONE_XY_ASYM) {
        // c: sx0, sx1 - sx0, sin(ty0), sin(ty1), g0, g1 - g0, the tail's
        // four, sx1. Bracket-clamped Newton on the marginal CDF.
        const float u = draw();
        const float v = draw();
        const float target = c[4] + u * c[5];
        float sx = c[0] + u * c[1];
        for (int it = 0; it < 12; ++it) {
            const float a1 = sx * c[3], a0 = sx * c[2];
            const float gm = xrt_asin_poly(a1) - xrt_asin_poly(a0);
            const float dg = c[3] * inv_sqrt(fmaxf(1.0f - a1 * a1, 1e-12f)) -
                             c[2] * inv_sqrt(fmaxf(1.0f - a0 * a0, 1e-12f));
            sx = fminf(fmaxf(sx - (gm - target) / fmaxf(dg, 1e-12f), c[0]), c[10]);
        }
        xrt_xy_tail(sx, v, c + 6, lx, ly, lz);
    } else if (dist == XRT_CONE_FLAT) {  // c: tan(spread)
        const float r = c[0] * sqrtf(draw());
        const float phi = draw() * 6.283185307179586f;
        const float w = inv_sqrt(1.0f + r * r);
        float sp, cp;
        xrt_sincos(phi, sp, cp);
        lx = cp * r * w;
        ly = sp * r * w;
        lz = w;
    } else if (dist == XRT_CONE_FLAT_XY) {  // c: t0, t1 - t0, t2, t3 - t2
        const float x = c[0] + draw() * c[1];
        const float y = c[2] + draw() * c[3];
        const float w = inv_sqrt(1.0f + x * x + y * y);
        lx = x * w;
        ly = y * w;
        lz = w;
    } else {  // flat gaussian, c: sigma
        const float x = c[0] * xrt_normal(draw);
        const float y = c[0] * xrt_normal(draw);
        const float w = inv_sqrt(1.0f + x * x + y * y);
        lx = x * w;
        ly = y * w;
        lz = w;
    }
    if (kFull && ip[XRT_H_FOCUSED]) {
        xrt_aim(fp + XRT_S_TARGET, fp + XRT_S_HINT, px, py, pz, lx, ly, lz, dx,
                dy, dz);
    } else {
        dx = lx * fp[3] + ly * fp[6] + lz * fp[9];
        dy = lx * fp[4] + ly * fp[7] + lz * fp[10];
        dz = lx * fp[5] + ly * fp[8] + lz * fp[11];
    }
    if (!kFull) return;
    const int wave = ip[XRT_H_WAVE];
    if (wave == 1) {  // lower edge, width
        wl = fp[XRT_S_WAVE] + draw() * fp[XRT_S_WAVE + 1];
    } else if (wave == 2) {  // centre, Doppler sigma, natural gamma
        if (ip[XRT_H_GAUSS]) wl = wl + fp[XRT_S_WAVE + 1] * xrt_normal(draw);
        if (ip[XRT_H_CAUCHY]) wl = wl + xrt_cauchy(draw, fp[XRT_S_WAVE + 2]);
    }
    if (ip[XRT_H_VELOCITY]) {
        const float* vel = fp + XRT_S_VELOCITY;
        wl = wl * (1.0f - (vel[0] * dx + vel[1] * dy + vel[2] * dz) * fp[XRT_S_CINV]);
    }
    // Sightlines (filters/sightline.py): keep origins within the radius of
    // the line through the filter's origin along its z axis.
    const float* flt = fp + XRT_SRC_F + ip[0] * XRT_OPT_F + ip[1] * XRT_AP_F;
    for (int f = 0; f < ip[XRT_H_FILTERS]; ++f, flt += XRT_FILT_F) {
        const float lx_ = flt[0] - px, ly_ = flt[1] - py, lz_ = flt[2] - pz;
        const float proj = lx_ * flt[3] + ly_ * flt[4] + lz_ * flt[5];
        const float ex = lx_ - proj * flt[3];
        const float ey = ly_ - proj * flt[4];
        const float ez = lz_ - proj * flt[5];
        keep = keep && ex * ex + ey * ey + ez * ez <= flt[6];
    }
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
        const int shape = api[a * XRT_AP_I];
        bool test;
        if (shape == 1) {
            test = ax * ax + ay * ay < p0;
        } else if (shape == 2) {
            test = fabsf(ax) < p0 && fabsf(ay) < p0;
        } else if (shape == 3) {
            test = fabsf(ax) < p0 && fabsf(ay) < p1;
        } else if (shape == 0) {
            test = true;
        } else {
            const float ex = ax / p0, ey = ay / p1;
            test = ex * ex + ey * ey < 1.0f;
        }
        test = test && m_in;
        // The logic's truth table, a nibble a code indexed by 2 m_out +
        // test (0 and 8, 1 and-not 4, 2 or 0xE, 3 nand 7, 4 nor 1, 5 xor 6,
        // else xnor 9): one shift in place of a switch over seven codes,
        // and the shapes by frequency, the baffles' circles first
        // (chip_ab.py `apertures_switch`, PERF.md).
        const unsigned int logic = min((unsigned int)api[a * XRT_AP_I + 1], 6u);
        const bool nv = (0x9617E48u >> (4u * logic + 2u * m_out + test)) & 1u;
        m_out = m_in ? nv : m_out;
    }
    return m_out && m_in;
}

// The isotropic cone of a plasma ray at (px, py, pz): about the unit
// direction to the target fp[9:12], in the per-ray basis of
// vec.orthogonal_basis with the hint fp[12:15]; omc = 1 - cos(half-angle).
// Draws u, v; writes the unit direction.
template <class D>
__device__ __forceinline__ void xrt_plasma_cone(const float* fp, float omc,
                                                D& draw, float px,
                                                float py, float pz,
                                                float& dx, float& dy,
                                                float& dz) {
    const float u = draw();
    const float v = draw();
    const float lz = 1.0f - u * omc;
    const float rho = sqrtf(fmaxf(1.0f - lz * lz, 0.0f));
    const float phi = v * 6.283185307179586f;
    float sp, cp;
    xrt_sincos(phi, sp, cp);
    xrt_aim(fp + 9, fp + 12, px, py, pz, rho * cp, rho * sp, lz,
            dx, dy, dz);
}

// Plasma source of bundle tables (fp[0:20]: source basis rows, target,
// basis hint x + z, line centre, Doppler conversion, natural width, voxel
// edge, 1/c) for a ray whose bundle row is (a, b): origin xyz, cone
// half-angle, then temperature and velocity xyz. Draws 3 voxel uniforms
// (voxel), u and v for the cone, one uniform for the normal, one Cauchy
// uniform (cauchy), as fused_trace.py:1489-1537 does.
template <class D>
__device__ __forceinline__ void xrt_sample_plasma(
    const float* fp, bool voxel, bool cauchy, D& draw, float4 a, float4 b,
    float& px, float& py, float& pz, float& dx, float& dy, float& dz,
    float& wl) {
    px = a.x;
    py = a.y;
    pz = a.z;
    if (voxel) {
        const float h = fp[18];
        const float vx = (draw() - 0.5f) * h;
        const float vy = (draw() - 0.5f) * h;
        const float vz = (draw() - 0.5f) * h;
        px = px + vx * fp[0] + vy * fp[3] + vz * fp[6];
        py = py + vx * fp[1] + vy * fp[4] + vz * fp[7];
        pz = pz + vx * fp[2] + vy * fp[5] + vz * fp[8];
    }
    xrt_plasma_cone(fp, 1.0f - cosf(a.w), draw, px, py, pz, dx, dy, dz);
    // Exact Voigt: Gaussian of the bundle's Doppler width plus a Cauchy;
    // then the bulk Doppler.
    const float gauss = xrt_normal(draw);
    wl = fp[15] + fp[16] * sqrtf(fmaxf(b.x, 0.0f)) * gauss;
    if (cauchy) wl = wl + xrt_cauchy(draw, fp[17]);
    wl = wl * (1.0f - (b.y * dx + b.z * dy + b.w * dz) * fp[19]);
}

// Torus root in torus-centred local coordinates (axis = local y): ray
// origin (olx, oly, olz) and direction (dlx, dly, dlz), tube-centre circle
// of radius r_maj, squared tube radius rmin2. The root of
// G(t) = (|xz|(t) - r_maj)^2 + y(t)^2 - rmin2 by four steps of the local
// quadratic model from t = -z0 / dlz, the hit on the tangent plane at the
// optic origin (z0: the ray origin's height over that plane;
// torus_local_quadratic_t, fused_trace.py:616-702). Returns t; *step gets
// the last step, whose size tells convergence.
__device__ __forceinline__ float xrt_torus_root(float olx, float oly,
                                                float olz, float dlx,
                                                float dly, float dlz,
                                                float z0, float r_maj,
                                                float rmin2, float* step) {
    float t = -z0 / (fabsf(dlz) > 1e-9f ? dlz : 1e-9f);
    float s = 0.0f;
    for (int it = 0; it < 4; ++it) {
        const float X = olx + t * dlx, Y = oly + t * dly, Z = olz + t * dlz;
        const float s2 = fmaxf(X * X + Z * Z, 1e-30f);
        const float inv_rho = inv_sqrt(s2);
        const float rr = s2 * inv_rho - r_maj;
        const float G = rr * rr + Y * Y - rmin2;
        const float rhop = (X * dlx + Z * dlz) * inv_rho;
        const float Gp = 2.0f * rr * rhop + 2.0f * Y * dly;
        const float rhopp = ((dlx * dlx + dlz * dlz) - rhop * rhop) * inv_rho;
        const float Gpp = 2.0f * (rhop * rhop + rr * rhopp) + 2.0f * dly * dly;
        const float disc = Gp * Gp - 2.0f * Gpp * G;
        const float sgn = Gp >= 0.0f ? 1.0f : -1.0f;
        float dq = Gp + sgn * sqrtf(fmaxf(disc, 0.0f));
        dq = fabsf(dq) > 1e-12f ? dq : sgn * 1e-12f;
        const float gp_safe = fabsf(Gp) > 1e-12f ? Gp : sgn * 1e-12f;
        s = G / (disc >= 0.0f ? 0.5f * dq : gp_safe);
        t = t - s;
    }
    *step = s;
    return t;
}

// Torus of the optic block o (origin o[0:3], basis rows o[3:12], centre
// o[12:15], major radius o[15], o[XRT_O_RMIN2] = r_minor^2): *hit is
// alive, a last step below o[XRT_O_TOL] and t > 1e-6; returns t, or 0 on a
// miss.
__device__ __forceinline__ float xrt_torus_hit(const float* o, float px,
                                               float py, float pz, float dx,
                                               float dy, float dz, bool alive,
                                               bool* hit) {
    const float rx = px - o[12], ry = py - o[13], rz = pz - o[14];
    const float olx = rx * o[3] + ry * o[4] + rz * o[5];
    const float oly = rx * o[6] + ry * o[7] + rz * o[8];
    const float olz = rx * o[9] + ry * o[10] + rz * o[11];
    const float dlx = dx * o[3] + dy * o[4] + dz * o[5];
    const float dly = dx * o[6] + dy * o[7] + dz * o[8];
    const float dlz = dx * o[9] + dy * o[10] + dz * o[11];
    const float z0 = (px - o[0]) * o[9] + (py - o[1]) * o[10] + (pz - o[2]) * o[11];
    float step;
    const float t = xrt_torus_root(olx, oly, olz, dlx, dly, dlz, z0, o[15],
                                   o[XRT_O_RMIN2], &step);
    *hit = alive && fabsf(step) < o[XRT_O_TOL] && t > 1e-6f;
    return *hit ? t : 0.0f;
}

// Cylinder of axis (ax, ay, az) through C and squared radius r2: the
// stable quadratic of the ray's components across the axis; the near root
// (convex) or the far root (concave). The ray hits where disc >= 0.
struct CylinderHit {
    float dpx, dpy, dpz, d_ax, p_ax, A1x, A1y, A1z, B1x, B1y, B1z, qa, qb,
        disc, t;
};

__device__ __forceinline__ CylinderHit xrt_cylinder_hit(
    float Cx, float Cy, float Cz, float ax, float ay, float az, float r2,
    bool convex, float px, float py, float pz, float dx, float dy, float dz) {
    CylinderHit h;
    h.dpx = px - Cx;
    h.dpy = py - Cy;
    h.dpz = pz - Cz;
    h.d_ax = dx * ax + dy * ay + dz * az;
    h.p_ax = h.dpx * ax + h.dpy * ay + h.dpz * az;
    h.A1x = dx - h.d_ax * ax;
    h.A1y = dy - h.d_ax * ay;
    h.A1z = dz - h.d_ax * az;
    h.B1x = h.dpx - h.p_ax * ax;
    h.B1y = h.dpy - h.p_ax * ay;
    h.B1z = h.dpz - h.p_ax * az;
    h.qa = h.A1x * h.A1x + h.A1y * h.A1y + h.A1z * h.A1z;
    h.qb = 2.0f * (h.A1x * h.B1x + h.A1y * h.B1y + h.A1z * h.B1z);
    const float qc = h.B1x * h.B1x + h.B1y * h.B1y + h.B1z * h.B1z - r2;
    h.disc = h.qb * h.qb - 4.0f * h.qa * qc;
    const float sq = sqrtf(fmaxf(h.disc, 0.0f));
    const float sgn = h.qb >= 0.0f ? 1.0f : -1.0f;
    const float qq = -0.5f * (h.qb + sgn * sq);
    const float t0 = qq / (fabsf(h.qa) > 1e-30f ? h.qa : 1e-30f);
    const float t1 = fabsf(qq) > 1e-30f ? qc / qq : t0;
    h.t = convex ? fminf(t0, t1) : fmaxf(t0, t1);
    return h;
}

// The torus normal at q, not yet normalised: from the tube centre (q
// projected onto the axis circle) to q (fused_trace.py:913-926).
__device__ __forceinline__ void xrt_torus_normal(const float* o, float qx,
                                                 float qy, float qz,
                                                 float& nx, float& ny,
                                                 float& nz) {
    const float ptx = qx - o[12], pty = qy - o[13], ptz = qz - o[14];
    const float d_y = ptx * o[6] + pty * o[7] + ptz * o[8];
    const float plx = ptx - d_y * o[6];
    const float ply = pty - d_y * o[7];
    const float plz = ptz - d_y * o[8];
    const float inv = inv_sqrt(fmaxf(plx * plx + ply * ply + plz * plz, 1e-30f));
    nx = ptx - o[15] * plx * inv;
    ny = pty - o[15] * ply * inv;
    nz = ptz - o[15] * plz * inv;
}

// A file rocking curve (the TPU kernels' rock_prob file branch,
// fused_trace.py:733-754): the table T of K float32 values resampled on a
// uniform grid from lo with 1 / step inv_step (aux memory, read through the
// read-only cache), at the deviation delta. f = (delta - lo) inv_step, in
// range before its clip to [0, K - 1]; the value is the two nonzero tent
// weights of the TPU's matvec in its order, at k = floor(f) and
// min(k + 1, K - 1). *f and *kf get the clipped index and its floor, *t0
// and *t1 the two table values (the gradient kernels' slope).
__device__ __forceinline__ float xrt_file_value(const float* __restrict__ T,
                                                int K, float lo,
                                                float inv_step, float delta,
                                                bool* inr, float* f,
                                                float* kf, float* t0,
                                                float* t1) {
    const float fidx = (delta - lo) * inv_step;
    *inr = fidx >= 0.0f && fidx <= (float)(K - 1);
    *f = fminf(fmaxf(fidx, 0.0f), (float)(K - 1));
    *kf = floorf(*f);
    const int k = (int)*kf;
    *t0 = __ldg(T + k);
    *t1 = __ldg(T + min(k + 1, K - 1));
    return *t0 * (1.0f - (*f - *kf)) + *t1 * (1.0f - ((*kf + 1.0f) - *f));
}

// The sums z, zx, zy of C, Cx and Cy at (uc, vc) for a surface of degree D
// (xrt_cheb_hit): every term c T_i(uc) T_j(vc) of the dense matrices, i
// outer, j inner, from coef[(D + 1) i + j] = (C_ij, Cx_ij, Cy_ij, 0). The T
// values follow the recurrence T_k = 2 x T_(k-1) - T_(k-2): the row of
// T_j(vc) in registers (the inner loop is unrolled to the degree), T_i(uc)
// carried from one outer step to the next, which stays a loop so that the
// coefficients are not all held in registers at once. The TPU kernel
// skips the zero coefficients; a zero term adds +-0 to a finite sum that
// starts at +0, which changes no bit, so the dense sums equal its sums.
template <int D>
__device__ __forceinline__ void xrt_cheb_sums(const float4* __restrict__ coef, float uc,
                                              float vc, float& z, float& zx, float& zy) {
    float tv[D + 1];
    tv[0] = 1.0f;
    tv[1] = vc;
#pragma unroll
    for (int k = 2; k <= D; ++k) tv[k] = 2.0f * vc * tv[k - 1] - tv[k - 2];
    z = 0.0f;
    zx = 0.0f;
    zy = 0.0f;
    float ti = 1.0f, tn = uc;  // T_i(uc), T_(i+1)(uc)
#pragma unroll 1
    for (int i = 0; i <= D; ++i, coef += D + 1) {
#pragma unroll
        for (int j = 0; j <= D; ++j) {
            const float4 c = __ldg(coef + j);
            z = z + c.x * ti * tv[j];
            zx = zx + c.y * ti * tv[j];
            zy = zy + c.z * ti * tv[j];
        }
        const float t = 2.0f * uc * tn - ti;
        ti = tn;
        tn = t;
    }
}

// The Chebyshev height field z = sum_ij C_ij T_i(u) T_j(v) of a smooth
// mesh (JAX _fit_cheb_surface and fused_trace.py:813-887), in the local
// frame of the optic block o (origin o[0:3], basis rows o[3:12]; centre
// o[12:14] and scales o[14:16] map x, y to u, v; mid-plane o[XRT_O_RMIN2],
// tolerance o[XRT_O_TOL]). coef: the dense coefficients in aux memory
// (xrt_cheb_sums; ops/fused_trace.py: cheb_dense) of degree deg, one of 4,
// 6, 8, 10, 12 (_fit_cheb_surface's). Four Newton steps on F(t) = Olz +
// t Dlz - z(x(t), y(t)) from the mid-plane on u, v clipped to 1.25. *hit:
// alive, the last step below the tolerance, t > 1e-6 and |u|, |v| <= 1
// before the clip. The normal is the last gradient's, in the global frame
// (unit). Returns t, 0 on a miss.
__device__ __forceinline__ float xrt_cheb_hit(const float* o,
                                              const float4* __restrict__ coef,
                                              int deg, float px, float py, float pz,
                                              float dx, float dy, float dz, bool alive,
                                              bool* hit, float& nx, float& ny,
                                              float& nz) {
    const float rx = px - o[0], ry = py - o[1], rz = pz - o[2];
    const float Olx = rx * o[3] + ry * o[4] + rz * o[5];
    const float Oly = rx * o[6] + ry * o[7] + rz * o[8];
    const float Olz = rx * o[9] + ry * o[10] + rz * o[11];
    const float Dlx = dx * o[3] + dy * o[4] + dz * o[5];
    const float Dly = dx * o[6] + dy * o[7] + dz * o[8];
    const float Dlz = dx * o[9] + dy * o[10] + dz * o[11];
    float t = (o[XRT_O_RMIN2] - Olz) / (fabsf(Dlz) > 1e-9f ? Dlz : 1e-9f);
    float step = 0.0f, u = 0.0f, v = 0.0f, zx = 0.0f, zy = 0.0f;
    for (int it = 0; it < 4; ++it) {
        u = (Olx + t * Dlx - o[12]) * o[14];
        v = (Oly + t * Dly - o[13]) * o[15];
        const float uc = fminf(fmaxf(u, -1.25f), 1.25f);
        const float vc = fminf(fmaxf(v, -1.25f), 1.25f);
        float z;
        switch (deg) {  // the same degree in every lane
            case 4: xrt_cheb_sums<4>(coef, uc, vc, z, zx, zy); break;
            case 6: xrt_cheb_sums<6>(coef, uc, vc, z, zx, zy); break;
            case 8: xrt_cheb_sums<8>(coef, uc, vc, z, zx, zy); break;
            case 10: xrt_cheb_sums<10>(coef, uc, vc, z, zx, zy); break;
            default: xrt_cheb_sums<12>(coef, uc, vc, z, zx, zy);
        }
        const float F = Olz + t * Dlz - z;
        float Fp = Dlz - zx * Dlx - zy * Dly;
        Fp = fabsf(Fp) > 1e-9f ? Fp : 1e-9f;
        step = F / Fp;
        t = t - step;
    }
    *hit = alive && fabsf(step) < o[XRT_O_TOL] && t > 1e-6f && fabsf(u) <= 1.0f &&
           fabsf(v) <= 1.0f;
    const float inv = inv_sqrt(zx * zx + zy * zy + 1.0f);
    const float nlx = -zx * inv, nly = -zy * inv, nlz = inv;
    nx = nlx * o[3] + nly * o[6] + nlz * o[9];
    ny = nlx * o[4] + nly * o[7] + nlz * o[10];
    nz = nlx * o[5] + nly * o[8] + nlz * o[11];
    return *hit ? t : 0.0f;
}
