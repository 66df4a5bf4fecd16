// Fused gradient kernels for NVIDIA Hopper (sm_90a): K5f, the weight-mode
// forward with bilinear images, and K5b, its hand-derived adjoint.
//
// Replaces xicsrt_tpu/ops/fused_grad.py::build_fused_diff, make_kernel(False)
// (K5f) and make_kernel(True) (K5b), for point sources, plane and sphere
// optics, and no interaction, a mirror or a Bragg crystal with a gaussian or
// step rocking curve. One thread carries one ray; a ray's draws are keyed by
// (seed, ray, draw) as in K1a (trace_common.cuh), so K5b regenerates exactly
// the rays K5f traced.
//
// The differentiated parameters arrive at run time in pvec (24 slots per
// optic: origin, basis rows, radius, crystal_spacing, rocking_fwhm,
// reflectivity), read once per block into shared memory, so a descent loop
// rebuilds nothing. The structure (sampler, shapes, bounds, apertures,
// images) is K1a's packed fp/ip layout; its geometry entries are unused.
//
// Numerics follow the plain PyTorch twins of ops/fused_grad.py operation by
// operation (_optic_fwd/_optic_bwd, the JAX _trace_fwd/_trace_bwd); the
// library is built with -fmad=false.
//
// K5f: the chain runs in registers; each imaged hit adds its four bilinear
// corners into a block-private shared-memory image (four shared atomics),
// flushed once per block with global atomics. Bounded by arithmetic and the
// shared atomics.
//
// K5b: for optic i = n-1 .. 0 the ray's forward is recomputed from the
// source up to optic i (n(n+1)/2 optic evaluations a ray, none stored), so
// every primal lives in registers and nothing spills to local arrays. The
// cotangent images are staged in shared memory and gathered at the hit's
// four corners. Each optic's 16 slot contributions are summed over the warp
// with shuffles and added by lane 0 to float64 slot sums in shared memory;
// each block writes its row of slot sums, which the host adds in float64.
// Per-ray terms cancel heavily, so no float32 sum spans more than a warp.
// Bounded by arithmetic (the recomputed forward) and the shuffles.
#include <cuda_runtime.h>
#include <stdint.h>

#include "binning.cuh"
#include "trace_common.cuh"

#define XRT_GRAD_SLOTS 24
#define XRT_GRAD_USED 16
#define XRT_GRAD_MAX_SLOTS (XRT_MAX_OPTICS * XRT_GRAD_SLOTS)
#define XRT_EPS 1e-12f
#define XRT_SIGMA_PER_FWHM 0.42466090014400953f

namespace {

struct RayState {
    float px, py, pz, dx, dy, dz, w;
    bool alive;
};

// What the adjoint of one optic needs, computed by grad_optic_fwd.
struct OpticLocals {
    float dpx, dpy, dpz;  // direction entering the optic
    float t, qx, qy, qz, nx, ny, nz, lxv, lyv;
    float D;                                   // plane
    float Lx, Ly, Lz, t_ca, t_hc, r, inv_r;    // sphere
    float dot, adot, cosi, sd, prob, w_pre;    // mirror / crystal
    float sin_b, cos_b, d_s, refl, sigma, z;
    bool mask, step_in;
};

__device__ __forceinline__ float sign_of(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Weight-mode forward of one optic (ops/fused_grad.py:_optic_fwd).
// o, oi: the optic's packed structure; P: its 24 parameter slots.
__device__ __forceinline__ void grad_optic_fwd(const float* o, const int* oi,
                                               const float* P,
                                               const float* apf,
                                               const int* api, float lam,
                                               RayState& st, OpticLocals& L) {
    const float ox = P[0], oy = P[1], oz = P[2];
    const float bxx = P[3], bxy = P[4], bxz = P[5];
    const float byx = P[6], byy = P[7], byz = P[8];
    const float bzx = P[9], bzy = P[10], bzz = P[11];
    L.dpx = st.dx;
    L.dpy = st.dy;
    L.dpz = st.dz;
    bool mask;
    float Cx = 0.0f, Cy = 0.0f, Cz = 0.0f;
    if (oi[0] == 0) {  // plane
        bool nonzero;
        L.t = xrt_plane_hit(ox, oy, oz, bzx, bzy, bzz, st.px, st.py, st.pz,
                            st.dx, st.dy, st.dz, &L.D, &nonzero);
        mask = st.alive && L.t >= 0.0f;
    } else {  // sphere, center o + sign r bz
        L.r = P[12];
        const float sign = oi[1] ? -1.0f : 1.0f;
        Cx = ox + sign * L.r * bzx;
        Cy = oy + sign * L.r * bzy;
        Cz = oz + sign * L.r * bzz;
        const float r2 = L.r * L.r;
        const SphereHit h = xrt_sphere_hit(Cx, Cy, Cz, r2, XRT_EPS, oi[1] != 0,
                                           st.px, st.py, st.pz, st.dx, st.dy,
                                           st.dz);
        mask = st.alive && h.d2 <= r2;
        L.Lx = h.Lx;
        L.Ly = h.Ly;
        L.Lz = h.Lz;
        L.t_ca = h.t_ca;
        L.t_hc = h.t_hc;
        L.t = h.t;
    }
    L.qx = st.px + L.t * st.dx;
    L.qy = st.py + L.t * st.dy;
    L.qz = st.pz + L.t * st.dz;
    if (oi[0] == 0) {
        L.nx = bzx;
        L.ny = bzy;
        L.nz = bzz;
    } else {  // toward the center for both convexities; |C - q| = r
        L.inv_r = 1.0f / fmaxf(L.r, XRT_EPS);
        L.nx = (Cx - L.qx) * L.inv_r;
        L.ny = (Cy - L.qy) * L.inv_r;
        L.nz = (Cz - L.qz) * L.inv_r;
    }
    const float rx = L.qx - ox, ry = L.qy - oy, rz = L.qz - oz;
    L.lxv = rx * bxx + ry * bxy + rz * bxz;
    L.lyv = rx * byx + ry * byy + rz * byz;
    mask = xrt_bounds(mask, oi[4], o + 16, L.lxv, L.lyv, rx, ry, rz, bzx, bzy,
                      bzz);
    mask = xrt_apertures(apf, api, oi[6], oi[5], L.lxv, L.lyv, mask);

    if (oi[2] == 1 || oi[2] == 2) {
        L.dot = st.dx * L.nx + st.dy * L.ny + st.dz * L.nz;
    }
    if (oi[2] == 1) {  // crystal
        L.d_s = P[13];
        const float fwhm = P[14];
        L.refl = P[15];
        L.sin_b = fminf(fmaxf(lam / (2.0f * fmaxf(L.d_s, XRT_EPS)), 0.0f),
                        1.0f);
        L.cos_b = sqrtf(fmaxf(1.0f - L.sin_b * L.sin_b, XRT_EPS));
        L.adot = fabsf(L.dot);
        L.cosi = sqrtf(fmaxf(1.0f - L.adot * L.adot, XRT_EPS));
        L.sd = L.adot * L.cos_b - L.cosi * L.sin_b;
        const float delta = L.sd + L.sd * L.sd * L.sd * (1.0f / 6.0f);
        if (oi[3] == 0) {  // gaussian
            L.sigma = fmaxf(fwhm * XRT_SIGMA_PER_FWHM, XRT_EPS);
            L.z = delta / L.sigma;
            L.prob = L.refl * expf(-0.5f * L.z * L.z);
        } else {  // step: hard edges
            L.step_in = fabsf(delta) <= fwhm / 2.0f;
            L.prob = L.step_in ? L.refl : 0.0f;
        }
        L.w_pre = st.w;
        if (mask) st.w = st.w * L.prob;
    }
    if ((oi[2] == 1 || oi[2] == 2) && mask) {  // reflect
        const float kk = 2.0f * L.dot;
        st.dx = st.dx - kk * L.nx;
        st.dy = st.dy - kk * L.ny;
        st.dz = st.dz - kk * L.nz;
    }
    L.mask = mask;
    st.px = L.qx;
    st.py = L.qy;
    st.pz = L.qz;
    st.alive = mask;
}

// The two grid neighbours of a pixel coordinate clipped to [-2, n + 1]
// (fused_grad.py:1795-1796): index, tent value and tent slope (0 at an
// integer coordinate, fused_grad.py:1829).
struct Corners {
    int i0;
    float t0, t1, s0, s1;
};

__device__ __forceinline__ Corners corners(float f, int n) {
    const float fc = fminf(fmaxf(f, -2.0f), (float)n + 1.0f);
    const float p0 = floorf(fc);
    const float a = fc - p0;
    const float moving = a > 0.0f ? 1.0f : 0.0f;
    return Corners{(int)p0, 1.0f - a, a, -moving, moving};
}

__global__ void fused_grad_fwd_kernel(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip,
    int n_ip, const float* __restrict__ g_pvec, int n_slots,
    long long n_total, float lam, const float* __restrict__ uniforms,
    uint32_t seed0, uint32_t seed1, float* __restrict__ images,
    int img_total, int use_smem) {
    extern __shared__ float s_img[];
    __shared__ float fp[XRT_MAX_FP];
    __shared__ int ip[XRT_MAX_IP];
    __shared__ float P[XRT_GRAD_MAX_SLOTS];

    for (int i = threadIdx.x; i < n_fp; i += blockDim.x) fp[i] = g_fp[i];
    for (int i = threadIdx.x; i < n_ip; i += blockDim.x) ip[i] = g_ip[i];
    for (int i = threadIdx.x; i < n_slots; i += blockDim.x) P[i] = g_pvec[i];
    if (use_smem) xrt_smem_zero(s_img, img_total);
    __syncthreads();

    float* img = use_smem ? s_img : images;
    const int n_opt = ip[0];
    const float* apf = fp + XRT_SRC_F + n_opt * XRT_OPT_F;
    const int* api = ip + XRT_HDR_I + n_opt * XRT_OPT_I;
    const long long stride = (long long)gridDim.x * blockDim.x;

    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r < n_total; r += stride) {
        Draws draw{uniforms, n_total, r, seed0, seed1, 0, -1, {0u, 0u, 0u, 0u}};
        RayState st;
        xrt_sample_source(fp, ip[2], draw, st.px, st.py, st.pz, st.dx, st.dy,
                          st.dz);
        st.w = 1.0f;
        st.alive = true;
        for (int e = 0; e < n_opt; ++e) {
            const float* o = fp + XRT_SRC_F + e * XRT_OPT_F;
            const int* oi = ip + XRT_HDR_I + e * XRT_OPT_I;
            OpticLocals L;
            grad_optic_fwd(o, oi, P + e * XRT_GRAD_SLOTS, apf, api, lam, st, L);
            if (oi[7] >= 0 && L.mask) {
                const int nx = oi[8], ny = oi[9];
                const Corners cx = corners(L.lxv * o[23] + o[24], nx);
                const Corners cy = corners(L.lyv * o[23] + o[25], ny);
                const float w = st.w;
                float* base = img + oi[7];
                for (int a = 0; a < 2; ++a) {
                    const int ix = cx.i0 + a;
                    if (ix < 0 || ix >= nx) continue;
                    const float wx = w * (a ? cx.t1 : cx.t0);
                    for (int b = 0; b < 2; ++b) {
                        const int iy = cy.i0 + b;
                        if (iy < 0 || iy >= ny) continue;
                        atomicAdd(base + ix * ny + iy, wx * (b ? cy.t1 : cy.t0));
                    }
                }
            }
        }
    }

    if (use_smem) {
        __syncthreads();
        xrt_smem_flush(s_img, images, img_total);
    }
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    return v;
}

__global__ void fused_grad_bwd_kernel(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip,
    int n_ip, const float* __restrict__ g_pvec, int n_slots,
    long long n_total, float lam, const float* __restrict__ uniforms,
    uint32_t seed0, uint32_t seed1, const float* __restrict__ g_images,
    int img_total, int use_smem, double* __restrict__ partial) {
    extern __shared__ float s_g[];
    __shared__ float fp[XRT_MAX_FP];
    __shared__ int ip[XRT_MAX_IP];
    __shared__ float P[XRT_GRAD_MAX_SLOTS];
    __shared__ double s_acc[XRT_GRAD_MAX_SLOTS];

    for (int i = threadIdx.x; i < n_fp; i += blockDim.x) fp[i] = g_fp[i];
    for (int i = threadIdx.x; i < n_ip; i += blockDim.x) ip[i] = g_ip[i];
    for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
        P[i] = g_pvec[i];
        s_acc[i] = 0.0;
    }
    if (use_smem) {
        for (int i = threadIdx.x; i < img_total; i += blockDim.x) {
            s_g[i] = g_images[i];
        }
    }
    __syncthreads();

    const float* gimg = use_smem ? s_g : g_images;
    const int n_opt = ip[0];
    const float* apf = fp + XRT_SRC_F + n_opt * XRT_OPT_F;
    const int* api = ip + XRT_HDR_I + n_opt * XRT_OPT_I;
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * blockDim.x;

    // Whole warps step together (blockDim is a multiple of 32), so every
    // lane reaches every shuffle; lanes past the end carry zero adjoints.
    for (long long r0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
         r0 < n_total; r0 += stride) {
        const long long r = r0 + lane;
        const bool in_range = r < n_total;
        Draws draw{uniforms, n_total, in_range ? r : n_total - 1,
                   seed0, seed1, 0, -1, {0u, 0u, 0u, 0u}};
        RayState src;
        xrt_sample_source(fp, ip[2], draw, src.px, src.py, src.pz, src.dx,
                          src.dy, src.dz);
        src.w = 1.0f;
        src.alive = in_range;

        float pbx = 0.0f, pby = 0.0f, pbz = 0.0f;  // adjoint of position
        float dbx = 0.0f, dby = 0.0f, dbz = 0.0f;  // adjoint of direction
        float wb = 0.0f;                           // adjoint of weight
        for (int i = n_opt - 1; i >= 0; --i) {
            const float* o = fp + XRT_SRC_F + i * XRT_OPT_F;
            const int* oi = ip + XRT_HDR_I + i * XRT_OPT_I;
            const float* Pi = P + i * XRT_GRAD_SLOTS;
            // Recompute the forward up to and through optic i.
            RayState st = src;
            OpticLocals L;
            for (int e = 0; e <= i; ++e) {
                grad_optic_fwd(fp + XRT_SRC_F + e * XRT_OPT_F,
                               ip + XRT_HDR_I + e * XRT_OPT_I,
                               P + e * XRT_GRAD_SLOTS, apf, api, lam, st, L);
            }
            const float bxx = Pi[3], bxy = Pi[4], bxz = Pi[5];
            const float byx = Pi[6], byy = Pi[7], byz = Pi[8];
            const float bzx = Pi[9], bzy = Pi[10], bzz = Pi[11];
            const float mf = L.mask ? 1.0f : 0.0f;
            const bool mask = L.mask;
            float a[XRT_GRAD_USED];
#pragma unroll
            for (int k = 0; k < XRT_GRAD_USED; ++k) a[k] = 0.0f;

            float qbx = pbx, qby = pby, qbz = pbz;
            float lxb = 0.0f, lyb = 0.0f;
            if (oi[7] >= 0) {  // seeds: the cotangent image at four corners
                const int nx = oi[8], ny = oi[9];
                const Corners cx = corners(L.lxv * o[23] + o[24], nx);
                const Corners cy = corners(L.lyv * o[23] + o[25], ny);
                const float* g = gimg + oi[7];
                float gw = 0.0f, gx = 0.0f, gy = 0.0f;
                for (int ca = 0; ca < 2; ++ca) {
                    const int ix = cx.i0 + ca;
                    const float tx = ca ? cx.t1 : cx.t0;
                    const float dtx = ca ? cx.s1 : cx.s0;
                    for (int cb = 0; cb < 2; ++cb) {
                        const int iy = cy.i0 + cb;
                        const bool ok = ix >= 0 && ix < nx && iy >= 0 && iy < ny;
                        const float gc = ok ? g[ix * ny + iy] : 0.0f;
                        const float ty = cb ? cy.t1 : cy.t0;
                        const float dty = cb ? cy.s1 : cy.s0;
                        gw = gw + tx * ty * gc;
                        gx = gx + dtx * ty * gc;
                        gy = gy + tx * dty * gc;
                    }
                }
                const float w_img = mask ? st.w : 0.0f;
                wb = wb + gw * mf;
                lxb = gx * w_img * mf;
                lyb = gy * w_img * mf;
            }

            // ---- interaction: d_post = d_pre - 2 (d_pre . n) n ----------
            float nbx = 0.0f, nby = 0.0f, nbz = 0.0f;
            const float d0x = L.dpx, d0y = L.dpy, d0z = L.dpz;
            if (oi[2] == 1 || oi[2] == 2) {
                const float dot = L.dot;
                const float av = dbx * L.nx + dby * L.ny + dbz * L.nz;
                const float dpre_bx = mask ? dbx - 2.0f * av * L.nx : dbx;
                const float dpre_by = mask ? dby - 2.0f * av * L.ny : dby;
                const float dpre_bz = mask ? dbz - 2.0f * av * L.nz : dbz;
                nbx = nbx - mf * 2.0f * (av * d0x + dot * dbx);
                nby = nby - mf * 2.0f * (av * d0y + dot * dby);
                nbz = nbz - mf * 2.0f * (av * d0z + dot * dbz);
                dbx = dpre_bx;
                dby = dpre_by;
                dbz = dpre_bz;
                float dot_b = 0.0f;
                if (oi[2] == 1) {  // w_post = where(mask, w_pre * prob, w_pre)
                    const float prob = L.prob;
                    const float prob_b = mask ? wb * L.w_pre : 0.0f;
                    wb = mask ? wb * prob : wb;
                    float refl_b, delta_b;
                    if (oi[3] == 0) {
                        delta_b = prob_b * prob * (-L.z / L.sigma);
                        const float sigma_b = prob_b * prob * (L.z * L.z / L.sigma);
                        refl_b = prob_b * (prob / fmaxf(L.refl, XRT_EPS));
                        a[14] += sigma_b * mf * XRT_SIGMA_PER_FWHM;
                    } else {
                        refl_b = prob_b * (L.step_in ? 1.0f : 0.0f);
                        delta_b = 0.0f;
                    }
                    a[15] += refl_b * mf;
                    const float sd = L.sd;
                    const float sd_b = delta_b * (1.0f + 0.5f * sd * sd);
                    const float adot_b =
                        sd_b * (L.cos_b + L.adot / L.cosi * L.sin_b);
                    const float sinb_b =
                        sd_b * (-L.adot * L.sin_b / L.cos_b - L.cosi);
                    const float ds_b =
                        sinb_b * (-lam / (2.0f * fmaxf(L.d_s * L.d_s, XRT_EPS)));
                    const bool inr = L.sin_b > 0.0f && L.sin_b < 1.0f;
                    a[13] += (inr ? ds_b : 0.0f) * mf;
                    dot_b = sign_of(dot) * adot_b * mf;
                }
                dbx = dbx + dot_b * L.nx;
                dby = dby + dot_b * L.ny;
                dbz = dbz + dot_b * L.nz;
                nbx = nbx + dot_b * d0x;
                nby = nby + dot_b * d0y;
                nbz = nbz + dot_b * d0z;
            }

            // ---- local coordinates: lx = bx . (q - o), ly = by . (q - o) -
            if (oi[7] >= 0) {
                lxb = lxb * o[23];
                lyb = lyb * o[23];
            }
            const float rxq = L.qx - Pi[0], ryq = L.qy - Pi[1], rzq = L.qz - Pi[2];
            qbx = qbx + lxb * bxx + lyb * byx;
            qby = qby + lxb * bxy + lyb * byy;
            qbz = qbz + lxb * bxz + lyb * byz;
            a[0] += -(lxb * bxx + lyb * byx);
            a[1] += -(lxb * bxy + lyb * byy);
            a[2] += -(lxb * bxz + lyb * byz);
            a[3] += lxb * rxq;
            a[4] += lxb * ryq;
            a[5] += lxb * rzq;
            a[6] += lyb * rxq;
            a[7] += lyb * ryq;
            a[8] += lyb * rzq;

            // ---- normal ------------------------------------------------
            float Cbx = 0.0f, Cby = 0.0f, Cbz = 0.0f, r_b_n = 0.0f;
            if (oi[0] == 0) {  // n = bz
                a[9] += nbx;
                a[10] += nby;
                a[11] += nbz;
            } else {  // n = (C - q) / r
                Cbx = L.inv_r * nbx;
                Cby = L.inv_r * nby;
                Cbz = L.inv_r * nbz;
                qbx = qbx - Cbx;
                qby = qby - Cby;
                qbz = qbz - Cbz;
                const float ndot = L.nx * nbx + L.ny * nby + L.nz * nbz;
                r_b_n = -ndot * L.inv_r * L.r * L.inv_r;
            }

            // ---- hit: q = p + t d ----------------------------------------
            const float t = L.t;
            const float t_b = qbx * d0x + qby * d0y + qbz * d0z;
            pbx = qbx;
            pby = qby;
            pbz = qbz;
            dbx = dbx + t * qbx;
            dby = dby + t * qby;
            dbz = dbz + t * qbz;
            if (oi[0] == 0) {  // t = ((o - p) . bz) / (d . bz)
                const float invD = 1.0f / L.D;
                pbx = pbx - t_b * bzx * invD;
                pby = pby - t_b * bzy * invD;
                pbz = pbz - t_b * bzz * invD;
                dbx = dbx - t_b * t * bzx * invD;
                dby = dby - t_b * t * bzy * invD;
                dbz = dbz - t_b * t * bzz * invD;
                a[0] += t_b * bzx * invD;
                a[1] += t_b * bzy * invD;
                a[2] += t_b * bzz * invD;
                a[9] += t_b * (Pi[0] - L.qx) * invD;
                a[10] += t_b * (Pi[1] - L.qy) * invD;
                a[11] += t_b * (Pi[2] - L.qz) * invD;
            } else {  // t = t_ca -+ t_hc, L = C - p
                const float t_hc = fmaxf(L.t_hc, 1e-6f);
                const float sign_hc = oi[1] ? -1.0f : 1.0f;
                const float t_ca = L.t_ca;
                const float cx = d0x + sign_hc * (t_ca * d0x - L.Lx) / t_hc;
                const float cy = d0y + sign_hc * (t_ca * d0y - L.Ly) / t_hc;
                const float cz = d0z + sign_hc * (t_ca * d0z - L.Lz) / t_hc;
                Cbx = Cbx + t_b * cx;
                Cby = Cby + t_b * cy;
                Cbz = Cbz + t_b * cz;
                pbx = pbx - t_b * cx;
                pby = pby - t_b * cy;
                pbz = pbz - t_b * cz;
                const float stretch = 1.0f + sign_hc * t_ca / t_hc;
                dbx = dbx + t_b * L.Lx * stretch;
                dby = dby + t_b * L.Ly * stretch;
                dbz = dbz + t_b * L.Lz * stretch;
                const float r_b = r_b_n + t_b * sign_hc * L.r / t_hc;
                const float sign_c = oi[1] ? -1.0f : 1.0f;
                a[0] += Cbx;
                a[1] += Cby;
                a[2] += Cbz;
                a[9] += sign_c * L.r * Cbx;
                a[10] += sign_c * L.r * Cby;
                a[11] += sign_c * L.r * Cbz;
                a[12] += r_b + sign_c * (bzx * Cbx + bzy * Cby + bzz * Cbz);
            }

            // ---- slot sums: warp shuffles, then float64 per block --------
#pragma unroll
            for (int k = 0; k < XRT_GRAD_USED; ++k) {
                const float v = warp_sum(in_range ? a[k] : 0.0f);
                if (lane == 0 && v != 0.0f) {
                    atomicAdd(s_acc + i * XRT_GRAD_SLOTS + k, (double)v);
                }
            }
        }
    }

    __syncthreads();
    for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
        partial[(long long)blockIdx.x * n_slots + i] = s_acc[i];
    }
}

constexpr int kThreads = 256;

bool grad_args_ok(int n_fp, int n_ip, int n_slots) {
    return n_fp <= XRT_MAX_FP && n_ip <= XRT_MAX_IP && n_slots > 0 &&
           n_slots <= XRT_GRAD_MAX_SLOTS;
}

size_t bwd_smem(int img_total) {
    return img_total <= XRT_SMEM_IMAGE_MAX_FLOATS
               ? (size_t)img_total * sizeof(float)
               : 0;
}

}  // namespace

// K5f. fp/ip: K1a's packed structure; pvec: n_slots float32 parameters;
// rays [0, n_total) with draws from uniforms (n_draws, n_total) float32 or
// Philox keyed by (seed0, seed1); lam: the source wavelength. images:
// (img_total,) float32, zeroed by the caller. Returns cudaGetLastError().
extern "C" int xrt_fused_grad_fwd(const float* fp, int n_fp, const int* ip,
                                  int n_ip, const float* pvec, int n_slots,
                                  long long n_total, float lam,
                                  const float* uniforms, unsigned int seed0,
                                  unsigned int seed1, float* images,
                                  int img_total, void* stream) {
    if (!grad_args_ok(n_fp, n_ip, n_slots)) return (int)cudaErrorInvalidValue;
    if (n_total <= 0) return (int)cudaSuccess;
    const int use_smem = img_total <= XRT_SMEM_IMAGE_MAX_FLOATS;
    const size_t smem = use_smem ? (size_t)img_total * sizeof(float) : 0;
    cudaError_t err = xrt_set_smem(fused_grad_fwd_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = xrt_grid_size(fused_grad_fwd_kernel, kThreads, smem, n_total);
    fused_grad_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        fp, n_fp, ip, n_ip, pvec, n_slots, n_total, lam, uniforms, seed0, seed1,
        images, img_total, use_smem);
    return (int)cudaGetLastError();
}

// Blocks xrt_fused_grad_bwd launches for these sizes (the rows of its
// partial output), or minus a cudaError_t.
extern "C" int xrt_fused_grad_bwd_blocks(long long n_total, int img_total) {
    const size_t smem = bwd_smem(img_total);
    cudaError_t err = xrt_set_smem(fused_grad_bwd_kernel, smem);
    if (err != cudaSuccess) return -(int)err;
    return xrt_grid_size(fused_grad_bwd_kernel, kThreads, smem, n_total);
}

// K5b. As K5f, plus g_images: (img_total,) float32 cotangent images, and
// partial: (n_blocks, n_slots) float64, one row of slot sums per block,
// with n_blocks from xrt_fused_grad_bwd_blocks. Returns cudaGetLastError().
extern "C" int xrt_fused_grad_bwd(const float* fp, int n_fp, const int* ip,
                                  int n_ip, const float* pvec, int n_slots,
                                  long long n_total, float lam,
                                  const float* uniforms, unsigned int seed0,
                                  unsigned int seed1, const float* g_images,
                                  int img_total, double* partial, int n_blocks,
                                  void* stream) {
    if (!grad_args_ok(n_fp, n_ip, n_slots) || n_blocks <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = bwd_smem(img_total);
    cudaError_t err = xrt_set_smem(fused_grad_bwd_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    fused_grad_bwd_kernel<<<n_blocks, kThreads, smem, (cudaStream_t)stream>>>(
        fp, n_fp, ip, n_ip, pvec, n_slots, n_total, lam, uniforms, seed0, seed1,
        g_images, img_total, smem > 0, partial);
    return (int)cudaGetLastError();
}
