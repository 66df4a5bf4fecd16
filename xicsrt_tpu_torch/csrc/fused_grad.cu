// Fused gradient kernels for NVIDIA Hopper (sm_90a): K5f, the weight-mode
// forward with bilinear images, and K5b, its hand-derived adjoint.
//
// Replaces xicsrt_tpu/ops/fused_grad.py::build_fused_diff, make_kernel(False)
// (K5f) and make_kernel(True) (K5b), for the generic source matrix (K5e:
// boxes, every cone, Focused axes, uniform and Voigt wavelengths, Doppler;
// xrt_sample_source of trace_common.cuh, the sampler K1 runs) and plasmas
// of constant profiles, plane, sphere, cylinder and torus optics, and no
// interaction, a mirror, a Bragg crystal with a gaussian, step or file
// rocking curve (K5c-file: the resampled table read from aux memory, a
// run-time branch on the rocking code in every variant; its adjoint takes
// the table segment's slope), or a mosaic crystal (K5d, in the variants of
// kMosaic: the survival estimator with reservoir picks of
// fused_grad.py:347-363, 1049-1130, and its adjoint, :1281-1400). One
// thread carries one ray; a ray's draws are keyed by (seed, ray,
// draw) as in K1 (trace_common.cuh), so K5b regenerates exactly the rays
// K5f traced.
//
// The differentiated parameters arrive at run time in pvec (24 slots per
// optic: origin, basis rows, radius or radius_major, crystal_spacing,
// rocking_fwhm, reflectivity, radius_minor; then, for a plasma, 8 source
// slots: emissivity, temperature), read once per block into shared memory
// beside the packed structure (grad_head_floats), so a descent loop
// rebuilds nothing. Chains of up to 42 optics, as JAX's. The structure
// (sampler, shapes, bounds, apertures, images) is K1's packed fp/ip
// layout; its geometry entries are unused.
//
// A plasma (source kind 2) is sampled one fresh bundle per ray
// (fused_grad.py:122-276): emissivity scales the ray's initial weight,
// temperature its Doppler width, so each ray has its own wavelength, and
// K5b carries the weight's and the wavelength's adjoints back to the source
// slots. A torus's root is K1's Newton root (xrt_torus_root) found on the
// current parameters; the adjoint differentiates one Newton correction at
// it, the implicit-function derivative (fused_grad.py:819-876, 1562-1629).
// A cylinder's t is differentiated implicitly through its quadratic.
//
// Numerics follow the plain PyTorch twins of ops/fused_grad.py operation by
// operation (_optic_fwd/_optic_bwd, the JAX _trace_fwd/_trace_bwd); the
// library is built with -fmad=false.
//
// K5f: the chain runs in registers; each imaged hit adds its four bilinear
// corners into a block-private shared-memory image (four shared atomics),
// flushed once per block with global atomics. Bounded by arithmetic and the
// shared atomics. On Hopper: launch bounds by variant (FwdCap: 64 registers
// where nothing spills), the block size that keeps the most threads
// resident (beside a large image, fewer and larger blocks sharing it), and
// the corners of zero weight, most of them past a crystal in weight mode,
// are not added, which changes no image bit.
//
// K5b, in two builds, both hand adjoints of the same forward. A mosaic
// crystal's adjoint keeps no per-layer state: the cotangent of layer l's
// probability is cum_b times prod_{j != l} (1 - p_j), so the forward
// carries six sums V <- V (1 - p_l) + prod_{j<l} (1 - p_j) X_l (the Bragg
// chain's per-unit terms X_l: d(d.n_l) times gx_l w_l, gy_l w_l and w_l, d
// sin_b, d sigma, d reflectivity), which the adjoint scales by cum_b; the
// last pick's normal and coefficients, kept by the forward, route the
// direction's adjoint. The cotangent images are staged in shared memory
// where they fit (else read through L1) and gathered at the hit's four
// corners. Each block writes its row of slot sums in float64, summed in a
// fixed order; the host adds the rows in float64.
// - The build that recomputes (fused_grad_bwd_kernel), for short chains:
//   for optic i = n-1 .. 0 the ray's forward is recomputed from the source
//   up to optic i (n(n+1)/2 optic evaluations a ray), so every primal lives
//   in registers; the ray leaving the source, each torus's Newton root and
//   the thread's own column of slot sums (17 terms an optic, added in the
//   ray's order: no shuffles, no atomics) are per-thread rows of shared
//   memory (the flagship's 59 rows).
// - The replay build (fused_grad_replay_kernel, fused_grad_replay.cu), from
//   XRT_K5B_REPLAY_FROM optics: one pass saves each optic's entry state,
//   then each optic is run once more from its own state before its adjoint
//   (2n - 1 optic forwards a ray), as JAX's _trace_bwd consumes the
//   primals its forward kept; the states in shared memory where they fit,
//   else in device memory. A warp's rays step through the chain together,
//   so an optic's 17 terms are summed over the warp in registers and added
//   into the warp's row of slot sums in shared memory (at 42 optics 722
//   floats a warp, where per-thread columns took 739 KB of device memory a
//   block).
// The launcher (bwd_layout) picks the build and keeps the blocks that
// ptxas's registers allow. Bounded by arithmetic: the forwards and the
// adjoint.
#include <cuda_runtime.h>
#include <stdint.h>

#include "binning.cuh"
#include "trace_common.cuh"

#define XRT_GRAD_SLOTS 24
#define XRT_GRAD_USED 17
#define XRT_SRC_SLOTS 8
// K5 takes chains of up to 42 optics, as JAX's does: pvec holds at most
// 1024 slots (xicsrt_tpu/ops/fused_grad.py:1709-1711).
#define XRT_GRAD_MAX_OPTICS 42
#define XRT_GRAD_MAX_SLOTS 1024
// The head of K5's dynamic shared memory: fp and ip, and K5b's pvec
// (n_words), each rounded up to 16 bytes (xrt_round4, so that the compiler
// keeps its 16-byte loads); K5f keeps pvec in static shared memory (in its
// head, ptxas spilled the generic source's variant at its 64 registers).
// The staged images, and K5b's rows, follow it.
__host__ __device__ inline int grad_head_floats(int n_fp, int n_ip, int n_words) {
    return xrt_round4(n_fp) + xrt_round4(n_ip) + xrt_round4(n_words);
}
#define XRT_EPS 1e-12f
#define XRT_SIGMA_PER_FWHM 0.42466090014400953f

namespace {

struct RayState {
    float px, py, pz, dx, dy, dz, w, lam;
    bool alive;
};

// What the temperature slot's adjoint needs of a plasma ray: its standard
// normal, sqrt(T) and Doppler factor.
struct SourceAux {
    float n_g, sqrt_t, dop;
};

// What the adjoint of one optic needs, computed by grad_optic_fwd.
struct OpticLocals {
    float dpx, dpy, dpz;  // direction entering the optic
    float t, qx, qy, qz, nx, ny, nz, lxv, lyv;
    float D;                                   // plane
    float Lx, Ly, Lz, t_ca, t_hc, r, inv_r;    // sphere (r: cylinder too)
    // torus
    float t0s, X, Y, Z, rho, rr, G, Gp, rhop, Dlx, Dly, Dlz, rx, ry, rz;
    float r_maj, Rmj, rmn, ptx, pty, ptz, dy_ax, inv_pl, tux, tuy, tuz, inv_m;
    bool m_int;
    // cylinder
    float dcx, dcy, dcz, d_ax, p_ax, A1x, A1y, A1z, B1x, B1y, B1z, qa, qb;
    float tcx, tcy, tcz, along, inv_u;
    float dot, adot, cosi, sd, prob, w_pre;    // mirror / crystal
    float sin_b, cos_b, d_s, refl, sigma, z;
    float file_val, file_slope;                // file rocking curve
    bool mask, step_in, file_in;
    // mosaic: cum, the six adjoint sums, the last pick's normal, d.n and
    // (gx w, gy w, w), the crystallite basis and its normalisers
    float cum, V[6], pnx, pny, pnz, pdot, pgx, pgy, pwn;
    float o1x, o1y, o1z, o2x, o2y, o2z, inv1, inv2;
    bool picked;
};

__device__ __forceinline__ float sign_of(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Source variants of the kernels: the point-source cut of the generic
// sampler, a plasma of one bundle per ray, the whole generic sampler.
#define XRT_GRAD_POINT 0
#define XRT_GRAD_PLASMA 1
#define XRT_GRAD_GENERIC 2

// The ray leaving the source (ops/fused_grad.py:_source_state): a point
// source of wavelength lam; the generic matrix (JAX fused_grad.py:488-643),
// whose sampling depends on no parameter, with its per-ray wavelength; or a
// plasma of one bundle per ray whose emissivity and temperature are
// P[src_base], P[src_base + 1] (_sample_plasma, JAX fused_grad.py:202-276).
template <int kSource>
__device__ __forceinline__ void grad_sample_source(const float* fp,
                                                   const int* ip,
                                                   const float* P,
                                                   int src_base, float lam,
                                                   Draws& draw, RayState& st,
                                                   SourceAux& aux) {
    if (kSource != XRT_GRAD_PLASMA) {
        float wl;
        bool keep;  // a filtered source is outside the gradient subset
        xrt_sample_source<kSource == XRT_GRAD_GENERIC>(
            fp, ip, draw, st.px, st.py, st.pz, st.dx, st.dy, st.dz, wl, keep);
        st.w = 1.0f;
        st.lam = kSource == XRT_GRAD_GENERIC ? wl : lam;
        return;
    }
    float px = fp[20], py = fp[21], pz = fp[22];
    for (int k = 0; k < 3; ++k) {  // box offsets in the source frame
        if (fp[23 + k] != 0.0f) {
            const float o_l = (draw() - 0.5f) * fp[23 + k];
            px = px + o_l * fp[3 * k];
            py = py + o_l * fp[3 * k + 1];
            pz = pz + o_l * fp[3 * k + 2];
        }
    }
    if (ip[6]) {  // voxel offsets
        for (int k = 0; k < 3; ++k) {
            const float o_l = (draw() - 0.5f) * fp[18];
            px = px + o_l * fp[3 * k];
            py = py + o_l * fp[3 * k + 1];
            pz = pz + o_l * fp[3 * k + 2];
        }
    }
    st.px = px;
    st.py = py;
    st.pz = pz;
    xrt_plasma_cone(fp, fp[26], draw, px, py, pz, st.dx, st.dy, st.dz);
    aux.n_g = xrt_normal(draw);
    aux.sqrt_t = sqrtf(fmaxf(P[src_base + 1], 1e-30f));
    float l = fp[15] + fp[16] * aux.sqrt_t * aux.n_g;
    if (ip[7]) l = l + xrt_cauchy(draw, fp[17]);
    aux.dop = 1.0f - (fp[27] * st.dx + fp[28] * st.dy + fp[29] * st.dz) * fp[19];
    st.lam = l * aux.dop;
    st.w = fp[30] * P[src_base];
}

// The rocking curve of the mosaic crystal whose structure is o, oi and
// whose parameter slots are P at the deviation delta (_rock_fwd,
// fused_grad.py:690-716): the probability and the locals its adjoint needs.
// (The crystal's own branch in grad_optic_fwd keeps these lines inline:
// calling this from there moved ptxas's allocation and cost the torus
// chain's K5f 8 %, chip_ab.py.)
__device__ __forceinline__ float grad_rock(const float* o, const int* oi,
                                          const float* P,
                                          const float* __restrict__ aux,
                                          float delta, float& sigma, float& z,
                                          bool& step_in, float& file_val,
                                          float& file_slope, bool& file_in) {
    const float fwhm = P[14], refl = P[15];
    if (oi[3] == 0) {  // gaussian
        sigma = fmaxf(fwhm * XRT_SIGMA_PER_FWHM, XRT_EPS);
        z = delta / sigma;
        return refl * expf(-0.5f * z * z);
    }
    if (oi[3] != XRT_ROCK_FILE) {  // step: hard edges
        step_in = fabsf(delta) <= fwhm / 2.0f;
        return step_in ? refl : 0.0f;
    }
    // file: the table's value, and its segment's slope in delta (0 on a
    // node: the tent derivative, sign(0) = 0)
    float f, kf, t0, t1;
    file_val = xrt_file_value(aux + oi[XRT_OI_TABLE], oi[XRT_OI_K], o[XRT_O_LO],
                              o[XRT_O_INV_STEP], delta, &file_in, &f, &kf, &t0, &t1);
    file_slope = f == kf ? 0.0f : (t1 - t0) * o[XRT_O_INV_STEP];
    return file_in ? refl * file_val : 0.0f;
}

// The mosaic crystal's weight-mode forward (ops/fused_grad.py:_mosaic_fwd;
// JAX fused_grad.py:1049-1130) and the sums its adjoint needs: the cutoff
// prefilter, the crystallite basis, then oi[XRT_OI_DEPTH] layers of three
// draws each. A dead ray skips its layers and moves its draw index past
// them. Returns the survival estimator's total cum; st's direction becomes
// the last pick's reflection.
__device__ __forceinline__ float grad_mosaic_fwd(const float* o, const int* oi,
                                                const float* P,
                                                const float* __restrict__ aux,
                                                Draws& draw, RayState& st,
                                                bool& mask, OpticLocals& L) {
    const int depth = oi[XRT_OI_DEPTH];
    const int first = draw.next;
    const float d0x = st.dx, d0y = st.dy, d0z = st.dz;
    const float sin_b = L.sin_b, cos_b = L.cos_b;
    if (o[XRT_O_MCUT] >= 0.0f) {  // a hard mask, zero gradient
        const float adot0 = fabsf(d0x * L.nx + d0y * L.ny + d0z * L.nz);
        const float cosi0 = sqrtf(fmaxf(1.0f - adot0 * adot0, XRT_EPS));
        const float sd0 = adot0 * cos_b - cosi0 * sin_b;
        mask = mask && fabsf(sd0 + sd0 * sd0 * sd0 * (1.0f / 6.0f)) < o[XRT_O_MCUT];
    }
    const float o1rx = L.ny, o1ry = L.nz - L.nx, o1rz = -L.ny;
    L.inv1 = inv_sqrt(fmaxf(o1rx * o1rx + o1ry * o1ry + o1rz * o1rz, 1e-30f));
    L.o1x = o1rx * L.inv1;
    L.o1y = o1ry * L.inv1;
    L.o1z = o1rz * L.inv1;
    const float o2rx = L.ny * L.o1z - L.nz * L.o1y;
    const float o2ry = L.nz * L.o1x - L.nx * L.o1z;
    const float o2rz = L.nx * L.o1y - L.ny * L.o1x;
    L.inv2 = inv_sqrt(fmaxf(o2rx * o2rx + o2ry * o2ry + o2rz * o2rz, 1e-30f));
    L.o2x = o2rx * L.inv2;
    L.o2y = o2ry * L.inv2;
    L.o2z = o2rz * L.inv2;
    float surv = 1.0f, cum = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) L.V[k] = 0.0f;
    L.pnx = L.pny = L.pnz = L.pdot = L.pgx = L.pgy = L.pwn = 0.0f;
    L.picked = false;
    const float sigma_n = o[XRT_O_MSIGMA];
    for (int l = 0; mask && l < depth; ++l) {
        const float gx = sigma_n * xrt_normal(draw);
        const float gy = sigma_n * xrt_normal(draw);
        const float wn = inv_sqrt(1.0f + gx * gx + gy * gy);
        const float gxw = gx * wn, gyw = gy * wn;
        const float nmx = gxw * L.o2x + gyw * L.o1x + wn * L.nx;
        const float nmy = gxw * L.o2y + gyw * L.o1y + wn * L.ny;
        const float nmz = gxw * L.o2z + gyw * L.o1z + wn * L.nz;
        const float dotm = d0x * nmx + d0y * nmy + d0z * nmz;
        const float adot = fabsf(dotm);
        const float cosi = sqrtf(fmaxf(1.0f - adot * adot, XRT_EPS));
        const float sd = adot * cos_b - cosi * sin_b;
        const float delta = sd + sd * sd * sd * (1.0f / 6.0f);
        float sigma = 0.0f, z = 0.0f, file_val = 0.0f, file_slope = 0.0f;
        bool step_in = false, file_in = false;
        const float prob =
            grad_rock(o, oi, P, aux, delta, sigma, z, step_in, file_val, file_slope, file_in);
        const float q = prob * surv;
        const float cum_new = cum + q;
        const bool pick = draw() * cum_new < q;
        if (pick) {
            const float kk = 2.0f * dotm;
            st.dx = d0x - kk * nmx;
            st.dy = d0y - kk * nmy;
            st.dz = d0z - kk * nmz;
            L.pnx = nmx;
            L.pny = nmy;
            L.pnz = nmz;
            L.pdot = dotm;
            L.pgx = gxw;
            L.pgy = gyw;
            L.pwn = wn;
            L.picked = true;
        }
        // The adjoint's per-unit terms of this layer's probability.
        float delta_u, sig_u, refl_u;
        if (oi[3] == 0) {
            delta_u = prob * (-z / sigma);
            sig_u = prob * (z * z / sigma);
            refl_u = prob / fmaxf(P[15], XRT_EPS);
        } else if (oi[3] != XRT_ROCK_FILE) {
            delta_u = 0.0f;
            sig_u = 0.0f;
            refl_u = step_in ? 1.0f : 0.0f;
        } else {
            const float inf_ = file_in ? 1.0f : 0.0f;
            delta_u = P[15] * file_slope * inf_;
            sig_u = 0.0f;
            refl_u = file_val * inf_;
        }
        const float sd_u = delta_u * (1.0f + 0.5f * sd * sd);
        const float adot_u = sd_u * (cos_b + adot / cosi * sin_b);
        const float sinb_u = sd_u * (-adot * sin_b / cos_b - cosi);
        const float dot_u = sign_of(dotm) * adot_u;
        const float keep = 1.0f - prob;
        L.V[0] = L.V[0] * keep + surv * (gxw * dot_u);
        L.V[1] = L.V[1] * keep + surv * (gyw * dot_u);
        L.V[2] = L.V[2] * keep + surv * (wn * dot_u);
        L.V[3] = L.V[3] * keep + surv * sinb_u;
        L.V[4] = L.V[4] * keep + surv * sig_u;
        L.V[5] = L.V[5] * keep + surv * refl_u;
        surv = surv * keep;
        cum = cum_new;
    }
    draw.next = first + 3 * depth;
    return cum;
}

// Weight-mode forward of one optic (ops/fused_grad.py:_optic_fwd).
// o, oi: the optic's packed structure; P: its 24 parameter slots. kTorus,
// kCylinder, kMosaic: whether the chain holds such shapes or a mosaic
// crystal (a chain of planes and spheres with crystals compiles without
// their code and registers). draw: the ray's draws, a mosaic's three per
// layer. kRootCache (K5b only): a torus's Newton root and last step live at
// root[0] and root[root_stride]; root_read takes them from there, else they
// are found and stored. The ray enters the optic in the same state in every
// pass of K5b, so the cached root is the one it would find again.
template <bool kTorus, bool kCylinder, bool kMosaic, bool kRootCache = false>
__device__ __forceinline__ void grad_optic_fwd(const float* o, const int* oi,
                                               const float* P,
                                               const float* apf,
                                               const int* api,
                                               const float* __restrict__ aux,
                                               Draws& draw, RayState& st,
                                               OpticLocals& L,
                                               float* root = nullptr,
                                               int root_stride = 0,
                                               bool root_read = false) {
    const float ox = P[0], oy = P[1], oz = P[2];
    const float bxx = P[3], bxy = P[4], bxz = P[5];
    const float byx = P[6], byy = P[7], byz = P[8];
    const float bzx = P[9], bzy = P[10], bzz = P[11];
    L.dpx = st.dx;
    L.dpy = st.dy;
    L.dpz = st.dz;
    bool mask;
    float Cx = 0.0f, Cy = 0.0f, Cz = 0.0f;
    const int shape = oi[0];
    if (shape == 0) {  // plane
        bool nonzero;
        L.t = xrt_plane_hit(ox, oy, oz, bzx, bzy, bzz, st.px, st.py, st.pz,
                            st.dx, st.dy, st.dz, &L.D, &nonzero);
        mask = st.alive && L.t >= 0.0f;
    } else if (shape == 1) {  // sphere, center o + sign r bz
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
    } else if (kTorus && shape == 2) {  // torus of axis by, center o + cs R bz
        L.Rmj = P[12];
        L.rmn = P[16];
        L.r_maj = L.Rmj + o[XRT_O_MADJ] * L.rmn;
        const float cs = o[XRT_O_CSIGN];
        Cx = ox + cs * L.Rmj * bzx;
        Cy = oy + cs * L.Rmj * bzy;
        Cz = oz + cs * L.Rmj * bzz;
        L.rx = st.px - Cx;
        L.ry = st.py - Cy;
        L.rz = st.pz - Cz;
        const float Olx = L.rx * bxx + L.ry * bxy + L.rz * bxz;
        const float Oly = L.rx * byx + L.ry * byy + L.rz * byz;
        const float Olz = L.rx * bzx + L.ry * bzy + L.rz * bzz;
        L.Dlx = st.dx * bxx + st.dy * bxy + st.dz * bxz;
        L.Dly = st.dx * byx + st.dy * byy + st.dz * byz;
        L.Dlz = st.dx * bzx + st.dy * bzy + st.dz * bzz;
        // K1's Newton root; the adjoint differentiates one Newton
        // correction at it (fused_grad.py:819-876).
        const float z0 = (st.px - ox) * bzx + (st.py - oy) * bzy + (st.pz - oz) * bzz;
        float step, t0;
        if (kRootCache && root_read) {
            t0 = root[0];
            step = root[root_stride];
        } else {
            t0 = xrt_torus_root(Olx, Oly, Olz, L.Dlx, L.Dly, L.Dlz, z0, L.r_maj,
                                L.rmn * L.rmn, &step);
            if (kRootCache) {
                root[0] = t0;
                root[root_stride] = step;
            }
        }
        L.m_int = fabsf(step) < 1e-5f * fmaxf(L.r_maj, 1.0f) && t0 > 1e-6f &&
                  t0 < 1e6f;
        mask = st.alive && L.m_int;
        L.t0s = L.m_int ? t0 : 0.0f;
        L.X = Olx + L.t0s * L.Dlx;
        L.Y = Oly + L.t0s * L.Dly;
        L.Z = Olz + L.t0s * L.Dlz;
        L.rho = sqrtf(fmaxf(L.X * L.X + L.Z * L.Z, 1e-30f));
        L.rr = L.rho - L.r_maj;
        L.G = L.rr * L.rr + L.Y * L.Y - L.rmn * L.rmn;
        L.rhop = (L.X * L.Dlx + L.Z * L.Dlz) / L.rho;
        const float Gp = 2.0f * L.rr * L.rhop + 2.0f * L.Y * L.Dly;
        L.Gp = fabsf(Gp) > 1e-9f ? Gp : (Gp >= 0.0f ? 1e-9f : -1e-9f);
        L.t = L.m_int ? L.t0s - L.G / L.Gp : 0.0f;
    } else if (kCylinder && shape == 3) {  // cylinder of axis bx, center o + sign r bz
        L.r = P[12];
        const float sign = oi[1] ? -1.0f : 1.0f;
        Cx = ox + sign * L.r * bzx;
        Cy = oy + sign * L.r * bzy;
        Cz = oz + sign * L.r * bzz;
        const CylinderHit h = xrt_cylinder_hit(Cx, Cy, Cz, bxx, bxy, bxz,
                                               L.r * L.r, oi[1] != 0, st.px,
                                               st.py, st.pz, st.dx, st.dy,
                                               st.dz);
        mask = st.alive && h.disc >= 0.0f;
        L.t = h.t;
        L.dcx = h.dpx;
        L.dcy = h.dpy;
        L.dcz = h.dpz;
        L.d_ax = h.d_ax;
        L.p_ax = h.p_ax;
        L.A1x = h.A1x;
        L.A1y = h.A1y;
        L.A1z = h.A1z;
        L.B1x = h.B1x;
        L.B1y = h.B1y;
        L.B1z = h.B1z;
        L.qa = h.qa;
        L.qb = h.qb;
    } else {  // a shape the variant was not built for: no hit
        L.t = 0.0f;
        mask = false;
    }
    L.qx = st.px + L.t * st.dx;
    L.qy = st.py + L.t * st.dy;
    L.qz = st.pz + L.t * st.dz;
    if (shape == 0) {
        L.nx = bzx;
        L.ny = bzy;
        L.nz = bzz;
    } else if (shape == 1) {  // toward the center for both convexities
        L.inv_r = 1.0f / fmaxf(L.r, XRT_EPS);
        L.nx = (Cx - L.qx) * L.inv_r;
        L.ny = (Cy - L.qy) * L.inv_r;
        L.nz = (Cz - L.qz) * L.inv_r;
    } else if (kTorus && shape == 2) {  // from the tube centre
        L.ptx = L.qx - Cx;
        L.pty = L.qy - Cy;
        L.ptz = L.qz - Cz;
        L.dy_ax = L.ptx * byx + L.pty * byy + L.ptz * byz;
        const float plx = L.ptx - L.dy_ax * byx;
        const float ply = L.pty - L.dy_ax * byy;
        const float plz = L.ptz - L.dy_ax * byz;
        L.inv_pl = inv_sqrt(fmaxf(plx * plx + ply * ply + plz * plz, 1e-30f));
        L.tux = plx * L.inv_pl;
        L.tuy = ply * L.inv_pl;
        L.tuz = plz * L.inv_pl;
        const float tmx = L.ptx - L.r_maj * L.tux;
        const float tmy = L.pty - L.r_maj * L.tuy;
        const float tmz = L.ptz - L.r_maj * L.tuz;
        L.inv_m = inv_sqrt(fmaxf(tmx * tmx + tmy * tmy + tmz * tmz, 1e-30f));
        L.nx = tmx * L.inv_m;
        L.ny = tmy * L.inv_m;
        L.nz = tmz * L.inv_m;
    } else if (kCylinder && shape == 3) {  // toward the axis
        L.tcx = Cx - L.qx;
        L.tcy = Cy - L.qy;
        L.tcz = Cz - L.qz;
        L.along = L.tcx * bxx + L.tcy * bxy + L.tcz * bxz;
        const float ux = L.tcx - L.along * bxx;
        const float uy = L.tcy - L.along * bxy;
        const float uz = L.tcz - L.along * bxz;
        L.inv_u = inv_sqrt(fmaxf(ux * ux + uy * uy + uz * uz, 1e-30f));
        L.nx = ux * L.inv_u;
        L.ny = uy * L.inv_u;
        L.nz = uz * L.inv_u;
    } else {
        L.nx = L.ny = L.nz = 0.0f;
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
    if (oi[2] == 1) {  // crystal, at the ray's wavelength
        L.d_s = P[13];
        const float fwhm = P[14];
        L.refl = P[15];
        L.sin_b = fminf(fmaxf(st.lam / (2.0f * fmaxf(L.d_s, XRT_EPS)), 0.0f),
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
        } else if (oi[3] != XRT_ROCK_FILE) {  // step: hard edges
            L.step_in = fabsf(delta) <= fwhm / 2.0f;
            L.prob = L.step_in ? L.refl : 0.0f;
        } else {  // file: the table's value, and its segment's slope in delta
                  // (0 on a node: the tent derivative, sign(0) = 0)
            float f, kf, t0, t1;
            L.file_val = xrt_file_value(aux + oi[XRT_OI_TABLE], oi[XRT_OI_K],
                                        o[XRT_O_LO], o[XRT_O_INV_STEP], delta,
                                        &L.file_in, &f, &kf, &t0, &t1);
            L.file_slope = f == kf ? 0.0f : (t1 - t0) * o[XRT_O_INV_STEP];
            L.prob = L.file_in ? L.refl * L.file_val : 0.0f;
        }
        L.w_pre = st.w;
        if (mask) st.w = st.w * L.prob;
    } else if (kMosaic && oi[2] == XRT_INTERACT_MOSAIC) {  // at the ray's wavelength
        L.d_s = P[13];
        L.sin_b = fminf(fmaxf(st.lam / (2.0f * fmaxf(L.d_s, XRT_EPS)), 0.0f),
                        1.0f);
        L.cos_b = sqrtf(fmaxf(1.0f - L.sin_b * L.sin_b, XRT_EPS));
        L.w_pre = st.w;
        L.cum = grad_mosaic_fwd(o, oi, P, aux, draw, st, mask, L);
        if (mask) st.w = st.w * L.cum;
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

// K5f's body. One thread carries one ray through the grid-stride loop, every
// ray through the whole chain (a ray that left the loop once it died or
// weighed zero made K5f 1.3-1.7x slower, chip_ab.py, likely because the
// lanes that left ran on to their next ray apart from the rest of their
// warp). A corner whose weight is zero, as most are past a crystal in
// weight mode, is not added: +-0 added to a pixel changes no bit.
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
__device__ __forceinline__ void fused_grad_fwd_body(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip,
    int n_ip, const float* __restrict__ aux, const float* __restrict__ g_pvec,
    int n_slots, long long n_total, float lam, const float* __restrict__ uniforms,
    uint32_t seed0, uint32_t seed1, float* __restrict__ images,
    int img_total, int use_smem) {
    // pvec, and the head of the dynamic shared memory (grad_head_floats):
    // fp and ip, sized by the run; the staged image follows.
    __shared__ __align__(16) float P[XRT_GRAD_MAX_SLOTS];
    extern __shared__ __align__(16) float s_dyn[];
    float* const fp = s_dyn;
    int* const ip = reinterpret_cast<int*>(s_dyn + xrt_round4(n_fp));
    float* const s_img = s_dyn + grad_head_floats(n_fp, n_ip, 0);

    xrt_head_load(fp, g_fp, n_fp, ip, g_ip, n_ip, nullptr, 0);
    for (int i = threadIdx.x; i < n_slots; i += blockDim.x) P[i] = g_pvec[i];
    if (use_smem) xrt_smem_zero(s_img, img_total);
    __syncthreads();

    float* img = use_smem ? s_img : images;
    const int n_opt = ip[0];
    const int src_base = n_opt * XRT_GRAD_SLOTS;
    const float* apf = fp + XRT_SRC_F + n_opt * XRT_OPT_F;
    const int* api = ip + XRT_HDR_I + n_opt * XRT_OPT_I;
    const long long stride = (long long)gridDim.x * blockDim.x;

    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r < n_total; r += stride) {
        Draws draw{uniforms, n_total, r, seed0, seed1, 0, -1, {0u, 0u, 0u, 0u}};
        RayState st;
        SourceAux src_aux;
        grad_sample_source<kSource>(fp, ip, P, src_base, lam, draw, st, src_aux);
        st.alive = true;
        for (int e = 0; e < n_opt; ++e) {
            const float* o = fp + XRT_SRC_F + e * XRT_OPT_F;
            const int* oi = ip + XRT_HDR_I + e * XRT_OPT_I;
            OpticLocals L;
            grad_optic_fwd<kTorus, kCylinder, kMosaic>(o, oi, P + e * XRT_GRAD_SLOTS,
                                                       apf, api, aux, draw, st, L);
            if (oi[7] >= 0 && L.mask) {
                const int nx = oi[8], ny = oi[9];
                const Corners cx = corners(L.lxv * o[23] + o[24], nx);
                const Corners cy = corners(L.lyv * o[23] + o[25], ny);
                const float w = st.w;
                float* base = img + oi[7];
                for (int a = 0; a < 2; ++a) {
                    const int ix = cx.i0 + a;
                    const float wx = w * (a ? cx.t1 : cx.t0);
                    if (ix < 0 || ix >= nx || wx == 0.0f) continue;
                    for (int b = 0; b < 2; ++b) {
                        const int iy = cy.i0 + b;
                        const float v = wx * (b ? cy.t1 : cy.t0);
                        if (iy < 0 || iy >= ny || v == 0.0f) continue;
                        atomicAdd(base + ix * ny + iy, v);
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

// K5f's launch bounds by variant, from ptxas's report (chip_smoke.py phase 2)
// and chip_ab.py. Left to ptxas, the variants without a torus took 64-91
// registers; held to 64 (bounds of 1024 threads, so the launcher may also
// take larger blocks, fwd_threads) the flagship, cylinder and plasma chains
// ran 3-6 % faster and the point-source mosaic 15 %. At 64, ptxas spills in
// the plasma and generic mosaics, the generic source with a cylinder, and
// several torus variants; and the torus chain ran 6 % slower held to 64
// (62 registers) than left to ptxas (64). So the variants without a torus
// that do not spill there are held to 64, the rest take no bounds.
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
struct FwdCap {
    static constexpr bool value =
        !kTorus && (kSource == XRT_GRAD_POINT ||
                    (!kMosaic && !(kSource == XRT_GRAD_GENERIC && kCylinder)));
};

template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
__global__ void fused_grad_fwd_kernel(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip,
    int n_ip, const float* __restrict__ aux, const float* __restrict__ g_pvec,
    int n_slots, long long n_total, float lam, const float* __restrict__ uniforms,
    uint32_t seed0, uint32_t seed1, float* __restrict__ images,
    int img_total, int use_smem) {
    fused_grad_fwd_body<kTorus, kCylinder, kSource, kMosaic>(
        g_fp, n_fp, g_ip, n_ip, aux, g_pvec, n_slots, n_total, lam, uniforms, seed0,
        seed1, images, img_total, use_smem);
}

template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
__global__ void __launch_bounds__(1024, 1) fused_grad_fwd_kernel_64(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip,
    int n_ip, const float* __restrict__ aux, const float* __restrict__ g_pvec,
    int n_slots, long long n_total, float lam, const float* __restrict__ uniforms,
    uint32_t seed0, uint32_t seed1, float* __restrict__ images,
    int img_total, int use_smem) {
    fused_grad_fwd_body<kTorus, kCylinder, kSource, kMosaic>(
        g_fp, n_fp, g_ip, n_ip, aux, g_pvec, n_slots, n_total, lam, uniforms, seed0,
        seed1, images, img_total, use_smem);
}

// K5b's per-thread rows of the build that recomputes (fused_grad_bwd_kernel),
// one float a thread in shared memory: the slot sums (17 an optic, then a
// plasma's 2), the ray leaving the source (position, direction, weight,
// wavelength, then a plasma's n_g, sqrt(T) and Doppler factor), and a
// torus chain's cached roots (root and last step an optic).
__host__ __device__ inline int bwd_slot_rows(int n_opt, bool plasma) {
    return n_opt * XRT_GRAD_USED + (plasma ? 2 : 0);
}

__host__ __device__ inline int bwd_ray_rows(bool plasma) { return plasma ? 11 : 8; }

__host__ __device__ inline int bwd_rows(int n_opt, bool plasma, bool torus) {
    return bwd_slot_rows(n_opt, plasma) + bwd_ray_rows(plasma) + (torus ? 2 * n_opt : 0);
}

// The replay build's rows (fused_grad_replay_kernel): a thread saves every
// optic's entry state, XRT_STATE_ROWS floats each (position, direction,
// weight; the wavelength is the ray's, and whether the ray is alive follows
// from the first optic that lost it), and in a torus chain the optic's
// Newton root and last step beside it.
#define XRT_STATE_ROWS 7
__host__ __device__ inline int replay_state_rows(int n_opt, bool torus) {
    return (XRT_STATE_ROWS + (torus ? 2 : 0)) * n_opt;
}

// The row of the slot sums that slot s of pvec sums into, or -1 for a slot
// K5b leaves at zero: optic e's first 17 slots, then a plasma's emissivity
// and temperature.
template <int kSource>
__device__ __forceinline__ int slot_row(int s, int n_opt) {
    const int src_base = n_opt * XRT_GRAD_SLOTS;
    if (s < src_base) return s % XRT_GRAD_SLOTS < XRT_GRAD_USED
                                 ? (s / XRT_GRAD_SLOTS) * XRT_GRAD_USED + s % XRT_GRAD_SLOTS
                                 : -1;
    if (kSource == XRT_GRAD_PLASMA && s < src_base + 2) {
        return n_opt * XRT_GRAD_USED + (s - src_base);
    }
    return -1;
}

// K5b's block size and launch bounds by variant, from ptxas's report (phase 2
// of chip_smoke.py prints it). The variants that fit 128 registers without
// spilling (100-127 on sm_90a) run two blocks of 256 threads, 16 warps, a
// multiprocessor: the point source with at most one kind of curved optic,
// a plasma without a torus, the generic source with neither. The others
// (129-199 registers) run blocks of 128 threads with no register cap, 8-12
// warps, where a 256-thread block would leave 8. The torus chain's adjoint
// fits 128 registers only with its ray and roots in shared memory; left
// to itself, ptxas gives it more and the time grows 1.7x. The replay build
// takes the same threads a block.
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
struct BwdLaunch {
    static constexpr bool kPinned =
        !kMosaic && !(kTorus && kCylinder) &&
        (kSource == XRT_GRAD_POINT || (kSource == XRT_GRAD_PLASMA && !kTorus) ||
         (kSource == XRT_GRAD_GENERIC && !kTorus && !kCylinder));
    static constexpr int kThreads = kPinned ? 256 : 128;
    static constexpr int kMinBlocks = kPinned ? 2 : 1;
};

// The replay build's launch bounds: BwdLaunch's, but it keeps an optic's 17
// slot terms in registers through the adjoint, and held to 128 registers
// the point source's torus variant and the plasma's cylinder variant
// spilled (ptxas, chip_smoke.py phase 2); those two take no register cap.
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
struct ReplayLaunch {
    using Bwd = BwdLaunch<kTorus, kCylinder, kSource, kMosaic>;
    static constexpr int kThreads = Bwd::kThreads;
    static constexpr int kMinBlocks =
        (kTorus && kSource == XRT_GRAD_POINT) || (kCylinder && kSource == XRT_GRAD_PLASMA)
            ? 1
            : Bwd::kMinBlocks;
};

// The adjoints of the position, direction and weight of a ray and of its
// wavelength, carried from the optic after to the optic before.
struct Carry {
    float pbx, pby, pbz, dbx, dby, dbz, wb, lamb;
};

// The draws optic oi takes: a mosaic crystal's three a layer, else none
// (grad_mosaic_fwd moves the cursor past its layers, live or dead).
template <bool kMosaic>
__device__ __forceinline__ int optic_draws(const int* oi) {
    return kMosaic && oi[2] == XRT_INTERACT_MOSAIC ? 3 * oi[XRT_OI_DEPTH] : 0;
}

// Where grad_optic_bwd's slot terms go: the thread's column of slot sums
// (the recomputing build: row k of col, stride floats apart), or the
// optic's 17 sums in registers (the replay build; acc is indexed with
// constants only, after inlining).
struct SlotColumn {
    float* col;
    int stride;
    __device__ __forceinline__ void operator()(int k, float v) const { col[k * stride] += v; }
};
struct SlotRegisters {
    float* acc;
    __device__ __forceinline__ void operator()(int k, float v) const { acc[k] += v; }
};

// A replay build's saved entry state (XRT_STATE_ROWS rows, stride floats
// apart), and the state it restores with the ray's wavelength and alive.
__device__ __forceinline__ void save_state(float* at, int stride, const RayState& s) {
    at[0] = s.px;
    at[stride] = s.py;
    at[2 * stride] = s.pz;
    at[3 * stride] = s.dx;
    at[4 * stride] = s.dy;
    at[5 * stride] = s.dz;
    at[6 * stride] = s.w;
}
__device__ __forceinline__ RayState load_state(const float* at, int stride, float lam,
                                               bool alive) {
    return RayState{at[0],          at[stride],     at[2 * stride], at[3 * stride],
                    at[4 * stride], at[5 * stride], at[6 * stride], lam, alive};
}

// The hand adjoint of one optic (ops/fused_grad.py:_optic_bwd; JAX
// _trace_bwd, fused_grad.py:1161-1670): o, oi, Pi the optic's packed
// structure and parameter slots, L the locals of its forward, st the ray
// leaving it (its weight and wavelength), gimg the cotangent images; c goes
// from the adjoints leaving the optic to those entering it, and slot(k, v)
// takes this ray's term v of the optic's slot k.
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic, class Slot>
__device__ __forceinline__ void grad_optic_bwd(const float* o, const int* oi,
                                               const float* Pi, const OpticLocals& L,
                                               const RayState& st, const float* gimg,
                                               Carry& c, Slot slot) {
    float pbx = c.pbx, pby = c.pby, pbz = c.pbz;
    float dbx = c.dbx, dby = c.dby, dbz = c.dbz;
    float wb = c.wb, lamb = c.lamb;
    const float bxx = Pi[3], bxy = Pi[4], bxz = Pi[5];
    const float byx = Pi[6], byy = Pi[7], byz = Pi[8];
    const float bzx = Pi[9], bzy = Pi[10], bzz = Pi[11];
    const float mf = L.mask ? 1.0f : 0.0f;
    const bool mask = L.mask;
    const int shape = oi[0];

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
    if (kMosaic && oi[2] == XRT_INTERACT_MOSAIC) {
        // w_post = where(mask, w_pre cum, w_pre); the forward's sums
        // scaled by cum's cotangent (ops/fused_grad.py:_mosaic_bwd).
        const float cum_b = mask ? wb * L.w_pre : 0.0f;
        wb = mask ? wb * L.cum : wb;
        const float A2 = cum_b * L.V[0], A1 = cum_b * L.V[1];
        const float An = cum_b * L.V[2], sinb_b = cum_b * L.V[3];
        slot(14, cum_b * L.V[4] * XRT_SIGMA_PER_FWHM);
        slot(15, cum_b * L.V[5]);
        // The direction's adjoint goes to the last pick's reflection.
        const float pf = L.picked ? 1.0f : 0.0f;
        const float av = dbx * L.pnx + dby * L.pny + dbz * L.pnz;
        const float pnbx = -2.0f * pf * (av * d0x + L.pdot * dbx);
        const float pnby = -2.0f * pf * (av * d0y + L.pdot * dby);
        const float pnbz = -2.0f * pf * (av * d0z + L.pdot * dbz);
        const float d0bx =
            dbx - 2.0f * pf * av * L.pnx + A2 * L.o2x + A1 * L.o1x + An * L.nx;
        const float d0by =
            dby - 2.0f * pf * av * L.pny + A2 * L.o2y + A1 * L.o1y + An * L.ny;
        const float d0bz =
            dbz - 2.0f * pf * av * L.pnz + A2 * L.o2z + A1 * L.o1z + An * L.nz;
        // nm_l = gx_l w_l o2 + gy_l w_l o1 + w_l n.
        float o2bx = A2 * d0x + L.pgx * pnbx, o2by = A2 * d0y + L.pgx * pnby,
              o2bz = A2 * d0z + L.pgx * pnbz;
        float o1bx = A1 * d0x + L.pgy * pnbx, o1by = A1 * d0y + L.pgy * pnby,
              o1bz = A1 * d0z + L.pgy * pnbz;
        nbx = An * d0x + L.pwn * pnbx;
        nby = An * d0y + L.pwn * pnby;
        nbz = An * d0z + L.pwn * pnbz;
        // o2 = normalize(n x o1).
        const float o2d = L.o2x * o2bx + L.o2y * o2by + L.o2z * o2bz;
        const float o2rbx = L.inv2 * (o2bx - L.o2x * o2d);
        const float o2rby = L.inv2 * (o2by - L.o2y * o2d);
        const float o2rbz = L.inv2 * (o2bz - L.o2z * o2d);
        nbx = nbx + (L.o1y * o2rbz - L.o1z * o2rby);
        nby = nby + (L.o1z * o2rbx - L.o1x * o2rbz);
        nbz = nbz + (L.o1x * o2rby - L.o1y * o2rbx);
        o1bx = o1bx + (o2rby * L.nz - o2rbz * L.ny);
        o1by = o1by + (o2rbz * L.nx - o2rbx * L.nz);
        o1bz = o1bz + (o2rbx * L.ny - o2rby * L.nx);
        // o1 = normalize(ny, nz - nx, -ny).
        const float o1d = L.o1x * o1bx + L.o1y * o1by + L.o1z * o1bz;
        const float o1rbx = L.inv1 * (o1bx - L.o1x * o1d);
        const float o1rby = L.inv1 * (o1by - L.o1y * o1d);
        const float o1rbz = L.inv1 * (o1bz - L.o1z * o1d);
        nbx = nbx - o1rby;
        nby = nby + o1rbx - o1rbz;
        nbz = nbz + o1rby;
        const float ds_b =
            sinb_b * (-st.lam / (2.0f * fmaxf(L.d_s * L.d_s, XRT_EPS)));
        const bool inr = L.sin_b > 0.0f && L.sin_b < 1.0f;
        slot(13, (inr ? ds_b : 0.0f) * mf);
        if (kSource == XRT_GRAD_PLASMA) {
            lamb = lamb + (inr ? sinb_b / (2.0f * fmaxf(L.d_s, XRT_EPS)) : 0.0f) * mf;
        }
        dbx = d0bx;
        dby = d0by;
        dbz = d0bz;
    }
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
                slot(14, sigma_b * mf * XRT_SIGMA_PER_FWHM);
            } else if (oi[3] != XRT_ROCK_FILE) {
                refl_b = prob_b * (L.step_in ? 1.0f : 0.0f);
                delta_b = 0.0f;
            } else {  // fused_grad.py:739-742
                const float inf_ = L.file_in ? 1.0f : 0.0f;
                refl_b = prob_b * L.file_val * inf_;
                delta_b = prob_b * L.refl * L.file_slope * inf_;
            }
            slot(15, refl_b * mf);
            const float sd = L.sd;
            const float sd_b = delta_b * (1.0f + 0.5f * sd * sd);
            const float adot_b =
                sd_b * (L.cos_b + L.adot / L.cosi * L.sin_b);
            const float sinb_b =
                sd_b * (-L.adot * L.sin_b / L.cos_b - L.cosi);
            const float ds_b =
                sinb_b * (-st.lam / (2.0f * fmaxf(L.d_s * L.d_s, XRT_EPS)));
            const bool inr = L.sin_b > 0.0f && L.sin_b < 1.0f;
            slot(13, (inr ? ds_b : 0.0f) * mf);
            // sin_b = lam / (2 d): the wavelength's adjoint, which a
            // plasma carries to its temperature slot.
            if (kSource == XRT_GRAD_PLASMA) {
                lamb = lamb + (inr ? sinb_b / (2.0f * fmaxf(L.d_s, XRT_EPS))
                                   : 0.0f) * mf;
            }
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
    slot(0, -(lxb * bxx + lyb * byx));
    slot(1, -(lxb * bxy + lyb * byy));
    slot(2, -(lxb * bxz + lyb * byz));
    slot(3, lxb * rxq);
    slot(4, lxb * ryq);
    slot(5, lxb * rzq);
    slot(6, lyb * rxq);
    slot(7, lyb * ryq);
    slot(8, lyb * rzq);

    // ---- normal ------------------------------------------------
    float Cbx = 0.0f, Cby = 0.0f, Cbz = 0.0f, r_b_n = 0.0f;
    float axbx = 0.0f, axby = 0.0f, axbz = 0.0f;  // cylinder axis bx
    if (shape == 0) {  // n = bz
        slot(9, nbx);
        slot(10, nby);
        slot(11, nbz);
    } else if (shape == 1) {  // n = (C - q) / r
        Cbx = L.inv_r * nbx;
        Cby = L.inv_r * nby;
        Cbz = L.inv_r * nbz;
        qbx = qbx - Cbx;
        qby = qby - Cby;
        qbz = qbz - Cbz;
        const float ndot = L.nx * nbx + L.ny * nby + L.nz * nbz;
        r_b_n = -ndot * L.inv_r * L.r * L.inv_r;
    } else if (kTorus && shape == 2) {  // n = normalize(pt - r_maj u)
        const float ndot = L.nx * nbx + L.ny * nby + L.nz * nbz;
        const float mbx = L.inv_m * (nbx - L.nx * ndot);
        const float mby = L.inv_m * (nby - L.ny * ndot);
        const float mbz = L.inv_m * (nbz - L.nz * ndot);
        float ptbx = mbx, ptby = mby, ptbz = mbz;
        const float ubx = -L.r_maj * mbx;
        const float uby = -L.r_maj * mby;
        const float ubz = -L.r_maj * mbz;
        r_b_n = -(mbx * L.tux + mby * L.tuy + mbz * L.tuz);
        const float udot = L.tux * ubx + L.tuy * uby + L.tuz * ubz;
        const float plbx = L.inv_pl * (ubx - L.tux * udot);
        const float plby = L.inv_pl * (uby - L.tuy * udot);
        const float plbz = L.inv_pl * (ubz - L.tuz * udot);
        ptbx = ptbx + plbx;
        ptby = ptby + plby;
        ptbz = ptbz + plbz;
        const float dyax_b = -(plbx * byx + plby * byy + plbz * byz);
        slot(6, -L.dy_ax * plbx + dyax_b * L.ptx);
        slot(7, -L.dy_ax * plby + dyax_b * L.pty);
        slot(8, -L.dy_ax * plbz + dyax_b * L.ptz);
        ptbx = ptbx + dyax_b * byx;
        ptby = ptby + dyax_b * byy;
        ptbz = ptbz + dyax_b * byz;
        qbx = qbx + ptbx;
        qby = qby + ptby;
        qbz = qbz + ptbz;
        Cbx = -ptbx;
        Cby = -ptby;
        Cbz = -ptbz;
    } else if (kCylinder && shape == 3) {
        // n = normalize(u), u = tc - (tc . bx) bx, tc = C - q
        const float ndot = L.nx * nbx + L.ny * nby + L.nz * nbz;
        const float ubx = L.inv_u * (nbx - L.nx * ndot);
        const float uby = L.inv_u * (nby - L.ny * ndot);
        const float ubz = L.inv_u * (nbz - L.nz * ndot);
        const float au = ubx * bxx + uby * bxy + ubz * bxz;
        Cbx = ubx - au * bxx;
        Cby = uby - au * bxy;
        Cbz = ubz - au * bxz;
        axbx = axbx - au * L.tcx - L.along * ubx;
        axby = axby - au * L.tcy - L.along * uby;
        axbz = axbz - au * L.tcz - L.along * ubz;
        qbx = qbx - Cbx;
        qby = qby - Cby;
        qbz = qbz - Cbz;
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
    const float sign_c = oi[1] ? -1.0f : 1.0f;
    float r_b = 0.0f;
    if (shape == 0) {  // t = ((o - p) . bz) / (d . bz)
        const float invD = 1.0f / L.D;
        pbx = pbx - t_b * bzx * invD;
        pby = pby - t_b * bzy * invD;
        pbz = pbz - t_b * bzz * invD;
        dbx = dbx - t_b * t * bzx * invD;
        dby = dby - t_b * t * bzy * invD;
        dbz = dbz - t_b * t * bzz * invD;
        slot(0, t_b * bzx * invD);
        slot(1, t_b * bzy * invD);
        slot(2, t_b * bzz * invD);
        slot(9, t_b * (Pi[0] - L.qx) * invD);
        slot(10, t_b * (Pi[1] - L.qy) * invD);
        slot(11, t_b * (Pi[2] - L.qz) * invD);
    } else if (shape == 1) {  // t = t_ca -+ t_hc, L = C - p
        const float t_hc = fmaxf(L.t_hc, 1e-6f);
        const float t_ca = L.t_ca;
        const float cx = d0x + sign_c * (t_ca * d0x - L.Lx) / t_hc;
        const float cy = d0y + sign_c * (t_ca * d0y - L.Ly) / t_hc;
        const float cz = d0z + sign_c * (t_ca * d0z - L.Lz) / t_hc;
        Cbx = Cbx + t_b * cx;
        Cby = Cby + t_b * cy;
        Cbz = Cbz + t_b * cz;
        pbx = pbx - t_b * cx;
        pby = pby - t_b * cy;
        pbz = pbz - t_b * cz;
        dbx = dbx + t_b * L.Lx * (1.0f + sign_c * t_ca / t_hc);
        dby = dby + t_b * L.Ly * (1.0f + sign_c * t_ca / t_hc);
        dbz = dbz + t_b * L.Lz * (1.0f + sign_c * t_ca / t_hc);
        r_b = r_b_n + t_b * sign_c * L.r / t_hc;
    } else if (kCylinder && shape == 3) {
        // Implicit differentiation of qa t^2 + qb t + qc = 0 at the
        // chosen root: F'(t) = 2 qa t + qb, grazing rays guarded.
        float Fp = 2.0f * L.qa * t + L.qb;
        Fp = fabsf(Fp) > 1e-9f ? Fp : (Fp >= 0.0f ? 1e-9f : -1e-9f);
        const float ab = -t_b * t * t / Fp;
        const float bb = -t_b * t / Fp;
        const float cb = -t_b / Fp;
        const float A1bx = 2.0f * ab * L.A1x + 2.0f * bb * L.B1x;
        const float A1by = 2.0f * ab * L.A1y + 2.0f * bb * L.B1y;
        const float A1bz = 2.0f * ab * L.A1z + 2.0f * bb * L.B1z;
        const float B1bx = 2.0f * bb * L.A1x + 2.0f * cb * L.B1x;
        const float B1by = 2.0f * bb * L.A1y + 2.0f * cb * L.B1y;
        const float B1bz = 2.0f * bb * L.A1z + 2.0f * cb * L.B1z;
        r_b = r_b_n - 2.0f * cb * L.r;
        const float aA = A1bx * bxx + A1by * bxy + A1bz * bxz;
        dbx = dbx + A1bx - aA * bxx;
        dby = dby + A1by - aA * bxy;
        dbz = dbz + A1bz - aA * bxz;
        axbx = axbx - aA * d0x - L.d_ax * A1bx;
        axby = axby - aA * d0y - L.d_ax * A1by;
        axbz = axbz - aA * d0z - L.d_ax * A1bz;
        const float aB = B1bx * bxx + B1by * bxy + B1bz * bxz;
        const float dpbx = B1bx - aB * bxx;
        const float dpby = B1by - aB * bxy;
        const float dpbz = B1bz - aB * bxz;
        axbx = axbx - aB * L.dcx - L.p_ax * B1bx;
        axby = axby - aB * L.dcy - L.p_ax * B1by;
        axbz = axbz - aB * L.dcz - L.p_ax * B1bz;
        pbx = pbx + dpbx;
        pby = pby + dpby;
        pbz = pbz + dpbz;
        Cbx = Cbx - dpbx;
        Cby = Cby - dpby;
        Cbz = Cbz - dpbz;
        slot(3, axbx);
        slot(4, axby);
        slot(5, axbz);
    } else if (kTorus && shape == 2) {
        // Torus: t = where(m_int, t0 - G / G', 0) at the frozen root
        // t0, the implicit-function derivative plus the quotient
        // term through G'.
        const float tb = t_b * (L.m_int ? 1.0f : 0.0f);
        const float G_b = -tb / L.Gp;
        const float Gp_b = (fabsf(L.Gp) > 1e-9f ? 1.0f : 0.0f) * tb * L.G /
                           (L.Gp * L.Gp);
        const float rr_b = 2.0f * L.rhop * Gp_b + 2.0f * L.rr * G_b;
        const float rhop_b = 2.0f * L.rr * Gp_b;
        const float Y_b = 2.0f * L.Dly * Gp_b + 2.0f * L.Y * G_b;
        float Dly_b = 2.0f * L.Y * Gp_b;
        const float rmn_b = -2.0f * L.rmn * G_b;
        float X_b = rhop_b * L.Dlx / L.rho;
        float Dlx_b = rhop_b * L.X / L.rho;
        float Z_b = rhop_b * L.Dlz / L.rho;
        float Dlz_b = rhop_b * L.Z / L.rho;
        const float rho_b = -rhop_b * L.rhop / L.rho + rr_b;
        const float rmaj_b = r_b_n - rr_b;
        X_b = X_b + rho_b * L.X / L.rho;
        Z_b = Z_b + rho_b * L.Z / L.rho;
        Dlx_b = Dlx_b + L.t0s * X_b;
        Dly_b = Dly_b + L.t0s * Y_b;
        Dlz_b = Dlz_b + L.t0s * Z_b;
        pbx = pbx + X_b * bxx + Y_b * byx + Z_b * bzx;
        pby = pby + X_b * bxy + Y_b * byy + Z_b * bzy;
        pbz = pbz + X_b * bxz + Y_b * byz + Z_b * bzz;
        Cbx = Cbx - (X_b * bxx + Y_b * byx + Z_b * bzx);
        Cby = Cby - (X_b * bxy + Y_b * byy + Z_b * bzy);
        Cbz = Cbz - (X_b * bxz + Y_b * byz + Z_b * bzz);
        dbx = dbx + Dlx_b * bxx + Dly_b * byx + Dlz_b * bzx;
        dby = dby + Dlx_b * bxy + Dly_b * byy + Dlz_b * bzy;
        dbz = dbz + Dlx_b * bxz + Dly_b * byz + Dlz_b * bzz;
        slot(3, X_b * L.rx + Dlx_b * d0x);
        slot(4, X_b * L.ry + Dlx_b * d0y);
        slot(5, X_b * L.rz + Dlx_b * d0z);
        slot(6, Y_b * L.rx + Dly_b * d0x);
        slot(7, Y_b * L.ry + Dly_b * d0y);
        slot(8, Y_b * L.rz + Dly_b * d0z);
        const float cs = o[XRT_O_CSIGN];  // C = o + cs R bz
        slot(0, Cbx);
        slot(1, Cby);
        slot(2, Cbz);
        slot(9, Z_b * L.rx + Dlz_b * d0x + cs * L.Rmj * Cbx);
        slot(10, Z_b * L.ry + Dlz_b * d0y + cs * L.Rmj * Cby);
        slot(11, Z_b * L.rz + Dlz_b * d0z + cs * L.Rmj * Cbz);
        slot(12, cs * (Cbx * bzx + Cby * bzy + Cbz * bzz) + rmaj_b);
        slot(16, rmn_b + o[XRT_O_MADJ] * rmaj_b);
    }
    if (shape == 1 || (kCylinder && shape == 3)) {  // C = o + sign_c r bz
        slot(0, Cbx);
        slot(1, Cby);
        slot(2, Cbz);
        slot(9, sign_c * L.r * Cbx);
        slot(10, sign_c * L.r * Cby);
        slot(11, sign_c * L.r * Cbz);
        slot(12, r_b + sign_c * (bzx * Cbx + bzy * Cby + bzz * Cbz));
    }
    c = Carry{pbx, pby, pbz, dbx, dby, dbz, wb, lamb};
}

// K5b in the build that recomputes (fused_grad_bwd_kernel): for optic i =
// n-1 .. 0 the ray's forward is run from the source up to optic i, so every
// primal lives in registers; the per-thread rows (bwd_rows) in shared
// memory, after the staged images, hold the ray leaving the source, each
// torus's Newton root (found in the first pass only; the ray enters the
// optic in the same state in every pass) and the thread's column of slot
// sums, to which each term goes straight, so no slot sum stays live in a
// register. states is the replay build's (the builds share a launcher),
// unused here.
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
__global__ void __launch_bounds__((BwdLaunch<kTorus, kCylinder, kSource, kMosaic>::kThreads),
                                  (BwdLaunch<kTorus, kCylinder, kSource, kMosaic>::kMinBlocks))
fused_grad_bwd_kernel(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip,
    int n_ip, const float* __restrict__ aux, const float* __restrict__ g_pvec,
    int n_slots, long long n_total, float lam, const float* __restrict__ uniforms,
    uint32_t seed0, uint32_t seed1, const float* __restrict__ g_images,
    int img_total, int use_smem, double* __restrict__ partial, float* __restrict__ states) {
    // The head of the dynamic shared memory (grad_head_floats): fp, ip and
    // pvec, sized by the run; the staged images and the rows follow.
    extern __shared__ __align__(16) float s_dyn[];
    float* const fp = s_dyn;
    int* const ip = reinterpret_cast<int*>(s_dyn + xrt_round4(n_fp));
    float* const P = s_dyn + xrt_round4(n_fp) + xrt_round4(n_ip);
    float* const s_img = s_dyn + grad_head_floats(n_fp, n_ip, n_slots);

    xrt_head_load(fp, g_fp, n_fp, ip, g_ip, n_ip, nullptr, 0);
    for (int i = threadIdx.x; i < n_slots; i += blockDim.x) P[i] = g_pvec[i];
    if (use_smem) {
        for (int i = threadIdx.x; i < img_total; i += blockDim.x) {
            s_img[i] = g_images[i];
        }
    }
    const int n_opt = g_ip[0];
    constexpr bool kPlasma = kSource == XRT_GRAD_PLASMA;
    const int per_row = blockDim.x;
    const int n_rows = bwd_slot_rows(n_opt, kPlasma);
    float* const s_col = s_img + (use_smem ? img_total : 0);
    for (int i = threadIdx.x; i < n_rows * per_row; i += blockDim.x) s_col[i] = 0.0f;
    float* s_ray = s_col + n_rows * per_row + threadIdx.x;
    float* s_root = s_ray + bwd_ray_rows(kPlasma) * per_row;
    __syncthreads();

    const float* gimg = use_smem ? s_img : g_images;
    const int src_base = n_opt * XRT_GRAD_SLOTS;
    const float* apf = fp + XRT_SRC_F + n_opt * XRT_OPT_F;
    const int* api = ip + XRT_HDR_I + n_opt * XRT_OPT_I;
    float* col = s_col + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;

    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n_total;
         r += stride) {
        int src_next;  // the first draw after the source's
        {
            Draws draw{uniforms, n_total, r, seed0, seed1, 0, -1, {0u, 0u, 0u, 0u}};
            RayState src;
            SourceAux src_aux{0.0f, 0.0f, 0.0f};
            grad_sample_source<kSource>(fp, ip, P, src_base, lam, draw, src, src_aux);
            src_next = draw.next;
            const float vals[11] = {src.px, src.py, src.pz, src.dx, src.dy, src.dz,
                                    src.w, src.lam, src_aux.n_g, src_aux.sqrt_t,
                                    src_aux.dop};
#pragma unroll
            for (int k = 0; k < bwd_ray_rows(kPlasma); ++k) {
                s_ray[k * per_row] = vals[k];
            }
        }

        Carry carry{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = n_opt - 1; i >= 0; --i) {
            // Recompute the forward up to optic i, then through it; the
            // optics' draws follow the source's (a fresh cursor at src_next
            // regenerates the same Philox blocks).
            RayState st{s_ray[0], s_ray[per_row], s_ray[2 * per_row],
                        s_ray[3 * per_row], s_ray[4 * per_row], s_ray[5 * per_row],
                        s_ray[6 * per_row], s_ray[7 * per_row], true};
            Draws chain_draw{uniforms, n_total, r, seed0, seed1, src_next, -1,
                             {0u, 0u, 0u, 0u}};
            // The first pass (the last optic) finds every torus root on the
            // way; the later passes read them.
            const bool root_read = i < n_opt - 1;
            for (int e = 0; e < i; ++e) {
                OpticLocals skip;
                grad_optic_fwd<kTorus, kCylinder, kMosaic, kTorus>(
                    fp + XRT_SRC_F + e * XRT_OPT_F, ip + XRT_HDR_I + e * XRT_OPT_I,
                    P + e * XRT_GRAD_SLOTS, apf, api, aux, chain_draw, st, skip,
                    s_root + 2 * e * per_row, per_row, root_read);
            }
            const float* o = fp + XRT_SRC_F + i * XRT_OPT_F;
            const int* oi = ip + XRT_HDR_I + i * XRT_OPT_I;
            const float* Pi = P + i * XRT_GRAD_SLOTS;
            OpticLocals L;
            grad_optic_fwd<kTorus, kCylinder, kMosaic, kTorus>(
                o, oi, Pi, apf, api, aux, chain_draw, st, L, s_root + 2 * i * per_row,
                per_row, root_read);
            grad_optic_bwd<kTorus, kCylinder, kSource, kMosaic>(
                o, oi, Pi, L, st, gimg, carry,
                SlotColumn{col + i * XRT_GRAD_USED * per_row, per_row});
        }
        if (kPlasma) {  // the source slots (fused_grad.py:279-291)
            const float n_g = s_ray[8 * per_row], sqrt_t = s_ray[9 * per_row];
            const float dop = s_ray[10 * per_row];
            float* col_s = col + n_opt * XRT_GRAD_USED * per_row;
            col_s[0] += carry.wb * fp[30];
            col_s[per_row] += carry.lamb * (fp[16] * n_g * dop / (2.0f * sqrt_t));
        }
    }

    // The block's row of slot sums: warp w sums rows w, w + warps, ... of
    // the columns in float64, each lane a strided part, then the lanes by
    // xor shuffles; the same order every run.
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int s = warp; s < n_slots; s += blockDim.x >> 5) {
        const int row = slot_row<kSource>(s, n_opt);
        double v = 0.0;
        if (row >= 0) {
            for (int j = lane; j < per_row; j += 32) v += (double)s_col[row * per_row + j];
        }
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) partial[(long long)blockIdx.x * n_slots + s] = v;
    }
}

// The warp's sum of one value (a plain butterfly), in every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, d);
    return v;
}

// One step of warp_slot_add: v[0..2H) of each lane become v[0..H), the
// sums over the lane pair at xor distance 2H of the half the lane keeps.
template <int H>
__device__ __forceinline__ void warp_slot_halve(float (&v)[XRT_GRAD_USED], int lane) {
    const bool up = (lane & (2 * H)) != 0;
#pragma unroll
    for (int j = 0; j < H; ++j) {
        const float send = up ? v[j] : v[j + H];
        const float keep = up ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
    }
}

// One optic's 17 slot terms v of the warp's 32 rays added into the warp's
// row of slot sums (row[0..16]), in a fixed order: a transposing reduction
// halves the terms a lane carries at each xor distance 16, 8, 4, 2 (the
// lanes with that bit set keep the upper half), so that lane l holds its
// pair's sum of slot l >> 1 of v[0..15] and then, after distance 1, the
// warp's; v[16] takes a plain butterfly. 21 shuffles where a butterfly of
// each term would take 85; the even lanes and lane 1 add 17 sums to 17
// addresses of the row at once. Every lane of the warp calls it.
__device__ __forceinline__ void warp_slot_add(float (&v)[XRT_GRAD_USED], float* row,
                                              int lane) {
    static_assert(XRT_GRAD_USED == 17, "sixteen slots by halves, and one");
    warp_slot_halve<8>(v, lane);
    warp_slot_halve<4>(v, lane);
    warp_slot_halve<2>(v, lane);
    warp_slot_halve<1>(v, lane);
    v[0] = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
    const float t = warp_sum(v[16]);
    if ((lane & 1) == 0) {
        row[lane >> 1] += v[0];
    } else if (lane == 1) {
        row[16] += t;
    }
}

// K5b in the replay build (fused_grad_replay.cu), for chains where
// recomputing from the source costs more than it saves (the launcher's
// pick, bwd_layout): each optic's forward runs at most twice a ray. A first
// pass runs the ray through the chain and saves each optic's entry state;
// then for i = n-1 .. 0 optic i is run alone from its entry state, with the
// draws from its cursor (the source's draws and the mosaics' before it,
// optic_draws), and its adjoint follows: 2n - 1 optic forwards and n
// adjoints a ray (83 and 42 at 42 optics, where the recomputing build runs
// 903 forwards). A torus's Newton root, found in the first pass, is saved
// beside the entry state and read in the replay, where the ray enters the
// optic in the same state (finding it again cost the torus chains 11-18 %,
// chip_ab.py `root_found`, PERF.md). The states are at
// `states`, a region of blockDim floats a row in the shared memory after
// the slot sums where it fits beside the blocks the registers allow, else
// in device memory (a row's floats one a thread, so a warp's store is one
// line); the kernel reads and writes them through generic addresses.
//
// The slot sums: a warp's rays step together through the chain, so each
// optic's 17 terms sit in registers (acc) through its adjoint and are then
// summed over the warp (warp_slot_add) into the warp's row of the block's
// slot sums in shared memory (n_opt x 17, then a plasma's 2, floats a
// warp); no per-thread column. At the end the block sums its warps' rows in
// float64 in a fixed order into its row of partial. Whole warps step
// together through the grid-stride loop; lanes past the end carry the last
// ray and add no terms. Deterministic run to run; the float32 order of the
// sums is not the recomputing build's, and both are held to the twin
// (rtol 1e-3).
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
__global__ void __launch_bounds__((ReplayLaunch<kTorus, kCylinder, kSource, kMosaic>::kThreads),
                                  (ReplayLaunch<kTorus, kCylinder, kSource, kMosaic>::kMinBlocks))
fused_grad_replay_kernel(
    const float* __restrict__ g_fp, int n_fp, const int* __restrict__ g_ip,
    int n_ip, const float* __restrict__ aux, const float* __restrict__ g_pvec,
    int n_slots, long long n_total, float lam, const float* __restrict__ uniforms,
    uint32_t seed0, uint32_t seed1, const float* __restrict__ g_images,
    int img_total, int use_smem, double* __restrict__ partial, float* __restrict__ states) {
    extern __shared__ __align__(16) float s_dyn[];
    float* const fp = s_dyn;
    int* const ip = reinterpret_cast<int*>(s_dyn + xrt_round4(n_fp));
    float* const P = s_dyn + xrt_round4(n_fp) + xrt_round4(n_ip);
    float* const s_img = s_dyn + grad_head_floats(n_fp, n_ip, n_slots);

    xrt_head_load(fp, g_fp, n_fp, ip, g_ip, n_ip, nullptr, 0);
    for (int i = threadIdx.x; i < n_slots; i += blockDim.x) P[i] = g_pvec[i];
    if (use_smem) {
        for (int i = threadIdx.x; i < img_total; i += blockDim.x) {
            s_img[i] = g_images[i];
        }
    }
    const int n_opt = g_ip[0];
    constexpr bool kPlasma = kSource == XRT_GRAD_PLASMA;
    const int per_row = blockDim.x;
    const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n_rows = bwd_slot_rows(n_opt, kPlasma);
    float* const s_sums = s_img + (use_smem ? xrt_round4(img_total) : 0);
    for (int i = threadIdx.x; i < warps * n_rows; i += blockDim.x) s_sums[i] = 0.0f;
    // This thread's state rows: behind the slot sums, or in the block's
    // region of device memory.
    float* const rows =
        (states != nullptr
             ? states + (long long)blockIdx.x * replay_state_rows(n_opt, kTorus) * per_row
             : s_sums + warps * n_rows) +
        threadIdx.x;
    constexpr int kRows = XRT_STATE_ROWS + (kTorus ? 2 : 0);
    __syncthreads();

    const float* gimg = use_smem ? s_img : g_images;
    const int src_base = n_opt * XRT_GRAD_SLOTS;
    const float* apf = fp + XRT_SRC_F + n_opt * XRT_OPT_F;
    const int* api = ip + XRT_HDR_I + n_opt * XRT_OPT_I;
    float* const wrow = s_sums + warp * n_rows;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long r0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
         r0 < n_total; r0 += stride) {
        const long long r = r0 + lane;
        const bool valid = r < n_total;
        const long long ray = valid ? r : n_total - 1;
        Draws draw{uniforms, n_total, ray, seed0, seed1, 0, -1, {0u, 0u, 0u, 0u}};
        RayState st;
        SourceAux src_aux{0.0f, 0.0f, 0.0f};
        grad_sample_source<kSource>(fp, ip, P, src_base, lam, draw, st, src_aux);
        st.alive = true;
        const float lam_r = st.lam;
        // The first pass, as far as optic n-1's entry. first_dead: the
        // first optic that lost the ray (alive never returns: every shape's
        // mask takes the incoming alive), so the ray enters optic i alive
        // where first_dead >= i.
        int first_dead = n_opt;
        for (int e = 0; e < n_opt - 1; ++e) {
            save_state(rows + kRows * e * per_row, per_row, st);
            OpticLocals L;
            grad_optic_fwd<kTorus, kCylinder, kMosaic, kTorus>(
                fp + XRT_SRC_F + e * XRT_OPT_F, ip + XRT_HDR_I + e * XRT_OPT_I,
                P + e * XRT_GRAD_SLOTS, apf, api, aux, draw, st, L,
                rows + (kRows * e + XRT_STATE_ROWS) * per_row, per_row, false);
            if (!st.alive && first_dead == n_opt) first_dead = e;
        }
        save_state(rows + kRows * (n_opt - 1) * per_row, per_row, st);
        // The draw cursor past the last optic, walked back an optic at a
        // time.
        int cursor = draw.next + optic_draws<kMosaic>(ip + XRT_HDR_I + (n_opt - 1) * XRT_OPT_I);

        Carry carry{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = n_opt - 1; i >= 0; --i) {
            const int* oi = ip + XRT_HDR_I + i * XRT_OPT_I;
            cursor -= optic_draws<kMosaic>(oi);
            Draws d{uniforms, n_total, ray, seed0, seed1, cursor, -1, {0u, 0u, 0u, 0u}};
            RayState s = load_state(rows + kRows * i * per_row, per_row, lam_r,
                                    first_dead >= i);
            const float* o = fp + XRT_SRC_F + i * XRT_OPT_F;
            const float* Pi = P + i * XRT_GRAD_SLOTS;
            OpticLocals L;
            grad_optic_fwd<kTorus, kCylinder, kMosaic, kTorus>(
                o, oi, Pi, apf, api, aux, d, s, L,
                rows + (kRows * i + XRT_STATE_ROWS) * per_row, per_row, i < n_opt - 1);
            float acc[XRT_GRAD_USED];
#pragma unroll
            for (int k = 0; k < XRT_GRAD_USED; ++k) acc[k] = 0.0f;
            grad_optic_bwd<kTorus, kCylinder, kSource, kMosaic>(
                o, oi, Pi, L, s, gimg, carry, SlotRegisters{acc});
            if (!valid) {
#pragma unroll
                for (int k = 0; k < XRT_GRAD_USED; ++k) acc[k] = 0.0f;
            }
            warp_slot_add(acc, wrow + i * XRT_GRAD_USED, lane);
        }
        if (kPlasma) {  // the source slots (fused_grad.py:279-291)
            const float aE = valid ? carry.wb * fp[30] : 0.0f;
            const float aT = valid ? carry.lamb * (fp[16] * src_aux.n_g * src_aux.dop /
                                                   (2.0f * src_aux.sqrt_t))
                                   : 0.0f;
            const float sE = warp_sum(aE), sT = warp_sum(aT);
            if (lane == 0) {
                wrow[n_opt * XRT_GRAD_USED] += sE;
                wrow[n_opt * XRT_GRAD_USED + 1] += sT;
            }
        }
    }

    // The block's row of slot sums: each slot its warps' rows in float64,
    // in warp order.
    __syncthreads();
    for (int s = threadIdx.x; s < n_slots; s += blockDim.x) {
        const int row = slot_row<kSource>(s, n_opt);
        double v = 0.0;
        if (row >= 0) {
            for (int w = 0; w < warps; ++w) v += (double)s_sums[w * n_rows + row];
        }
        partial[(long long)blockIdx.x * n_slots + s] = v;
    }
}

using FwdKernel = void (*)(const float*, int, const int*, int, const float*,
                           const float*, int, long long, float, const float*,
                           uint32_t, uint32_t, float*, int, int);
using BwdKernel = void (*)(const float*, int, const int*, int, const float*,
                           const float*, int, long long, float, const float*,
                           uint32_t, uint32_t, const float*, int, int, double*, float*);

// The kernels built for each variant: bit 0 a torus in the chain, bit 1 a
// cylinder; bits 2-3 the source (XRT_GRAD_POINT, _PLASMA, _GENERIC); plus
// 12 for a chain with a mosaic crystal.
#define XRT_GRAD_VARIANTS 24
#define XRT_GRAD_SOURCES(K, M)                                                  \
    K<false, false, 0, M>, K<true, false, 0, M>, K<false, true, 0, M>,          \
        K<true, true, 0, M>, K<false, false, 1, M>, K<true, false, 1, M>,        \
        K<false, true, 1, M>, K<true, true, 1, M>, K<false, false, 2, M>,        \
        K<true, false, 2, M>, K<false, true, 2, M>, K<true, true, 2, M>
#define XRT_GRAD_KERNELS(K) {XRT_GRAD_SOURCES(K, false), XRT_GRAD_SOURCES(K, true)}
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
constexpr BwdKernel kBwdRecompute = fused_grad_bwd_kernel<kTorus, kCylinder, kSource, kMosaic>;
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
constexpr BwdKernel kBwdReplay = fused_grad_replay_kernel<kTorus, kCylinder, kSource, kMosaic>;

}  // namespace

// K5b's replay builds, one a variant, defined in fused_grad_replay.cu, which
// nvcc compiles in a process of its own beside this file, so the build
// takes no longer for them.
extern const BwdKernel xrt_grad_bwd_replay[XRT_GRAD_VARIANTS];

#ifndef XRT_GRAD_REPLAY_TU
namespace {

// K5f's kernel of each variant: held to 64 registers where FwdCap says so.
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic,
          bool kCap = FwdCap<kTorus, kCylinder, kSource, kMosaic>::value>
struct FwdEntry {
    static constexpr FwdKernel fn = fused_grad_fwd_kernel<kTorus, kCylinder, kSource, kMosaic>;
};
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
struct FwdEntry<kTorus, kCylinder, kSource, kMosaic, true> {
    static constexpr FwdKernel fn = fused_grad_fwd_kernel_64<kTorus, kCylinder, kSource, kMosaic>;
};
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
constexpr FwdKernel kFwdOf = FwdEntry<kTorus, kCylinder, kSource, kMosaic>::fn;
const FwdKernel kFwd[XRT_GRAD_VARIANTS] = XRT_GRAD_KERNELS(kFwdOf);
const BwdKernel kBwd[XRT_GRAD_VARIANTS] = XRT_GRAD_KERNELS(kBwdRecompute);
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
constexpr int kBwdThreadsOf = BwdLaunch<kTorus, kCylinder, kSource, kMosaic>::kThreads;
const int kBwdThreads[XRT_GRAD_VARIANTS] = XRT_GRAD_KERNELS(kBwdThreadsOf);
// The variants whose replay build holds fewer blocks than the recomputing
// build (ReplayLaunch: the point source's torus, the plasma's cylinder).
template <bool kTorus, bool kCylinder, int kSource, bool kMosaic>
constexpr bool kReplayFewerOf = ReplayLaunch<kTorus, kCylinder, kSource, kMosaic>::kMinBlocks <
                                BwdLaunch<kTorus, kCylinder, kSource, kMosaic>::kMinBlocks;
const bool kReplayFewer[XRT_GRAD_VARIANTS] = XRT_GRAD_KERNELS(kReplayFewerOf);

bool grad_args_ok(int n_fp, int n_ip, const float* aux, int n_aux, int n_slots,
                  int variant) {
    return n_fp >= XRT_SRC_F && n_ip >= XRT_HDR_I && aux != nullptr && n_aux > 0 &&
           n_slots > 0 && n_slots <= XRT_GRAD_MAX_SLOTS && variant >= 0 &&
           variant < XRT_GRAD_VARIANTS;
}

// The bytes of K5's heads (grad_head_floats): K5f's fp and ip, K5b's fp,
// ip and pvec.
size_t fwd_head_bytes(int n_fp, int n_ip) {
    return (size_t)grad_head_floats(n_fp, n_ip, 0) * sizeof(float);
}
size_t bwd_head_bytes(int n_fp, int n_ip, int n_slots) {
    return (size_t)grad_head_floats(n_fp, n_ip, n_slots) * sizeof(float);
}

// The largest image (floats) K5f keeps in a block's shared memory; larger
// ones take global atomics.
constexpr int kFwdSmemImageMax = XRT_SMEM_IMAGE_MAX_FLOATS;

// K5f's dynamic shared bytes: the head, and the image staged behind it
// where it fits (*use_smem).
size_t fwd_smem(FwdKernel kernel, size_t head, int img_total, int* use_smem) {
    const size_t staged = head + (size_t)img_total * sizeof(float);
    *use_smem = img_total <= kFwdSmemImageMax && xrt_set_smem(kernel, staged) == cudaSuccess;
    return *use_smem ? staged : head;
}

// Threads of a K5f block: of 256, 512 and 1024, the size that keeps the
// most threads resident by the occupancy calculator (ptxas's registers and
// the block's shared memory: the head and the image), the smaller of
// equals. Beside a large image the larger blocks share one: example 08's
// 80 KB detector takes two blocks of 512 where two of 256 fitted, the
// flagship's 59 KB two of 512 where three of 256 did.
int fwd_threads(FwdKernel kernel, size_t smem) {
    int best = 256, most = 0;
    for (int t = 256; t <= 1024; t *= 2) {
        int blocks = 0;
        if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, t, smem) !=
            cudaSuccess) {
            break;
        }
        if (blocks * t > most) {
            most = blocks * t;
            best = t;
        }
    }
    return best;
}

// K5b's builds (xrt_fused_grad_bwd's `build`): the launcher's pick, the
// build that recomputes, the replay build.
#define XRT_K5B_AUTO -1
#define XRT_K5B_RECOMPUTE 0
#define XRT_K5B_REPLAY 1
// The launcher's pick: the recomputing build where its rows fit in shared
// memory, below XRT_K5B_REPLAY_FROM optics or, in the variants whose replay
// build holds fewer blocks (kReplayFewer), at any length; else the replay
// build. The recomputing build runs n(n + 1) / 2 optic forwards a ray and
// the replay build 2n - 1, equal at 3 optics. From 4 optics the replay
// build took less time on the plane-and-sphere chain, and more on the
// torus's (8 warps against 16) wherever the recomputing build's rows fit
// (PERF.md; chip_ab.py --long-only).
#define XRT_K5B_REPLAY_FROM 4

// How a K5b launch lays out its rows and its dynamic shared memory: the
// build, its threads a block (the variant's launch bounds), whether the
// cotangent images are staged in shared memory (where they fit beside the
// rest and the blocks its registers allow, else read through L1), the
// floats of device memory a block's saved states take (the replay build's,
// in shared memory where they fit, else in device memory: 0), and the
// dynamic bytes, the head's included.
struct BwdLayout {
    BwdKernel kernel;
    int build, threads, use_smem, device_rows;
    size_t smem;
};

// The launch of K5b in `build` (XRT_K5B_*): an explicit build that cannot
// run (the recomputing build's rows past the shared memory) is an error,
// never another build.
cudaError_t bwd_layout(int img_total, int n_opt, int variant, size_t head, int build,
                       BwdLayout* out) {
    int device = 0, per_sm = 0, optin = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    const int threads = kBwdThreads[variant];
    const bool plasma = (variant % 12) >> 2 == XRT_GRAD_PLASMA;
    const long long img = img_total <= XRT_SMEM_IMAGE_MAX_FLOATS
                              ? (long long)xrt_round4(img_total) * (long long)sizeof(float)
                              : -1;
    // What a block may take beside the blocks its registers allow, and at
    // most; 1 KB of each block's shared memory is the system's.
    auto cap_of = [&](BwdKernel kernel, long long* cap, long long* limit) {
        cudaFuncAttributes attr;
        int blocks = 0;
        cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
        if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
        }
        if (blocks < 1) blocks = 1;
        *limit = (long long)optin - (long long)attr.sharedSizeBytes;
        *cap = (long long)per_sm / blocks - 1024 - (long long)attr.sharedSizeBytes;
        if (*cap > *limit) *cap = *limit;
        return err;
    };
    const long long h = (long long)head;
    long long cap = 0, limit = 0;
    cudaError_t err;
    if (build < XRT_K5B_AUTO || build > XRT_K5B_REPLAY) return cudaErrorInvalidValue;
    if (build == XRT_K5B_RECOMPUTE ||
        (build == XRT_K5B_AUTO && (n_opt < XRT_K5B_REPLAY_FROM || kReplayFewer[variant]))) {
        const long long cols = (long long)bwd_rows(n_opt, plasma, variant & 1) * threads *
                               (long long)sizeof(float);
        err = cap_of(kBwd[variant], &cap, &limit);
        if (err != cudaSuccess) return err;
        if (h + cols <= cap) {
            const int staged = img >= 0 && h + cols + img <= cap;
            *out = BwdLayout{kBwd[variant], XRT_K5B_RECOMPUTE, threads, staged, 0,
                             (size_t)(h + cols + (staged ? img : 0))};
            return cudaSuccess;
        }
        if (build == XRT_K5B_RECOMPUTE) return cudaErrorInvalidValue;
    }
    const BwdKernel kernel = xrt_grad_bwd_replay[variant];
    err = cap_of(kernel, &cap, &limit);
    if (err != cudaSuccess) return err;
    const long long sums = (long long)(threads / 32) * bwd_slot_rows(n_opt, plasma) *
                           (long long)sizeof(float);
    const long long states = (long long)replay_state_rows(n_opt, variant & 1) * threads *
                             (long long)sizeof(float);
    const bool shared = h + sums + states <= cap;
    const long long base = h + sums + (shared ? states : 0);
    if (base > limit) return cudaErrorInvalidValue;
    const int staged = img >= 0 && base + img <= cap;
    *out = BwdLayout{kernel, XRT_K5B_REPLAY, threads, staged,
                     shared ? 0 : replay_state_rows(n_opt, variant & 1) * threads,
                     (size_t)(base + (staged ? img : 0))};
    return cudaSuccess;
}

}  // namespace

// K5f. fp/ip: K1's packed structure; aux: its n_aux float32 of file rocking
// tables (never null); pvec: n_slots float32 parameters (at most
// XRT_GRAD_MAX_SLOTS);
// rays [0, n_total) with draws from uniforms (n_draws, n_total) float32 or
// Philox keyed by (seed0, seed1); lam: a point source's wavelength. images:
// (img_total,) float32, zeroed by the caller. variant: bit 0 a torus in the
// chain, bit 1 a cylinder, bits 2-3 the source: 0 the point-source cut, 1 a
// plasma (kind 2), 2 the whole generic sampler; plus 12 for a chain with a
// mosaic crystal. Returns cudaGetLastError().
extern "C" int xrt_fused_grad_fwd(const float* fp, int n_fp, const int* ip,
                                  int n_ip, const float* aux, int n_aux,
                                  const float* pvec, int n_slots,
                                  long long n_total, float lam,
                                  const float* uniforms, unsigned int seed0,
                                  unsigned int seed1, float* images,
                                  int img_total, int variant, void* stream) {
    if (!grad_args_ok(n_fp, n_ip, aux, n_aux, n_slots, variant)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n_total <= 0) return (int)cudaSuccess;
    const FwdKernel kernel = kFwd[variant];
    int use_smem = 0;
    const size_t smem = fwd_smem(kernel, fwd_head_bytes(n_fp, n_ip), img_total, &use_smem);
    cudaError_t err = xrt_set_smem(kernel, smem);  // fails for a head too large
    if (err != cudaSuccess) return (int)err;
    const int threads = fwd_threads(kernel, smem);
    const int blocks = xrt_grid_size(kernel, threads, smem, n_total);
    kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
        fp, n_fp, ip, n_ip, aux, pvec, n_slots, n_total, lam, uniforms, seed0,
        seed1, images, img_total, use_smem);
    return (int)cudaGetLastError();
}

// The threads of a K5f block in this variant for images of img_total
// floats and packed buffers of n_fp floats and n_ip ints, or minus a
// cudaError_t.
extern "C" int xrt_fused_grad_fwd_threads(int variant, int img_total, int n_fp, int n_ip) {
    if (variant < 0 || variant >= XRT_GRAD_VARIANTS || img_total < 0 || n_fp < 0 ||
        n_ip < 0) {
        return -(int)cudaErrorInvalidValue;
    }
    int use_smem = 0;
    const size_t smem = fwd_smem(kFwd[variant], fwd_head_bytes(n_fp, n_ip), img_total,
                                 &use_smem);
    const cudaError_t err = xrt_set_smem(kFwd[variant], smem);
    if (err != cudaSuccess) return -(int)err;
    return fwd_threads(kFwd[variant], smem);
}

// The threads of a K5b block in this variant (its launch bounds), or minus
// a cudaError_t.
extern "C" int xrt_fused_grad_bwd_threads(int variant) {
    if (variant < 0 || variant >= XRT_GRAD_VARIANTS) return -(int)cudaErrorInvalidValue;
    return kBwdThreads[variant];
}

// The launch xrt_fused_grad_bwd makes for these sizes, packed buffers
// (n_fp, n_ip, n_slots), chain length, variant and build (XRT_K5B_*;
// bwd_layout): out[0] its blocks (the rows of its partial output), out[1]
// its threads a block, out[2] the floats of device memory the states of one
// block take (0 where they are in shared memory), out[3] its dynamic shared
// bytes, out[4] the build taken (not XRT_K5B_AUTO). Returns a cudaError_t.
extern "C" int xrt_fused_grad_bwd_layout(long long n_total, int img_total, int n_fp,
                                         int n_ip, int n_slots, int n_opt, int variant,
                                         int build, long long* out) {
    if (variant < 0 || variant >= XRT_GRAD_VARIANTS || n_opt <= 0 ||
        n_opt > XRT_GRAD_MAX_OPTICS || n_slots <= 0 || n_slots > XRT_GRAD_MAX_SLOTS) {
        return (int)cudaErrorInvalidValue;
    }
    BwdLayout l;
    cudaError_t err =
        bwd_layout(img_total, n_opt, variant, bwd_head_bytes(n_fp, n_ip, n_slots), build, &l);
    if (err == cudaSuccess) err = xrt_set_smem(l.kernel, l.smem);
    if (err != cudaSuccess) return (int)err;
    out[0] = xrt_grid_size(l.kernel, l.threads, l.smem, n_total);
    out[1] = l.threads;
    out[2] = l.device_rows;
    out[3] = (long long)l.smem;
    out[4] = l.build;
    return (int)cudaSuccess;
}

// K5b. As K5f, plus g_images: (img_total,) float32 cotangent images;
// n_opt: the chain's optics (ip[0]); partial: (n_blocks, n_slots) float64,
// one row of slot sums per block; build as xrt_fused_grad_bwd_layout takes
// it; n_blocks: any grid (the layout's out[0] keeps the blocks resident);
// where the layout's states are in device memory, states: n_states >=
// n_blocks out[2] floats, else null. Returns cudaGetLastError().
extern "C" int xrt_fused_grad_bwd(const float* fp, int n_fp, const int* ip,
                                  int n_ip, const float* aux, int n_aux,
                                  const float* pvec, int n_slots,
                                  long long n_total, float lam,
                                  const float* uniforms, unsigned int seed0,
                                  unsigned int seed1, const float* g_images,
                                  int img_total, int n_opt, double* partial,
                                  int n_blocks, int variant, float* states,
                                  long long n_states, int build, void* stream) {
    if (!grad_args_ok(n_fp, n_ip, aux, n_aux, n_slots, variant) || n_blocks <= 0 ||
        n_opt <= 0 || n_opt > XRT_GRAD_MAX_OPTICS) {
        return (int)cudaErrorInvalidValue;
    }
    BwdLayout l;
    cudaError_t err =
        bwd_layout(img_total, n_opt, variant, bwd_head_bytes(n_fp, n_ip, n_slots), build, &l);
    if (err == cudaSuccess) err = xrt_set_smem(l.kernel, l.smem);
    if (err != cudaSuccess) return (int)err;
    if (l.device_rows > 0 &&
        (states == nullptr || n_states < (long long)n_blocks * l.device_rows)) {
        return (int)cudaErrorInvalidValue;
    }
    l.kernel<<<n_blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
        fp, n_fp, ip, n_ip, aux, pvec, n_slots, n_total, lam, uniforms, seed0, seed1,
        g_images, img_total, l.use_smem, partial, l.device_rows > 0 ? states : nullptr);
    return (int)cudaGetLastError();
}
#endif  // XRT_GRAD_REPLAY_TU
