// The optic chain of the fused trace kernels K1 (fused_trace.cu) and K3
// (trace_only.cu): one ray, in registers, through every optic of the packed
// chain (ops/fused_trace.py: pack_params), with the per-element counts and
// the images. The counterpart of the TPU kernels' shared _trace_chain
// (xicsrt_tpu/ops/fused_trace.py:705) with plane, sphere, torus, cylinder
// and Chebyshev-surface shapes, mirrors, gaussian, step and file crystals
// and mosaic crystals, in mc or weight mode, with nearest or bilinear
// images; its plain twin is ops/fused_trace.py:_trace_chain_plain.
//
// Counts are reduced per warp with __ballot_sync/__popc into the block's
// shared counters, so every lane of the warp must call it; images go to the
// block-private histogram img (binning.cuh) or to global memory.
#pragma once

#include <cuda_runtime.h>

#include "binning.cuh"
#include "trace_common.cuh"

__device__ __forceinline__ void xrt_count_warp(unsigned int* s_counts, int elem,
                                               bool alive, int lane) {
    const unsigned int b = __ballot_sync(0xffffffffu, alive);
    if (lane == 0 && b) atomicAdd(s_counts + elem, (unsigned int)__popc(b));
}

// The chain's record hook (K1e, fused_history.cu): called after each
// element with its post-element state; a hook whose kOn is set takes the
// place of the counts and the images. XrtNoRecord, the default, compiles
// to nothing, so the builds without history keep their code.
struct XrtNoRecord {
    static constexpr bool kOn = false;
    __device__ __forceinline__ void operator()(int, float, float, float, float, float,
                                               float, bool, float) const {}
};

// The Bragg deviation sd + sd^3 / 6, sd = |d.n| cos_b - sqrt(1 - (d.n)^2)
// sin_b (fused_trace.py:995-1002), of a direction on the normal whose dot
// product with it is dot.
__device__ __forceinline__ float xrt_bragg_delta(float dot, float sin_b,
                                                 float cos_b) {
    const float adot = fabsf(dot);
    const float cosi = sqrtf(fmaxf(1.0f - adot * adot, 0.0f));
    const float sd = adot * cos_b - cosi * sin_b;
    return sd + sd * sd * sd * (1.0f / 6.0f);
}

// The rocking curve of the crystal whose blocks are o, oi at the deviation
// delta, times its reflectivity o[19]: gaussian (o[20] sigma), step (o[20]
// half width) or the resampled file table in aux.
__device__ __forceinline__ float xrt_rock_prob(const float* o, const int* oi,
                                               const float* __restrict__ aux,
                                               float delta) {
    if (oi[3] == 0) {
        const float z = delta / o[20];
        return o[19] * expf(-0.5f * (z * z));
    }
    if (oi[3] != XRT_ROCK_FILE) return fabsf(delta) <= o[20] ? o[19] : 0.0f;
    bool inr;
    float f, kf, t0, t1;
    const float val = xrt_file_value(aux + oi[XRT_OI_TABLE], oi[XRT_OI_K],
                                     o[XRT_O_LO], o[XRT_O_INV_STEP], delta,
                                     &inr, &f, &kf, &t0, &t1);
    return inr ? val * o[19] : 0.0f;
}

// One layer's crystallite normal: two standard normals scaled by sigma_n,
// on the plane z = 1, in the basis (o2, o1, n) (JAX fused_trace.py:
// 1043-1049): nm = gx wn o2 + gy wn o1 + wn n, wn = 1 / sqrt(1 + gx^2 +
// gy^2).
__device__ __forceinline__ void xrt_mosaic_normal(
    Draws& draw, float sigma_n, const float* o1, const float* o2, float nx,
    float ny, float nz, float& nmx, float& nmy, float& nmz) {
    const float gx = sigma_n * xrt_normal(draw);
    const float gy = sigma_n * xrt_normal(draw);
    const float wn = inv_sqrt(1.0f + gx * gx + gy * gy);
    nmx = gx * wn * o2[0] + gy * wn * o1[0] + wn * nx;
    nmy = gx * wn * o2[1] + gy * wn * o1[1] + wn * ny;
    nmz = gx * wn * o2[2] + gy * wn * o1[2] + wn * nz;
}

// The mosaic crystal (K1c-mosaic; JAX fused_trace.py:1014-1098): the
// cutoff prefilter, the crystallite basis o1 = normalize(ny, nz - nx, -ny),
// o2 = normalize(n x o1), then oi[XRT_OI_DEPTH] layers of three draws each
// (two normals, a uniform). mc: the first layer whose crystallite accepts
// the ray (prob >= u) reflects it, and a ray without one is lost. Weight:
// every layer tests the incoming direction; the weight takes cum =
// 1 - prod(1 - p_i) and the direction the reflection off the last layer
// picked (u cum_l < q_l, q_l = p_l prod_{j<l} (1 - p_j)). The depth is a
// run-time int, so one build serves every depth; a ray that is dead, or
// that has reflected in mc mode, skips its remaining layers by moving its
// draw index past them, so later optics keep their draws.
__device__ __forceinline__ void xrt_mosaic(const float* o, const int* oi,
                                           const float* __restrict__ aux,
                                           Draws& draw, float nxv, float nyv,
                                           float nzv, float sin_b, float cos_b,
                                           bool weight, float& dx, float& dy,
                                           float& dz, bool& mask, float& wt) {
    const int depth = oi[XRT_OI_DEPTH];
    const int first = draw.next;
    if (mask && o[XRT_O_MCUT] >= 0.0f) {
        const float d0 = xrt_bragg_delta(dx * nxv + dy * nyv + dz * nzv, sin_b, cos_b);
        mask = fabsf(d0) < o[XRT_O_MCUT];
    }
    if (mask) {
        float o1[3] = {nyv, nzv - nxv, -nyv};
        float inv = inv_sqrt(fmaxf(o1[0] * o1[0] + o1[1] * o1[1] + o1[2] * o1[2], 1e-30f));
        o1[0] = o1[0] * inv;
        o1[1] = o1[1] * inv;
        o1[2] = o1[2] * inv;
        float o2[3] = {nyv * o1[2] - nzv * o1[1], nzv * o1[0] - nxv * o1[2],
                       nxv * o1[1] - nyv * o1[0]};
        inv = inv_sqrt(fmaxf(o2[0] * o2[0] + o2[1] * o2[1] + o2[2] * o2[2], 1e-30f));
        o2[0] = o2[0] * inv;
        o2[1] = o2[1] * inv;
        o2[2] = o2[2] * inv;
        const float sigma_n = o[XRT_O_MSIGMA];
        const float d0x = dx, d0y = dy, d0z = dz;
        if (!weight) {
            bool refl = false;
            for (int l = 0; l < depth && !refl; ++l) {
                float nmx, nmy, nmz;
                xrt_mosaic_normal(draw, sigma_n, o1, o2, nxv, nyv, nzv, nmx, nmy, nmz);
                const float dotm = d0x * nmx + d0y * nmy + d0z * nmz;
                const float prob =
                    xrt_rock_prob(o, oi, aux, xrt_bragg_delta(dotm, sin_b, cos_b));
                if (prob >= draw()) {
                    const float kk = 2.0f * dotm;
                    dx = d0x - kk * nmx;
                    dy = d0y - kk * nmy;
                    dz = d0z - kk * nmz;
                    refl = true;
                }
            }
            mask = refl;
        } else {
            float surv = 1.0f, cum = 0.0f;
            for (int l = 0; l < depth; ++l) {
                float nmx, nmy, nmz;
                xrt_mosaic_normal(draw, sigma_n, o1, o2, nxv, nyv, nzv, nmx, nmy, nmz);
                const float dotm = d0x * nmx + d0y * nmy + d0z * nmz;
                const float prob =
                    xrt_rock_prob(o, oi, aux, xrt_bragg_delta(dotm, sin_b, cos_b));
                const float q = prob * surv;
                const float cum_new = cum + q;
                if (draw() * cum_new < q) {
                    const float kk = 2.0f * dotm;
                    dx = d0x - kk * nmx;
                    dy = d0y - kk * nmy;
                    dz = d0z - kk * nmz;
                }
                surv = surv * (1.0f - prob);
                cum = cum_new;
            }
            wt = wt * cum;
        }
    }
    draw.next = first + 3 * depth;
}

// The bilinear splat of a hit at fractional pixel coordinates (fx, fy) on
// an (nx, ny) image (JAX fused_trace.py:1165-1194, the XLA path's
// per-corner bounds drop): the coordinates clipped to [-2, n + 1], the
// tents 1 - |f - i| at the two grid neighbours of each, the corner weight
// (tx w) ty, four shared-memory atomics, each corner off the grid dropped.
__device__ __forceinline__ void xrt_splat(float* img, float fx, float fy,
                                          int nx, int ny, float w) {
    const float fxc = fminf(fmaxf(fx, -2.0f), (float)nx + 1.0f);
    const float fyc = fminf(fmaxf(fy, -2.0f), (float)ny + 1.0f);
    const float x0 = floorf(fxc), y0 = floorf(fyc);
    for (int a = 0; a < 2; ++a) {
        const float xi = x0 + (float)a;
        if (!(xi >= 0.0f && xi < (float)nx)) continue;
        const float wx = (1.0f - fabsf(fxc - xi)) * w;
        for (int b = 0; b < 2; ++b) {
            const float yi = y0 + (float)b;
            if (!(yi >= 0.0f && yi < (float)ny)) continue;
            atomicAdd(img + (int)xi * ny + (int)yi, wx * (1.0f - fabsf(fyc - yi)));
        }
    }
}

// Traces a ray from (px, py, pz) along the unit (dx, dy, dz) of wavelength
// wl and weight wt through the chain, adding to s_counts[1 + e] and the
// images. per_ray_wl: the crystals take their Bragg angle from wl (the
// plasma of fused_trace.py:997-1001, and generic sources whose wavelength
// varies), else the constant sin/cos packed in the optic.
//
// kCheb compiles the stage of mesh surrogates (Chebyshev surfaces, shape 4);
// the host takes this build only for chains that hold one
// (FusedParams.cheb): with it, K1a's build took 72 registers, not 71, and
// 3-5 % more time (chip_ab.py, PERF.md). kStages compiles, from 1, weight
// mode and bilinear images (header ints XRT_H_WEIGHT and XRT_H_BILINEAR)
// and, at 2, mosaic crystals (interact code 3); the host takes the least
// build a run needs (FusedParams.stages), so mc chains with nearest images
// keep a build without either, and weight or bilinear runs one without the
// mosaic's registers (chip_ab.py, PERF.md). File rocking curves (rocking
// code 2, the table read from aux) and mirrors (interact code 2: d' = d -
// 2 (d.n) n, no draw) are in every build.
//
// Returns whether the ray is alive after the last element. rec, where its
// kOn is set, takes each element's state (1 + e, position, direction,
// alive, weight) in place of the counts and the images.
template <bool kCheb, int kStages, class Rec = XrtNoRecord>
__device__ __forceinline__ bool xrt_trace_chain(
    const float* fp, const int* ip, const float* __restrict__ aux, Draws& draw,
    float px, float py, float pz, float dx, float dy, float dz, float wl,
    bool per_ray_wl, bool alive, float wt, unsigned int* s_counts, float* img,
    int lane, Rec rec = Rec()) {
    const int n_opt = ip[0];
    const float* apf = fp + XRT_SRC_F + n_opt * XRT_OPT_F;
    const int* api = ip + XRT_HDR_I + n_opt * XRT_OPT_I;
    const bool weight = kStages >= 1 && ip[XRT_H_WEIGHT] != 0;
    const bool bilinear = kStages >= 1 && ip[XRT_H_BILINEAR] != 0;
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
        } else if (oi[0] == 1) {  // sphere of center o[12:15], radius^2 o[15]
            const SphereHit h = xrt_sphere_hit(o[12], o[13], o[14], o[15],
                                               0.0f, oi[1] != 0, px, py,
                                               pz, dx, dy, dz);
            m_int = alive && h.d2 <= o[15];
            t = h.t;
            nxv = nyv = nzv = 0.0f;
        } else if (oi[0] == 2) {  // torus
            t = xrt_torus_hit(o, px, py, pz, dx, dy, dz, alive, &m_int);
            nxv = nyv = nzv = 0.0f;
        } else if (kCheb && oi[0] == XRT_SHAPE_CHEB) {  // unit normal given
            t = xrt_cheb_hit(o, reinterpret_cast<const float4*>(aux + oi[XRT_OI_DENSE]),
                             oi[XRT_OI_DEG], px, py, pz, dx, dy, dz, alive, &m_int,
                             nxv, nyv, nzv);
        } else {  // cylinder of axis bx through o[12:15], radius^2 o[15]
            const CylinderHit h = xrt_cylinder_hit(
                o[12], o[13], o[14], o[3], o[4], o[5], o[15],
                oi[1] != 0, px, py, pz, dx, dy, dz);
            m_int = alive && h.disc >= 0.0f;
            t = m_int ? h.t : 0.0f;
            nxv = nyv = nzv = 0.0f;
        }
        const float qx = m_int ? px + t * dx : px;
        const float qy = m_int ? py + t * dy : py;
        const float qz = m_int ? pz + t * dz : pz;
        if (oi[0] != 0 && !(kCheb && oi[0] == XRT_SHAPE_CHEB)) {
            // sphere, cylinder: towards the center or the axis; torus:
            // outward
            if (oi[0] == 1) {
                nxv = o[12] - qx;
                nyv = o[13] - qy;
                nzv = o[14] - qz;
            } else if (oi[0] == 2) {
                xrt_torus_normal(o, qx, qy, qz, nxv, nyv, nzv);
            } else {
                const float tcx = o[12] - qx, tcy = o[13] - qy, tcz = o[14] - qz;
                const float along = tcx * o[3] + tcy * o[4] + tcz * o[5];
                nxv = tcx - along * o[3];
                nyv = tcy - along * o[4];
                nzv = tcz - along * o[5];
            }
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

        const bool mosaic = kStages >= 2 && oi[2] == XRT_INTERACT_MOSAIC;
        if (oi[2] == 1 || mosaic) {  // Bragg crystal or mosaic
            float sin_b = o[21], cos_b = o[22];
            if (per_ray_wl) {  // per-ray Bragg angle (fused_trace.py:997-1001)
                sin_b = fminf(fmaxf(wl * o[XRT_O_INV2D], 0.0f), 1.0f);
                cos_b = sqrtf(fmaxf(1.0f - sin_b * sin_b, 0.0f));
            }
            if (mosaic) {
                xrt_mosaic(o, oi, aux, draw, nxv, nyv, nzv, sin_b, cos_b, weight,
                           dx, dy, dz, mask, wt);
            } else {
                const float dot = dx * nxv + dy * nyv + dz * nzv;
                const float prob =
                    xrt_rock_prob(o, oi, aux, xrt_bragg_delta(dot, sin_b, cos_b));
                if (weight) {  // no draw (fused_trace.py:1007-1008)
                    if (mask) wt = wt * prob;
                } else {  // Bernoulli acceptance
                    const float uacc = draw();
                    mask = mask && prob >= uacc;
                }
                if (mask) {
                    const float kk = 2.0f * dot;
                    dx = dx - kk * nxv;
                    dy = dy - kk * nyv;
                    dz = dz - kk * nzv;
                }
            }
        } else if (oi[2] == 2 && mask) {  // mirror
            const float kk = 2.0f * (dx * nxv + dy * nyv + dz * nzv);
            dx = dx - kk * nxv;
            dy = dy - kk * nyv;
            dz = dz - kk * nzv;
        }
        px = qx;
        py = qy;
        pz = qz;
        alive = mask;
        if constexpr (Rec::kOn) {
            rec(1 + e, px, py, pz, dx, dy, dz, alive, wt);
            continue;
        }
        xrt_count_warp(s_counts, 1 + e, alive, lane);

        if (oi[7] >= 0 && alive) {
            const float fx = fmaf(lxv, o[23], o[24]);
            const float fy = fmaf(lyv, o[23], o[25]);
            if (bilinear) {
                xrt_splat(img + oi[7], fx, fy, oi[8], oi[9], wt);
            } else {
                int flat;
                if (xrt_nearest_pixel(fx, fy, oi[8], oi[9], &flat)) {
                    atomicAdd(img + oi[7] + flat, kStages >= 1 ? wt : 1.0f);
                }
            }
        }
    }
    return alive;
}
