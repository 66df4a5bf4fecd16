// The optic chain of the fused trace kernels K1 (fused_trace.cu) and K3
// (trace_only.cu): one ray, in registers, through every optic of the packed
// chain (ops/fused_trace.py: pack_params), with the per-element counts and
// the nearest-pixel images. The counterpart of the TPU kernels' shared
// _trace_chain (xicsrt_tpu/ops/fused_trace.py:705) for mc mode and nearest
// images, with plane, sphere, torus, cylinder and Chebyshev-surface shapes,
// mirrors and gaussian, step and file crystals; its plain twin is
// ops/fused_trace.py:_trace_chain_plain.
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

// Traces a ray from (px, py, pz) along the unit (dx, dy, dz) of wavelength
// wl through the chain, adding to s_counts[1 + e] and the images. per_ray_wl:
// the crystals take their Bragg angle from wl (the plasma of
// fused_trace.py:997-1001, and generic sources whose wavelength varies),
// else the constant sin/cos packed in the optic.
//
// kCheb compiles the stage of mesh surrogates (Chebyshev surfaces, shape 4);
// the host takes this build only for chains that hold one
// (FusedParams.cheb): with it, K1a's build took 72 registers, not 71, and
// 3-5 % more time (chip_ab.py, PERF.md). File rocking curves (rocking code
// 2, the table read from aux) and mirrors (interact code 2:
// d' = d - 2 (d.n) n, no draw) are in every build.
template <bool kCheb>
__device__ __forceinline__ void xrt_trace_chain(
    const float* fp, const int* ip, const float* __restrict__ aux, Draws& draw,
    float px, float py, float pz, float dx, float dy, float dz, float wl,
    bool per_ray_wl, bool alive, unsigned int* s_counts, float* img, int lane) {
    const int n_opt = ip[0];
    const float* apf = fp + XRT_SRC_F + n_opt * XRT_OPT_F;
    const int* api = ip + XRT_HDR_I + n_opt * XRT_OPT_I;
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
            t = xrt_cheb_hit(o, reinterpret_cast<const float2*>(aux + oi[XRT_OI_CHEB]),
                             oi[XRT_OI_TERMS], oi[XRT_OI_DEG], px, py, pz, dx, dy,
                             dz, alive, &m_int, nxv, nyv, nzv);
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

        if (oi[2] == 1) {  // Bragg crystal, mc acceptance
            const float dot = dx * nxv + dy * nyv + dz * nzv;
            const float adot = fabsf(dot);
            const float cosi = sqrtf(fmaxf(1.0f - adot * adot, 0.0f));
            float sin_b = o[21], cos_b = o[22];
            if (per_ray_wl) {  // per-ray Bragg angle (fused_trace.py:997-1001)
                sin_b = fminf(fmaxf(wl * o[XRT_O_INV2D], 0.0f), 1.0f);
                cos_b = sqrtf(fmaxf(1.0f - sin_b * sin_b, 0.0f));
            }
            const float sd = adot * cos_b - cosi * sin_b;
            const float delta = sd + sd * sd * sd * (1.0f / 6.0f);
            float prob;
            if (oi[3] == 0) {  // gaussian, o[20] = sigma
                const float z = delta / o[20];
                prob = o[19] * expf(-0.5f * (z * z));
            } else if (oi[3] != XRT_ROCK_FILE) {  // step, o[20] = fwhm / 2
                prob = fabsf(delta) <= o[20] ? o[19] : 0.0f;
            } else {  // file: the resampled table in aux
                bool inr;
                float f, kf, t0, t1;
                const float val = xrt_file_value(
                    aux + oi[XRT_OI_TABLE], oi[XRT_OI_K], o[XRT_O_LO],
                    o[XRT_O_INV_STEP], delta, &inr, &f, &kf, &t0, &t1);
                prob = inr ? val * o[19] : 0.0f;
            }
            const float uacc = draw();
            mask = mask && prob >= uacc;
            if (mask) {
                const float kk = 2.0f * dot;
                dx = dx - kk * nxv;
                dy = dy - kk * nyv;
                dz = dz - kk * nzv;
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
        xrt_count_warp(s_counts, 1 + e, alive, lane);

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
