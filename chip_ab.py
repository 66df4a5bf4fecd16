"""A/B kernel timings of several source trees on one NVIDIA GPU.

Run from the repository root: ``python3 chip_ab.py [--parent DIR]``.

It copies this checkout (without ``.git`` and what ``.gitignore`` lists)
under ``build/chip_ab/`` (git-ignored), once for each layout of the kernels'
templates:

- ``checkout``: the checkout as it is: K1's and K3's weight and bilinear
  stages only in their ``kStages`` 1 and 2 builds, the mosaic's only in
  ``kStages`` 2, the host taking the least a run needs, and K5's mosaic
  stage only in its ``kMosaic`` variants;
- ``all_in``: every K1 and K3 run takes its ``kStages`` 2 build and every
  K5 run its ``kMosaic`` variant, so the flagship runs with those stages
  compiled in;
- ``group_2``, ``group_8``, ``chunk_8``, ``layer_lanes``,
  ``mosaic_bounds_3``, ``cheb_spread``, ``cheb_spread_bounds_2``: the
  checkout with the spread of K1c-mosaic's layers over the warp in
  another shape, its builds held to 3 blocks, or the spread in the
  Chebyshev builds too, alone or held to 2 blocks (``MOSAIC_LEADS``);
- ``k3_prefetch``, ``k3_blocks_128``, ``k3_bounds_40``, ``k3_tma``: the
  checkout with one lead of K3's redesign (``K3_LEADS``);
- ``early_exit``, ``bounds_none``, ``bounds_torus``, ``blocks_256``,
  ``corners_all``, ``words_indexed``, ``separate_trig``, ``image_l2``:
  the checkout with one lead of the redesign of K5f and of the draws
  undone, or put back where it was dropped (``LEADS_UNDONE``);
- ``src_shared``, ``asym_noinline``, ``philox_lazy``, ``philox_generic``
  (``K1B_LEADS``) and ``search_serial``, ``plasma_blocks_128``,
  ``plasma_bounds_5``, ``plasma_bounds_6``, ``torus_pairs``
  (``PLASMA_LEADS``, ``PAIR_LEAD``): the checkout with one lead of K1b's
  or the plasma's redesign undone, or tried where it was dropped;
- ``source_only``, ``skip_lookup`` (``SPLIT_LAYOUTS``): K1 with every ray
  killed after its source, or every plasma ray given bundle 0, to split
  K1's time into sampler, lookup and chain (times only);
- ``staged_images``, ``no_warp_skip``, ``skip_all_builds``,
  ``curved_all``, ``flat_unbounded``, ``k1a_bounds_4`` (``K1A_LEADS``)
  and ``k2_per_image``, ``k2_mask_bytes``, ``k2_float_atomics``
  (``K2_LEADS``): the checkout with one lead of K1a's or K2's redesign
  undone, or tried where it was dropped;
- ``k1d_staged``, ``k1d_cluster``, ``k1d_curved_unstaged``,
  ``k1d_no_zero_skip``, ``k1d_curved``, ``k1d_bounds_5``,
  ``k1d_unbounded``, ``k1d_cheb_256``,
  ``k1d_cheb_160``, ``k1d_no_vote``
  (``K1D_LEADS``): the checkout with one lead of K1d's redesign (the
  weight and bilinear stages) undone, or tried where it was dropped; the
  checkout itself is the flat stage-1 build at 4 blocks;
- ``no_image_adds``, ``cylinder_flat`` (times only), ``cylinder_curved``,
  ``dense_off``, ``window_off``, ``window_floats``, ``cylinder_bounds_4``,
  ``dense_spare_off``, ``dense_match`` (``K1C_LEADS``): K1 without its
  nearest image adds, the cylinder compiled into K1a's flat build, and the
  checkout with one lead of K1c-mirror's and K1c-cylinder's redesign
  undone (the cylinder's build without the torus code, the mirror chains'
  build, the staged window, its integer counts, the cylinder's 5 blocks, a
  dense chain's whole image at one block's cost) or tried where it was
  dropped (a warp's peers on a pixel adding once);
- ``head_image_first``, ``head_fp_first`` (``HEAD_LEADS``): K1's dynamic
  shared memory in another order than the checkout's (counters, ip, fp,
  then the staged image): the image behind the counters, or fp before ip;
- ``chain_no_count``, ``chain_no_vote``, ``chain_no_apertures``,
  ``chain_params_const``, ``apertures_switch`` (``CHAIN_SPLIT``): the
  split of K1's chain on long chains (``--long-only``): no count, no warp
  vote before an element, apertures that return their bounds mask, the
  packed floats from ``__constant__`` memory (times only where the counts
  move, ``TIMES_ONLY``), and the aperture test's earlier switches;
- ``checkpoints``, ``root_found`` (``K5B_LEADS``): K5b's replay build with
  a checkpoint every ceil(sqrt(n)) optics in shared memory in place of
  every entry state saved, or with each torus's Newton root found again in
  the replay in place of saved in the first pass (``--long-only`` times
  K5b alone); ``apertures_loop``, ``apertures_shared``, ``apertures_peel``
  (``CHAIN_SPLIT``): K1's chain without the single aperture's path
  (``xrt_chain_apertures``), that path and xrt_apertures' loop as one
  function on shared helpers, or the first aperture peeled for every
  count in its place.

``--layouts`` picks among them (default: all); ``--trace-only`` times K1,
K1e and K3 alone, for the leads of the trace kernels; ``--stage1-only``
times K1's weight and bilinear builds alone (:func:`stage1_chains`: the
flagship's, the plasma's, the generic source's, the Chebyshev mesh's and
the cylinder's) with K1a beside them, and K1a's and K1d's twins on the
card (3 means of 3 calls); ``--k1e-only`` times K1e's rows
(:func:`k1e_rows`); ``--k4-only`` times K4 alone on phase 16's and phase
13's tables beside its bound and ``torch.repeat_interleave``
(:func:`k4_rows`); ``--k1c-only`` times K1c-mirror's and K1c-cylinder's
rows and those that share their code (:func:`k1c_rows`); ``--long-only``
times the long chains' rows (:func:`long_rows`: K1, its marked build and
K3 on ``baffle127`` and its ``raytrace`` of 2^28 rays, K5f, K5b and the
2^24-ray step on ``baffle42``, K1a and K5b on the short chains beside
them, and K5b's cut-over between its builds on short chains behind 0-5
plates).

``--parent DIR`` adds another tree as it is, such as the parent commit
unpacked there with ``git archive``. All trees are built at once (one
``nvcc`` per source), then each tree's timings run in a process of their
own, in the order A B C ... C B A. Each prints ptxas's lines for K1
(``fused_trace_kernel``, ``fused_trace_flat_kernel``,
``fused_trace_cylinder_kernel``, ``fused_trace_dense_kernel``), K2
(``bin_images_kernel``), K3 (``trace_only_kernel``), K5f
(``fused_grad_fwd_kernel``), K5b
(``fused_grad_bwd_kernel``) and R2 (``mma_rate_kernel``): registers,
spill stores, stack frame, and the 256-thread blocks a multiprocessor
holds at that register count (65536 registers, allocated per warp in
units of 256), for K1 and K2 also the blocks their launch's shared memory
leaves (at the flagship's images; a 100 x 100 image), and the SASS
counts (``cuobjdump -sass``) of K1a's builds, the cylinder's and the dense build
and K2. Then the ms per call
(CUDA events, the least and the median of 5 means of 20 calls) of K2 on
dense hits and on the main path's own eager items (on the card alone,
queued behind a spin kernel, and with the host's time to issue them)
beside ``torch.bincount`` of the same set rays (its kernels alone by
``torch.profiler``, and with the host), of K1a at 2^28 rays and
the flagship's ``raytrace`` on both engines, of K1d's weight and bilinear
flagship at 2^28 rays and their fused ``raytrace`` (3 means of 3 calls), of K1a
on the flagship at 2^22 rays, of
K1c-file, K1c-mirror, K1c-cheb (example 06's mesh crystal on the mesh
spectrometer, ``mesh41``, example 06 as written), K1d and K1c-mosaic
(``mosaic15`` and the mesh mosaic, mc and weight), K1b (phase 24's source
and the ``isotropic_xy_asym`` variant) and K1c-cylinder on
``chip_smoke.py``'s chains where the tree has them; of K1 plasma+torus on
phase 16's slots at 1000 and 1e5 bundles, and K4 on the same tables; of
K1e's 'found' reservoir (the marked K1 and the record launch) on the
flagship, ``mosaic15`` and ``plasma_torus``; of K3 on phase 25's 8e6-bundle plasma iteration (1.97e7
rays), in weight mode on the flagship's eager rays and behind the mosaic
on ``mosaic15``'s (mc and weight); of K5f and K5b on the
flagship, phase 22's chains, ``mosaic_sphere``, ``file_rocking``, the
generic source ``focused_gaussian_voigt`` and example 08's chain (its
80 KB image), at the chain's rays (2^22 for example 08's), and of K5f
with the same rays' draws read from memory and at 2^20 and 2^24 rays
(the fixed cost against the cost a ray); and of R2 at the roofline tool's
size. Each K1, K3 and K4 call timed is run once more beside its twin, and
whether their counts (K4: rows) are equal is printed; ``source_only``
checks the source's count alone and ``skip_lookup`` no plasma's. A tree's process ends with one
JSON line of its times and those checks.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import runpy
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
AB_DIR = os.path.join(ROOT, "build", "chip_ab")
# The flagship's packed buffers (floats, ints): the head a tree whose
# kernels keep them in dynamic shared memory counts at the flagship's launch.
FLAGSHIP_FP_IP = (168, 70)

# Files of the checkout, and what a layout puts in place of their lines.
ALL_IN = {
    os.path.join("xicsrt_tpu_torch", "csrc", "fused_run.cuh"):
        {"    const int build = xrt_fused_build(src, cheb, stages, shapes, dense);":
         "    const int build = 6 * src + (cheb ? 3 : 0) + 2;"},
    os.path.join("xicsrt_tpu_torch", "csrc", "trace_only.cu"):
        {"(cheb ? 3 : 0) + stages]": "(cheb ? 3 : 0) + 2]"},
    os.path.join("xicsrt_tpu_torch", "ops", "fused_grad.py"):
        {"| source << 2) + 12 * int(mosaic)": "| source << 2) + 12"},
}
# The leads of the mosaic's and K3's redesign. K1c-mosaic's spread of
# layers in other shapes: 2 or 8 lanes a searching ray in mc mode (not 4);
# chunks of 8 layers a lane (not 4) in groups of 2; 8 lanes a ray with a
# layer each, the first spread of the redesign, whose lanes call Philox at
# different draws; K1's and K3's mosaic builds held to 80 registers (3
# blocks of 256); the spread in the builds with the Chebyshev stage too
# (which keep the serial loop), alone and held to 128 registers (2
# blocks).
_CHAIN = os.path.join("xicsrt_tpu_torch", "csrc", "trace_chain.cuh")
_RUN = os.path.join("xicsrt_tpu_torch", "csrc", "fused_run.cuh")
_K3 = os.path.join("xicsrt_tpu_torch", "csrc", "trace_only.cu")
_GROUP = "constexpr int kMosaicGroup = 4;"
_CHUNK = "constexpr int kMosaicChunk = 4;"
_SPREAD = "xrt_mosaic<!kCheb>("
_K1_DECL = "__global__ void fused_trace_kernel("
_K3_DECL = "__global__ void trace_only_kernel("
_K3_THREADS = "    const int threads = 256;\n    using Kernel"
MOSAIC_LEADS = {
    "group_2": {_CHAIN: {_GROUP: "constexpr int kMosaicGroup = 2;"}},
    "group_8": {_CHAIN: {_GROUP: "constexpr int kMosaicGroup = 8;"}},
    "chunk_8": {_CHAIN: {_GROUP: "constexpr int kMosaicGroup = 2;",
                         _CHUNK: "constexpr int kMosaicChunk = 8;"}},
    "layer_lanes": {_CHAIN: {_GROUP: "constexpr int kMosaicGroup = 8;",
                             _CHUNK: "constexpr int kMosaicChunk = 1;"}},
    "mosaic_bounds_3": {
        _RUN: {_K1_DECL: "__global__ void __launch_bounds__(256, kStages >= 2 ? 3 : 1) "
                         "fused_trace_kernel("},
        _K3: {_K3_DECL: "__global__ void __launch_bounds__(256, kStages >= 2 ? 3 : 1) "
                        "trace_only_kernel("}},
    "cheb_spread": {_CHAIN: {_SPREAD: "xrt_mosaic<true>("}},
    "cheb_spread_bounds_2": {
        _CHAIN: {_SPREAD: "xrt_mosaic<true>("},
        _RUN: {_K1_DECL: "__global__ void __launch_bounds__(256, kCheb && kStages >= 2 ? 2 : 1) "
                         "fused_trace_kernel("},
        _K3: {_K3_DECL: "__global__ void __launch_bounds__(256, kCheb && kStages >= 2 ? 2 : 1) "
                        "trace_only_kernel("}},
}
# K3's leads, each alone: (c) the next grid-stride ray's 29 bytes loaded
# into registers before the current ray is traced; (b) blocks of 128
# threads (36 warps a multiprocessor at 55 registers, not 32), and those
# held to 40 warps by launch bounds; (a) each block's tiles of 256 rays
# staged in shared memory by the Tensor Memory Accelerator (1-D
# cp.async.bulk copies completing on an mbarrier, two buffers), the next
# tile's while this one is traced, the ragged last tile read as before.
_K3_LOOP = """    for (long long r0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
         r0 < n; r0 += stride) {
        const long long r = r0 + lane;
        const RayIn in = xrt_load_ray<kStages>(r, n, origin, direction, wavelength, mask,
                                               weight);
"""
_K3_PREFETCH = """    long long r0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
    RayIn ahead = xrt_load_ray<kStages>(r0 + lane, n, origin, direction, wavelength, mask,
                                        weight);
    for (; r0 < n; r0 += stride) {
        const long long r = r0 + lane;
        const RayIn in = ahead;
        if (r0 + stride < n) {
            ahead = xrt_load_ray<kStages>(r + stride, n, origin, direction, wavelength,
                                          mask, weight);
        }
"""
_K3_TMA = """    constexpr int T = 256;
    __shared__ __align__(128) float s_org[2][3 * T];
    __shared__ __align__(128) float s_dir[2][3 * T];
    __shared__ __align__(128) float s_wl[2][T];
    __shared__ __align__(128) float s_wt[2][T];
    __shared__ __align__(128) unsigned char s_mk[2][T];
    __shared__ __align__(8) unsigned long long s_bar[2];
    const bool wt_on = kStages >= 1 && weight != nullptr;
    const bool staged = blockDim.x == T &&
        (((uintptr_t)origin | (uintptr_t)direction | (uintptr_t)wavelength |
          (uintptr_t)mask | (uintptr_t)(wt_on ? weight : origin)) & 15) == 0;
    const long long whole = staged ? n / T : 0;  // the tiles the TMA stages
    if (threadIdx.x == 0) {
        for (int b = 0; b < 2; ++b) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::
                         "r"((unsigned)__cvta_generic_to_shared(&s_bar[b])));
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    auto issue = [&](long long tile, int b) {
        const unsigned bar = (unsigned)__cvta_generic_to_shared(&s_bar[b]);
        const unsigned bytes = (29u + (wt_on ? 4u : 0u)) * T;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(bar), "r"(bytes) : "memory");
        auto copy = [&](void* dst, const void* src, unsigned size) {
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                "[%0], [%1], %2, [%3];" ::
                "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(size),
                "r"(bar) : "memory");
        };
        copy(s_org[b], origin + 3 * tile * T, 12u * T);
        copy(s_dir[b], direction + 3 * tile * T, 12u * T);
        copy(s_wl[b], wavelength + tile * T, 4u * T);
        copy(s_mk[b], mask + tile * T, 1u * T);
        if (wt_on) copy(s_wt[b], weight + tile * T, 4u * T);
    };
    const long long n_tiles = (n + T - 1) / T;
    if (threadIdx.x == 0 && blockIdx.x < whole) issue(blockIdx.x, 0);
    int it = 0;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
        const int b = it & 1;
        if (threadIdx.x == 0 && tile + gridDim.x < whole) issue(tile + gridDim.x, b ^ 1);
        const long long r = tile * T + threadIdx.x;
        RayIn in;
        if (tile < whole) {
            const unsigned bar = (unsigned)__cvta_generic_to_shared(&s_bar[b]);
            unsigned done = 0;
            while (!done) {
                asm volatile(
                    "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
                    "selp.u32 %0, 1, 0, p; }"
                    : "=r"(done) : "r"(bar), "r"((it >> 1) & 1) : "memory");
            }
            const int t = threadIdx.x;
            in.px = s_org[b][3 * t];
            in.py = s_org[b][3 * t + 1];
            in.pz = s_org[b][3 * t + 2];
            in.dx = s_dir[b][3 * t];
            in.dy = s_dir[b][3 * t + 1];
            in.dz = s_dir[b][3 * t + 2];
            in.wl = s_wl[b][t];
            in.alive = s_mk[b][t] != 0;
            in.wt = wt_on ? s_wt[b][t] : 1.0f;
        } else {
            in = xrt_load_ray<kStages>(r, n, origin, direction, wavelength, mask, weight);
        }
"""
_K3_LOOP_END = """                                        s_counts, img, lane);
    }
"""
K3_LEADS = {
    "k3_prefetch": {_K3: {_K3_LOOP: _K3_PREFETCH}},
    "k3_blocks_128": {_K3: {_K3_THREADS: _K3_THREADS.replace("256", "128")}},
    "k3_bounds_40": {_K3: {
        _K3_THREADS: _K3_THREADS.replace("256", "128"),
        _K3_DECL: "__global__ void __launch_bounds__(128, kStages < 2 ? 10 : 1) "
                  "trace_only_kernel("}},
    "k3_tma": {_K3: {_K3_LOOP: _K3_TMA,
                     _K3_LOOP_END: _K3_LOOP_END.replace("lane);\n    }",
                                                        "lane);\n        __syncthreads();\n    }")}},
}
# Each lead of K5f's redesign undone alone, or put back where it was dropped:
# K5f's rays leaving the chain once dead or of zero weight; K5f without
# launch bounds in every variant, or with them on the torus variants too;
# K5f in blocks of 256
# only, whatever its image (example 08's 80 KB); K5f adding zero corners;
# the Philox word indexed at run time (local memory); separate sinf and
# cosf of one angle; example 08's image in global memory instead of shared.
_FWD = os.path.join("xicsrt_tpu_torch", "csrc", "fused_grad.cu")
_COMMON = os.path.join("xicsrt_tpu_torch", "csrc", "trace_common.cuh")
LEADS_UNDONE = {
    "early_exit": {_FWD: {
        "for (int e = 0; e < n_opt; ++e) {":
            "for (int e = 0; e < n_opt && st.alive && st.w != 0.0f; ++e) {"}},
    "bounds_none": {_FWD: {
        "!kTorus && (kSource == XRT_GRAD_POINT ||": "false && (kSource == XRT_GRAD_POINT ||"}},
    "bounds_torus": {_FWD: {
        "!kTorus && (kSource == XRT_GRAD_POINT ||": "(kSource == XRT_GRAD_POINT ||"}},
    "blocks_256": {_FWD: {
        "for (int t = 256; t <= 1024; t *= 2) {": "for (int t = 256; t <= 256; t *= 2) {"}},
    "corners_all": {_FWD: {
        "if (ix < 0 || ix >= nx || wx == 0.0f) continue;": "if (ix < 0 || ix >= nx) continue;",
        "if (iy < 0 || iy >= ny || v == 0.0f) continue;": "if (iy < 0 || iy >= ny) continue;"}},
    "words_indexed": {_COMMON: {
        "words[2];\n        return (float)(((k & 2) ? hi : lo) >> 8) * (1.0f / 16777216.0f);":
            "words[2];\n        return (float)(words[k & 3] >> 8) * (1.0f / 16777216.0f);"}},
    "separate_trig": {_COMMON: {
        "    sincosf(x, &s, &c);": "    s = sinf(x);\n    c = cosf(x);"}},
    "image_l2": {_FWD: {
        "kFwdSmemImageMax = XRT_SMEM_IMAGE_MAX_FLOATS;": "kFwdSmemImageMax = 16384;"}},
}
# The split of K1's time (times only, not leads): every ray killed right
# after its source, the chain not traced (the source's count is checked);
# every live plasma ray given bundle 0, the lookup skipped (wrong counts,
# not checked).
_K1_CHAIN = """        const bool found = xrt_trace_chain<kCheb, kStages, XrtNoRecord, kShapes>(
            fp, ip, aux, draw, px, py, pz, dx, dy, dz, wl, per_ray_wl, alive, 1.0f,
            s_counts, img, lane);
"""
_LOOKUP = "const int b = xrt_warp_bundle(cum_j, n_bundles, local, alive, lane);"
SPLIT_LAYOUTS = {
    "source_only": {_RUN: {_K1_CHAIN: """        const bool found =
            alive && px + py + pz + dx + dy + dz + wl == 1.0e30f;
        xrt_count_reach(s_counts, found ? 1 : 0, lane);
"""}},
    "skip_lookup": {_RUN: {_LOOKUP: "const int b = 0;"}},
}
# The leads of K1b's and the plasma's redesign, each undone alone on the
# checkout (which holds those that paid), or tried where it was dropped.
# K1b: (1a) one build per source kind: undone, a point build holds the
# plasma's sampler beside its own and the generic build both, chosen at
# run time as before; (1b) isotropic_xy_asym's Newton out of line, which
# was dropped (the call's saved registers spill): put back; (1c) both
# Philox calls of a plasma ray's draws issued before the bundle search and
# the sampler's math: undone, each at its first draw; and in the generic
# sampler, where they were dropped: put back. The plasma:
# (2a) the warp's 32-ary bundle search: undone, each lane's binary search;
# (2b) the plasma build in blocks of 128 threads, or held by launch bounds
# to 5 or 6 blocks of 256 (40 or 48 warps a multiprocessor).
_COMMON_SRC = os.path.join("xicsrt_tpu_torch", "csrc", "trace_common.cuh")
_K1_THREADS = "    return src == XRT_K1_POINT && cheb && stages == 1 ? 128 : 256;"
_PLASMA_BOUNDS = ("__global__ void __launch_bounds__(256, kSrc == XRT_K1_PLASMA ? {} : 1) "
                  "fused_trace_kernel(")
# (2d) Two plasma rays a thread in the plasma build without further
# stages: the warp's 64 rays r0 + lane and r0 + 32 + lane, each through the
# source and the chain, and a torus first in the chain taking both rays'
# roots at once, their four Newton steps interleaved (xrt_torus_hit2, the
# same float32 operations as xrt_torus_root in the same order).
_CHAIN_SIG = "    int lane, Rec rec = Rec()) {"
_CHAIN_TORUS = "            t = xrt_torus_hit(o, px, py, pz, dx, dy, dz, alive, &m_int);"
_RUN_NS = "namespace {\n\n// K1's kernel parameters"
_RUN_LOOP = """    // Whole warps step together (blockDim is a multiple of 32), so every
    // lane reaches every __ballot_sync; lanes past the end carry dead rays.
"""
_TORUS2 = """namespace {

__device__ __forceinline__ void xrt_torus_hit2(const float* o, const float (&p)[2][6],
                                               const bool (&alive)[2], float (&t)[2],
                                               int (&hit)[2]) {
    float olx[2], oly[2], olz[2], dlx[2], dly[2], dlz[2], s[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const float rx = p[i][0] - o[12], ry = p[i][1] - o[13], rz = p[i][2] - o[14];
        olx[i] = rx * o[3] + ry * o[4] + rz * o[5];
        oly[i] = rx * o[6] + ry * o[7] + rz * o[8];
        olz[i] = rx * o[9] + ry * o[10] + rz * o[11];
        dlx[i] = p[i][3] * o[3] + p[i][4] * o[4] + p[i][5] * o[5];
        dly[i] = p[i][3] * o[6] + p[i][4] * o[7] + p[i][5] * o[8];
        dlz[i] = p[i][3] * o[9] + p[i][4] * o[10] + p[i][5] * o[11];
        const float z0 = (p[i][0] - o[0]) * o[9] + (p[i][1] - o[1]) * o[10] +
                         (p[i][2] - o[2]) * o[11];
        t[i] = -z0 / (fabsf(dlz[i]) > 1e-9f ? dlz[i] : 1e-9f);
        s[i] = 0.0f;
    }
    const float r_maj = o[15], rmin2 = o[XRT_O_RMIN2];
    for (int it = 0; it < 4; ++it) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float X = olx[i] + t[i] * dlx[i], Y = oly[i] + t[i] * dly[i],
                        Z = olz[i] + t[i] * dlz[i];
            const float s2 = fmaxf(X * X + Z * Z, 1e-30f);
            const float inv_rho = inv_sqrt(s2);
            const float rr = s2 * inv_rho - r_maj;
            const float G = rr * rr + Y * Y - rmin2;
            const float rhop = (X * dlx[i] + Z * dlz[i]) * inv_rho;
            const float Gp = 2.0f * rr * rhop + 2.0f * Y * dly[i];
            const float rhopp = ((dlx[i] * dlx[i] + dlz[i] * dlz[i]) - rhop * rhop) * inv_rho;
            const float Gpp = 2.0f * (rhop * rhop + rr * rhopp) + 2.0f * dly[i] * dly[i];
            const float disc = Gp * Gp - 2.0f * Gpp * G;
            const float sgn = Gp >= 0.0f ? 1.0f : -1.0f;
            float dq = Gp + sgn * sqrtf(fmaxf(disc, 0.0f));
            dq = fabsf(dq) > 1e-12f ? dq : sgn * 1e-12f;
            const float gp_safe = fabsf(Gp) > 1e-12f ? Gp : sgn * 1e-12f;
            s[i] = G / (disc >= 0.0f ? 0.5f * dq : gp_safe);
            t[i] = t[i] - s[i];
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const bool h = alive[i] && fabsf(s[i]) < o[XRT_O_TOL] && t[i] > 1e-6f;
        hit[i] = h ? 1 : 0;
        t[i] = h ? t[i] : 0.0f;
    }
}

// K1's kernel parameters"""
_PAIR_LOOP = _RUN_LOOP + """    if constexpr (kSrc == XRT_K1_PLASMA && !kCheb && kStages == 0 && !kMark) {
        const bool torus0 = n_opt > 0 && ip[XRT_HDR_I] == 2;
        for (long long r0 = 2 * ((long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31));
             r0 < n_total; r0 += 2 * stride) {
            Draws d[2] = {
                {uniforms, n_total, min(r0 + lane, n_total - 1), seed0, seed1, 0, -1,
                 {0u, 0u, 0u, 0u}},
                {uniforms, n_total, min(r0 + 32 + lane, n_total - 1), seed0, seed1, 0, -1,
                 {0u, 0u, 0u, 0u}}};
            float p[2][6], wl[2];
            bool alive[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                alive[i] = xrt_k1_source<kSrc>(fp, ip, voxel, cauchy, d[i], r0 + 32 * i + lane,
                                               count, cum, table, n_bundles, n_per_iter, lane,
                                               p[i][0], p[i][1], p[i][2], p[i][3], p[i][4],
                                               p[i][5], wl[i]);
                xrt_count_source(s_counts, alive[i], lane);
            }
            float t[2] = {0.0f, 0.0f};
            int hit[2] = {-1, -1};
            if (torus0) xrt_torus_hit2(fp + XRT_SRC_F, p, alive, t, hit);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                xrt_trace_chain<kCheb, kStages>(fp, ip, aux, d[i], p[i][0], p[i][1], p[i][2],
                                                p[i][3], p[i][4], p[i][5], wl[i], per_ray_wl,
                                                alive[i], 1.0f, s_counts, img, lane,
                                                XrtNoRecord(), t[i], hit[i]);
            }
        }
    } else
"""
PAIR_LEAD = {"torus_pairs": {
    _CHAIN: {_CHAIN_SIG: "    int lane, Rec rec = Rec(), float pre_t = 0.0f, int pre_hit = -1) {",
             _CHAIN_TORUS: "            if (e == 0 && pre_hit >= 0) {\n"
                           "                t = pre_t;\n"
                           "                m_int = pre_hit != 0;\n"
                           "            } else {\n    " + _CHAIN_TORUS + "\n            }"},
    _RUN: {_RUN_NS: _TORUS2, _RUN_LOOP: _PAIR_LOOP}}}
_ASYM_NEWTON = """        const float target = c[4] + u * c[5];
        float sx = c[0] + u * c[1];
        for (int it = 0; it < 12; ++it) {
            const float a1 = sx * c[3], a0 = sx * c[2];
            const float gm = xrt_asin_poly(a1) - xrt_asin_poly(a0);
            const float dg = c[3] * inv_sqrt(fmaxf(1.0f - a1 * a1, 1e-12f)) -
                             c[2] * inv_sqrt(fmaxf(1.0f - a0 * a0, 1e-12f));
            sx = fminf(fmaxf(sx - (gm - target) / fmaxf(dg, 1e-12f), c[0]), c[10]);
        }
        xrt_xy_tail(sx, v, c + 6, lx, ly, lz);
"""
_AIM_DOC = "// (dx, dy, dz): the local direction (lx, ly, lz) in the per-ray basis"
_ASYM_FN = ("static __device__ __noinline__ float xrt_xy_asym_sx(const float* c, float u) {\n"
            + _ASYM_NEWTON.replace("        xrt_xy_tail(sx, v, c + 6, lx, ly, lz);\n",
                                   "        return sx;\n").replace("\n        ", "\n    ")
            [4:] + "}\n\n")
_SAMPLE_DECL = """template <bool kFull>
__device__ __forceinline__ void xrt_sample_source(const float* fp, const int* ip,
                                                  Draws& draw,"""
_SAMPLE_DECL_D = _SAMPLE_DECL.replace("<bool kFull>", "<bool kFull, class D>").replace(
    "Draws& draw,", "D& draw,")
K1B_LEADS = {
    "src_shared": {_RUN: {
        "const bool plasma = kSrc == XRT_K1_ANY ? ip[5] == XRT_SRC_PLASMA : kSrc == "
        "XRT_K1_PLASMA;": "const bool plasma = ip[5] == XRT_SRC_PLASMA;",
        "    if (kSrc == XRT_K1_POINT) {": "    if (kSrc == XRT_K1_POINT && !plasma) {",
        "const int src = cum != nullptr ? XRT_K1_PLASMA\n                                   : "
        "full_source ? XRT_K1_GENERIC : XRT_K1_POINT;":
            "const int src = full_source ? XRT_K1_GENERIC : XRT_K1_POINT;"}},
    "asym_noinline": {_COMMON_SRC: {
        _ASYM_NEWTON: "        xrt_xy_tail(xrt_xy_asym_sx(c, u), v, c + 6, lx, ly, lz);\n",
        _AIM_DOC: _ASYM_FN + _AIM_DOC}},
    "philox_lazy": {_COMMON_SRC: {
        "two(two_groups && draws.uniforms == nullptr)": "two(false)"}},
    "philox_generic": {_COMMON_SRC: {_SAMPLE_DECL: _SAMPLE_DECL_D}, _RUN: {
        "    xrt_sample_source<true>(fp, ip, draw, px, py, pz, dx, dy, dz, wl, keep);\n":
            "    DrawsAhead ahead(draw, ip[3] > 4);\n"
            "    xrt_sample_source<true>(fp, ip, ahead, px, py, pz, dx, dy, dz, wl, keep);\n"
            "    ahead.finish();\n"}},
}
PLASMA_LEADS = {
    "search_serial": {_RUN: {
        _LOOKUP: "const int b = alive ? min(xrt_upper_bound(cum_j, n_bundles, local), "
                 "n_bundles - 1) : 0;"}},
    "plasma_blocks_128": {_RUN: {
        _K1_THREADS: _K1_THREADS.replace(": 256;", ": src == XRT_K1_PLASMA ? 128 : 256;")}},
    "plasma_bounds_5": {_RUN: {_K1_DECL: _PLASMA_BOUNDS.format(5)}},
    "plasma_bounds_6": {_RUN: {_K1_DECL: _PLASMA_BOUNDS.format(6)}},
}
# The leads of K1a's and K2's redesign, each undone alone on the checkout
# (which holds those that paid), or tried where it was dropped. K1a: (a)
# the images staged in shared memory whenever they fit, as before, though
# it costs a resident block; (b) no warp leaving the chain once its lanes
# are dead, or warps leaving it in every build, not only those without
# further stages; (c) every point build with the torus and cylinder code, the
# point build without it free of launch bounds (76 registers), or held to
# 4 blocks of 256 (64 registers), not 5 (48). K2:
# (a) a launch an image; (b) the mask read a byte at a time; (c) unit
# weights added as floats (a compare-and-swap loop in shared memory).
_PB = os.path.join("xicsrt_tpu_torch", "ops", "pallas_binning.py")
_SKIP = "        if (vote && !__any_sync(0xffffffffu, alive)) break;\n"
_SKIP_BUILDS = "    constexpr bool kSkip = !Rec::kOn && !kCheb && kStages <= 1;"
_FLAT_BOUNDS = "__launch_bounds__(256, kStages == 0 ? 5 : 4)\n    fused_trace_flat_kernel("
_FLAT = "        src == XRT_K1_POINT && !cheb && stages <= 1 && !(shapes & XRT_SHAPES_TORUS);"


def _flat_bounds(blocks: str) -> str:
    return _FLAT_BOUNDS.replace("kStages == 0 ? 5 : 4", blocks)


K1A_LEADS = {
    "staged_images": {_RUN: {"           staged < unstaged - spare;": "           false;"}},
    "no_warp_skip": {_CHAIN: {_SKIP: ""}},
    "skip_all_builds": {_CHAIN: {_SKIP_BUILDS: "    constexpr bool kSkip = !Rec::kOn;",
                                 "    const bool vote = kSkip && !weight;":
                                 "    const bool vote = kSkip;"}},
    "curved_all": {_RUN: {_FLAT: "        false;"}},
    "flat_unbounded": {_RUN: {_FLAT_BOUNDS: _flat_bounds("kStages == 0 ? 1 : 4")}},
    "k1a_bounds_4": {_RUN: {_FLAT_BOUNDS: _flat_bounds("4")}},
}
# The leads of K1d's redesign (the kStages 1 builds of K1: weight mode and
# bilinear images), each undone alone on the checkout, or tried where it
# was dropped: (1) weighted and bilinear images staged in each block's
# float32 shared histogram where they fit, flushed into the float64
# pixels, as before (costing the flagship a resident block); or split
# over a cluster of 2 blocks (distributed shared memory: each block holds
# half the pixels, every term an atomic in the owning block's half,
# flushed once a cluster); (2) terms of zero issued; (3) the flagship's
# weight and bilinear runs in the build with the torus and cylinder code;
# (4) the flat build of kStages 1 held to 5 blocks of 256 (48 registers),
# or unbounded, where the checkout holds it to 4 (64); (5) no warp vote in
# mc runs of kStages 1. Where the checkout keeps staging (the point build
# of kStages 1 with the torus and cylinder code), `k1d_curved_unstaged`
# takes it away; `k1d_cheb_256` and `k1d_cheb_160` launch the point
# Chebyshev build of kStages 1 in blocks of 256 or 160 threads (2 or 4 a
# multiprocessor), not 128 (5).
_STAGED = ("    if (stages >= 1 && !staged_float64) return pick;  "
           "// float64 sums in global memory\n")
_STAGED_CURVED = "    const bool staged_float64 = build == 1 || build == kXrtK1Cylinder + 1;"
_K_STAGED = ("    constexpr bool kStaged = kSrc == XRT_K1_POINT && !kCheb && kStages == 1 "
             "&& kShapes != 0;")
_STAGE_ALL = """    if (stages >= 1) {
        const size_t b = (size_t)img_total * sizeof(float);
        if (img_total <= XRT_SMEM_IMAGE_MAX_FLOATS &&
            xrt_set_smem(pick.kernel, b) == cudaSuccess) {
            pick.smem = b;
            pick.use_smem = 1;
        }
        return pick;
    }
"""
_STAGE_HALF = """    if (stages >= 1) {
        const size_t b = (size_t)((img_total + 1) / 2) * sizeof(float);
        if ((img_total + 1) / 2 <= XRT_SMEM_IMAGE_MAX_FLOATS &&
            xrt_set_smem(pick.kernel, b) == cudaSuccess) {
            pick.smem = b;
            pick.use_smem = 1;
        }
        return pick;
    }
"""
_STAGED_IMAGE = """    float* staged = nullptr;
    __device__ __forceinline__ void add(int i, float v) const {
        if (staged != nullptr) {
            atomicAdd(staged + i, v);
        } else {"""
_CLUSTER_IMAGE = """    float* staged = nullptr;
    int half = 0;
    __device__ __forceinline__ void add(int i, float v) const {
        if (staged != nullptr) {
            const int rank = i / half;
            atomicAdd(cooperative_groups::this_cluster().map_shared_rank(staged, rank) +
                          (i - rank * half), v);
        } else {"""
_BODY_IMG = "        if (use_smem) img.staged = s_img;\n"
_BODY_ZERO = """    } else if constexpr (kStages == 0 || kStaged) {
        if (use_smem) xrt_smem_zero(s_img, img_total);
    }
    __syncthreads();
"""
_CLUSTER_ZERO = """    }
    const int half = (img_total + 1) / 2;
    const bool split = kStages >= 1 && use_smem;
    if (use_smem) xrt_smem_zero(s_img, split ? half : img_total);
    if (split) {
        cooperative_groups::this_cluster().sync();
    } else {
        __syncthreads();
    }
"""
_BODY_END = """    __syncthreads();
    xrt_flush_counts(s_counts, n_opt, counts);"""
_CLUSTER_END = """    if (split) {
        cooperative_groups::this_cluster().sync();
    } else {
        __syncthreads();
    }
    xrt_flush_counts(s_counts, n_opt, counts);"""
_BODY_FLUSH = """    } else if constexpr (kStages == 0 || kStaged) {
        if (use_smem) xrt_smem_flush(s_img, out, img_total);
    }
"""
_CLUSTER_FLUSH = """    } else if constexpr (kStages == 0) {
        if (use_smem) xrt_smem_flush(s_img, out, img_total);
    } else if (split) {
        const int rank = (int)cooperative_groups::this_cluster().block_rank();
        xrt_smem_flush(s_img, out + rank * half, min(half, img_total - rank * half));
    }
"""
_LAUNCH = """    const int blocks = xrt_grid_size(pick.kernel, pick.threads, pick.smem, n_total);
    pick.kernel<<<blocks, pick.threads, pick.smem, (cudaStream_t)stream>>>("""
_CLUSTER_LAUNCH = """    int blocks = xrt_grid_size(pick.kernel, pick.threads, pick.smem, n_total);
    if (stages >= 1 && pick.use_smem) {
        blocks = blocks > 2 ? blocks & ~1 : 2;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(blocks);
        cfg.blockDim = dim3(pick.threads);
        cfg.dynamicSmemBytes = pick.smem;
        cfg.stream = (cudaStream_t)stream;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = 2;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        cudaLaunchKernelEx(&cfg, pick.kernel, fp, n_fp, ip, n_ip, aux, n_total, count,
                           uniforms, seed0, seed1, cum, table, n_bundles, (int)n_per_iter,
                           counts, images, img_total, pick.use_smem, marks, chunk);
        return (int)cudaGetLastError();
    }
    pick.kernel<<<blocks, pick.threads, pick.smem, (cudaStream_t)stream>>>("""
_CHAIN_INCLUDE = '#include "binning.cuh"\n#include "trace_common.cuh"\n'
_ZERO_NEAREST = "        if (oi[7] >= 0 && alive && (kStages == 0 || wt != 0.0f)) {"
_ZERO_CORNER = "            if (v != 0.0f) img.add(base + (int)xi * ny + (int)yi, v);"
K1D_LEADS = {
    "k1d_staged": {_RUN: {_STAGED: _STAGE_ALL, _K_STAGED: "    constexpr bool kStaged = kStages >= 1;"}},
    "k1d_cluster": {
        _RUN: {_STAGED: _STAGE_HALF, _K_STAGED: "    constexpr bool kStaged = kStages >= 1;",
               _BODY_ZERO: _CLUSTER_ZERO, _BODY_END: _CLUSTER_END, _BODY_FLUSH: _CLUSTER_FLUSH,
               _LAUNCH: _CLUSTER_LAUNCH, _BODY_IMG: _BODY_IMG + "        img.half = half;\n"},
        _CHAIN: {_STAGED_IMAGE: _CLUSTER_IMAGE,
                 _CHAIN_INCLUDE: _CHAIN_INCLUDE + "\n#include <cooperative_groups.h>\n"}},
    "k1d_curved_unstaged": {_RUN: {_K_STAGED: "    constexpr bool kStaged = false;",
                                   _STAGED_CURVED: "    const bool staged_float64 = false;"}},
    "k1d_no_zero_skip": {_CHAIN: {
        _ZERO_NEAREST: "        if (oi[7] >= 0 && alive) {",
        _ZERO_CORNER: "            img.add(base + (int)xi * ny + (int)yi, v);"}},
    "k1d_curved": {_RUN: {_FLAT: _FLAT.replace("stages <= 1", "stages == 0")}},
    "k1d_bounds_5": {_RUN: {_FLAT_BOUNDS: _flat_bounds("5")}},
    "k1d_unbounded": {_RUN: {_FLAT_BOUNDS: _flat_bounds("kStages == 0 ? 5 : 1")}},
    "k1d_cheb_256": {_RUN: {_K1_THREADS: _K1_THREADS.replace("128", "256")}},
    "k1d_cheb_160": {_RUN: {_K1_THREADS: _K1_THREADS.replace("128", "160")}},
    "k1d_no_vote": {_CHAIN: {_SKIP_BUILDS: _SKIP_BUILDS.replace("kStages <= 1",
                                                                "kStages == 0")}},
}
K2_LEADS = {
    "k2_per_image": {_PB: {"    if len(items) > MAX_ITEMS:": "    if len(items) > 1:",
                           "items[:MAX_ITEMS], unit_weights)": "items[:1], unit_weights)",
                           "items[MAX_ITEMS:], unit_weights))": "items[1:], unit_weights))"}},
    "k2_mask_bytes": {os.path.join("xicsrt_tpu_torch", "csrc", "bin_image.cu"): {
        "    if (aligned && r0 + 16 <= n) return": "    if (false) return"}},
    "k2_float_atomics": {_PB: {"0 if unit_weights else w.data_ptr()": "w.data_ptr()",
                               "            int(unit_weights), out.data_ptr()":
                               "            0, out.data_ptr()"}},
}
# K1e's leads. What a chunk mark costs the marking body of K1's kMark
# builds (the fallback, and the parent's every 'found' run): the
# warp's ballot kept (its bits or-ed into a register, stored never) and
# the store dropped; the store issued only where a load of the mark finds
# it clear (`mark_test_first`); or the chunk's index by the 64-bit division
# of the parent. The marked build in place of the probe (`k1e_marked`: K1
# marks every chunk, as the parent did). The host reading the probe's flag
# before K1 (`probe_host_read`: K1's build without marks alone where the
# probe found the kept chunks, at the cost of a wait for the probe, in
# place of both builds, the flag picking one on the card). The probe's
# first kept parameters (`probe_64_from_2_26`: 1/64 of the run, from 2^26
# rays). The split's one
# copy through pinned memory, the arrays views of it (`split_pinned_view`,
# which keeps the pinned buffer alive as long as the arrays), or copied out
# of it (`split_pinned_copy`), in place of one pageable copy.
_FT = os.path.join("xicsrt_tpu_torch", "ops", "fused_trace.py")
# The flagship's detector narrowed until about one chunk of 8192 rays in
# 700 keeps a ray (3 of the first 2048 on the twin): K1e's fallback at its
# worst. PROBE_MIN_RAYS above every run: the probe never runs.
RARE_DETECTOR_XSIZE = 0.0276
NEVER = 1 << 62
_ENGINE = os.path.join("xicsrt_tpu_torch", "engine.py")
_MARK = """            if (__ballot_sync(0xffffffffu, found) && lane == 0) {
                marks[(unsigned int)r0 / (unsigned int)chunk] = 1;
            }
"""
_LOOP = "    for (long long r0 = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);\n"
_HOST_COPY = "    raw = buf.cpu().numpy()\n"
_PINNED = """    if buf.is_cuda:
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=True).copy_(buf)
"""
K1E_LEADS = {
    "mark_ballot_only": {_RUN: {
        _LOOP: "    unsigned int voted = 0u;\n" + _LOOP,
        _MARK: "            voted |= __ballot_sync(0xffffffffu, found);\n",
        _BODY_END: "    if (kMark && voted == 0x9e3779b9u && chunk < 0) marks[0] = 1;\n"
                   + _BODY_END}},
    "mark_test_first": {_RUN: {_MARK: """            if (__ballot_sync(0xffffffffu, found) && lane == 0) {
                const unsigned int c = (unsigned int)r0 / (unsigned int)chunk;
                if (__ldcg(marks + c) == 0) marks[c] = 1;
            }
"""}},
    "mark_div64": {_RUN: {_MARK: _MARK.replace("(unsigned int)r0 / (unsigned int)chunk",
                                               "r0 / chunk")}},
    "k1e_marked": {_FT: {"PROBE_MIN_RAYS = 1 << 28\n": "PROBE_MIN_RAYS = 1 << 62\n"}},
    "probe_64_from_2_26": {_FT: {"PROBE_MIN_RAYS = 1 << 28\n": "PROBE_MIN_RAYS = 1 << 26\n",
                                 "PROBE_SHARE = 1024\n": "PROBE_SHARE = 64\n"}},
    "probe_host_read": {_FT: {"    if marks is None:\n        err = lib.xrt_fused_trace(":
                              "    if marks is None or probed and int(marks[-1]):\n"
                              "        err = lib.xrt_fused_trace("}},
    "split_pinned_view": {_ENGINE: {_HOST_COPY: _PINNED + "    raw = buf.numpy()\n"}},
    "split_pinned_copy": {_ENGINE: {_HOST_COPY: _PINNED + "    raw = buf.numpy().copy()\n"}},
}
# K1c-mirror's and K1c-cylinder's split layouts (times only) and leads: the
# nearest image adds removed (`no_image_adds`: what the adds cost a chain
# whose rays stay alive); the cylinder compiled into K1a's flat build and
# the cylinder chains taking it (`cylinder_flat`: what the torus code cost
# them); each lead of the redesign undone: the cylinder chains in the
# general build with the torus code (`cylinder_curved`), the mirror chains
# of planes and spheres in K1a's build (`dense_off`), no window staged, the
# whole image where it costs no block alone (`window_off`), the window
# staged as float32 adds, each a compare-and-swap loop (`window_floats`);
# the cylinder build of kStages 0 held to 4 blocks, where its whole image
# stages (`cylinder_bounds_4`); a dense chain's whole image staged only
# where it costs no block, not one (`dense_spare_off`); and the window
# builds adding each pixel once a warp, the count of its lanes on it
# (`dense_match`: __match_any_sync on the pixel, a warp's peers adding
# once).
_IMG_ADD = "                    img.add(oi[7] + flat, kStages >= 1 ? wt : 1.0f);\n"
_POINT_BUILD = "    if (shapes) return kXrtK1Cylinder + stages;"
_WINDOW_ADD = "            atomicAdd(counts + k, 1u);\n"
_WINDOW_FLUSH = "            if (s_win[i]) atomicAdd(g + i, (float)s_win[i]);\n"
_WINDOW_IMAGE = "struct XrtWindowImage {\n    float* pix;\n"
_ZERO_TERMS = "        // A ray of weight zero adds terms of zero alone.\n"
_MATCH = """        if constexpr (std::is_same<Img, XrtWindowImage>::value) {
            if (oi[7] >= 0) {
                int flat = 0;
                const bool hit = alive && xrt_nearest_pixel(fmaf(lxv, o[23], o[24]),
                                                            fmaf(lyv, o[23], o[25]),
                                                            oi[8], oi[9], &flat);
                const unsigned int hits = __ballot_sync(0xffffffffu, hit);
                if (hit) {
                    const unsigned int peers = __match_any_sync(hits, flat);
                    if (lane == __ffs(peers) - 1) img.add_n(oi[7] + flat, __popc(peers));
                }
            }
            continue;
        }
"""
_ADD_N = """    __device__ __forceinline__ void add_n(int i, unsigned int c) const {
        const unsigned int k = (unsigned int)(i - lo);
        if (k < (unsigned int)n) {
            atomicAdd(counts + k, c);
        } else {
            atomicAdd(pix + i, (float)c);
        }
    }
"""
_WIN_ARGS = "            fparams.shapes, int(fparams.dense_images), *fparams.stage_window)"
K1C_LEADS = {
    "no_image_adds": {_CHAIN: {_IMG_ADD: "                    (void)flat;\n"}},
    "cylinder_flat": {_RUN: {
        "    xrt_fused_trace_body<XRT_K1_POINT, false, kStages, kMark, 0, false>(":
        "    xrt_fused_trace_body<XRT_K1_POINT, false, kStages, kMark, "
        "XRT_SHAPES_CYLINDER, false>(",
        _POINT_BUILD: "    if (shapes) return kXrtK1Flat + stages;"}},
    "cylinder_curved": {_RUN: {_FLAT: _FLAT.replace("!(shapes & XRT_SHAPES_TORUS)",
                                                    "!shapes")}},
    "dense_off": {_FT: {_WIN_ARGS: "            fparams.shapes, 0, *fparams.stage_window)"}},
    "window_off": {_FT: {_WIN_ARGS: "            fparams.shapes, int(fparams.dense_images), 0, 0)"}},
    "window_floats": {
        _CHAIN: {_WINDOW_ADD: "            atomicAdd(reinterpret_cast<float*>(counts) + k, v);\n"},
        _RUN: {_WINDOW_FLUSH: "            if (s_win[i]) atomicAdd(g + i, "
                              "reinterpret_cast<const float*>(s_win)[i]);\n"}},
    "cylinder_bounds_4": {_RUN: {
        "__launch_bounds__(256, kStages == 0 ? 5 : 4)\n    fused_trace_cylinder_kernel(":
        "__launch_bounds__(256, 4)\n    fused_trace_cylinder_kernel("}},
    "dense_spare_off": {_RUN: {"        const int spare[2] = {dense ? 1 : 0, 0};":
                               "        const int spare[2] = {0, 0};"}},
    "dense_match": {_CHAIN: {_CHAIN_INCLUDE: _CHAIN_INCLUDE + "\n#include <type_traits>\n",
                             _WINDOW_IMAGE: _WINDOW_IMAGE + _ADD_N,
                             _ZERO_TERMS: _MATCH + _ZERO_TERMS}},
}
# The order of K1's dynamic shared memory: the staged image or window at a
# fixed offset behind the counters, ip and fp after it (the checkout: ip
# and fp first, the image behind them).
HEAD_LEADS = {"head_image_first": {_RUN: {
    "    int* const ip = reinterpret_cast<int*>(s_dyn + XRT_HEAD_COUNTS);\n":
    "    float* const s_img = s_dyn + XRT_HEAD_COUNTS;\n"
    "    int* const ip = reinterpret_cast<int*>(\n"
    "        s_img + xrt_round4(kWindow ? win_n : (use_smem ? img_total : 0)));\n",
    "    float* const fp = s_dyn + XRT_HEAD_COUNTS + xrt_round4(n_ip);\n":
    "    float* const fp = reinterpret_cast<float*>(ip) + xrt_round4(n_ip);\n",
    "    float* const s_img = s_dyn + xrt_head_floats(n_fp, n_ip);\n": ""}},
    # fp at the fixed offset behind the counters, ip after it.
    "head_fp_first": {_RUN: {
        "    int* const ip = reinterpret_cast<int*>(s_dyn + XRT_HEAD_COUNTS);\n":
        "    float* const fp_first = s_dyn + XRT_HEAD_COUNTS;\n"
        "    int* const ip = reinterpret_cast<int*>(fp_first + xrt_round4(n_fp));\n",
        "    float* const fp = s_dyn + XRT_HEAD_COUNTS + xrt_round4(n_ip);\n":
        "    float* const fp = fp_first;\n"}}}

# The split of K1's cost a plate on long chains (``--long-only``, times
# only), each one change to the checkout's chain (trace_chain.cuh) or head:
# no per-element count, no warp vote before an element, apertures that
# return their bounds mask, and the packed floats read from __constant__
# memory (copied there before each launch) in place of the shared head.
_FP_HEAD = "    float* const fp = s_dyn + XRT_HEAD_COUNTS + xrt_round4(n_ip);\n"
_FP_CONST = "    const float* const fp = xrt_c_fp;\n"
_HEAD_LOAD = "    xrt_head_load(fp, g_fp, n_fp, ip, g_ip, n_ip, s_counts, XRT_HEAD_COUNTS);\n"
_HEAD_LOAD_IP = ("    xrt_head_load(nullptr, g_fp, 0, ip, g_ip, n_ip, s_counts, "
                 "XRT_HEAD_COUNTS);\n")
_COUNTS_DEF = "#define XRT_HEAD_COUNTS (XRT_MAX_OPTICS + 1)\n"
_C_FP = ("#define XRT_HEAD_COUNTS (XRT_MAX_OPTICS + 1)\n"
         "static __constant__ float xrt_c_fp[8192];\n")
_COPY_FP = ("    cudaMemcpyToSymbolAsync(xrt_c_fp, fp, (size_t)n_fp * sizeof(float), 0,\n"
            "                            cudaMemcpyDeviceToDevice, (cudaStream_t)stream);\n")
_K3_LAUNCH = "    const int blocks = xrt_grid_size(kernel, threads, smem, n);\n"
CHAIN_SPLIT = {
    "chain_no_count": {_CHAIN: {
        "    if constexpr (!Rec::kOn) xrt_count_reach(s_counts, reach, lane);\n": ""}},
    "chain_no_vote": {_CHAIN: {_SKIP: ""}},
    "chain_no_apertures": {_CHAIN: {
        "        bool mask = xrt_chain_apertures(apf, api, oi[6], oi[5], lxv, lyv, m_in);":
        "        bool mask = m_in;"}},
    "chain_params_const": {
        _COMMON: {_COUNTS_DEF: _C_FP},
        _RUN: {_FP_HEAD: _FP_CONST, _HEAD_LOAD: _HEAD_LOAD_IP, _LAUNCH: _COPY_FP + _LAUNCH},
        _K3: {_FP_HEAD: _FP_CONST, _HEAD_LOAD: _HEAD_LOAD_IP,
              _K3_LAUNCH: _COPY_FP + _K3_LAUNCH}},
}
# The lead of K1's redesign on long chains undone: the aperture test's
# switch over its logic codes and over its shapes, as it was before.
_APERTURES_NOW = """    bool m_out = m_in;
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
"""
_APERTURES_SWITCH = """    bool m_out = m_in;
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
"""
CHAIN_SPLIT["apertures_switch"] = {_COMMON: {_APERTURES_NOW: _APERTURES_SWITCH}}
# Leads of K1's redesign on long chains, tried as layouts: a plate (a
# plane with no interaction and no image) in a body of its own, one
# branch on warp-uniform ints; and the warp vote before every fourth
# element only, and before the last three.
_CHAIN_OI = "        const int* oi = ip + XRT_HDR_I + e * XRT_OPT_I;\n"
_PLATE = _CHAIN_OI + """        if (oi[0] == 0 && oi[2] == 0 && oi[7] < 0) {
            float denom;
            bool nz;
            const float t = xrt_plane_hit(o[0], o[1], o[2], o[9], o[10], o[11], px, py,
                                          pz, dx, dy, dz, &denom, &nz);
            const bool m_int = alive && t >= 0.0f && nz;
            const float qx = m_int ? px + t * dx : px;
            const float qy = m_int ? py + t * dy : py;
            const float qz = m_int ? pz + t * dz : pz;
            const float rx = qx - o[0], ry = qy - o[1], rz = qz - o[2];
            const float lxv = rx * o[3] + ry * o[4] + rz * o[5];
            const float lyv = rx * o[6] + ry * o[7] + rz * o[8];
            const bool m_in = xrt_bounds(m_int, oi[4], o + 16, lxv, lyv, rx, ry, rz, o[9],
                                         o[10], o[11]);
            alive = xrt_chain_apertures(apf, api, oi[6], oi[5], lxv, lyv, m_in);
            px = qx;
            py = qy;
            pz = qz;
            if constexpr (Rec::kOn) {
                rec(1 + e, px, py, pz, dx, dy, dz, alive, wt);
            } else {
                reach += alive;
            }
            continue;
        }
"""
CHAIN_SPLIT["plate_path"] = {_CHAIN: {_CHAIN_OI: _PLATE}}
CHAIN_SPLIT["vote_sparse"] = {_CHAIN: {_SKIP: _SKIP.replace(
    "if (vote && ", "if (vote && ((e & 3) == 0 || e + 3 >= n_opt) && ")}}
# The chain's path of its own for an optic's single aperture undone: every
# optic's apertures through xrt_apertures' loop.
_CHAIN_APERTURES = ("        bool mask = xrt_chain_apertures(apf, api, oi[6], oi[5], lxv, lyv, "
                    "m_in);")
CHAIN_SPLIT["apertures_loop"] = {_CHAIN: {
    _CHAIN_APERTURES: _CHAIN_APERTURES.replace("xrt_chain_apertures", "xrt_apertures")}}
# The reach histogram's warp aggregation by a loop of ballots over the
# distinct reaches in place of __match_any_sync.
_MATCH_ANY = """    const unsigned int peers = __match_any_sync(0xffffffffu, reach);
    if (reach > 0 && lane == __ffs(peers) - 1) {
        atomicAdd(s_counts + reach, (unsigned int)__popc(peers));
    }
"""
_BALLOT_LOOP = """    unsigned int todo = __ballot_sync(0xffffffffu, reach > 0);
    while (todo) {
        const int first = __ffs(todo) - 1;
        const int v = __shfl_sync(0xffffffffu, reach, first);
        const unsigned int peers = __ballot_sync(0xffffffffu, reach == v);
        if (lane == first) atomicAdd(s_counts + v, (unsigned int)__popc(peers));
        todo &= ~peers;
    }
"""
CHAIN_SPLIT["count_ballot_loop"] = {_CHAIN: {_MATCH_ANY: _BALLOT_LOOP}}
# The single aperture's path and xrt_apertures' loop as one function on
# shared helpers (xrt_apertures<kSingle>; rejected: K5f's generic-source variant
# spilled at its 64 registers), or with the first aperture peeled for
# every count in place of the single aperture's path (rejected: K1 6 %
# slower on baffle127, the marked builds spilled).
_APERTURE_FN = """// Aperture logic (ops/aperture.py) over apertures [first, first + count)
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

"""
_CHAIN_SINGLE = "        bool mask = xrt_chain_apertures(apf, api, oi[6], oi[5], lxv, lyv, m_in);"
_APERTURES_SHARED = """// Aperture a's shape test of a hit at local (lxv, lyv): the shapes by
// frequency, the baffles' circles first.
__device__ __forceinline__ bool xrt_aperture_test(const float* apf, const int* api, int a,
                                                  float lxv, float lyv) {
    const float ax = lxv - apf[a * XRT_AP_F];
    const float ay = lyv - apf[a * XRT_AP_F + 1];
    const float p0 = apf[a * XRT_AP_F + 2];
    const int shape = api[a * XRT_AP_I];
    if (shape == 1) return ax * ax + ay * ay < p0;
    if (shape == 2) return fabsf(ax) < p0 && fabsf(ay) < p0;
    if (shape == 3) return fabsf(ax) < p0 && fabsf(ay) < apf[a * XRT_AP_F + 3];
    if (shape == 0) return true;
    const float ex = ax / p0, ey = ay / apf[a * XRT_AP_F + 3];
    return ex * ex + ey * ey < 1.0f;
}

// Aperture a's logic applied to the running value m_out and its test: the
// logic's truth table, a nibble a code indexed by 2 m_out + test (0 and 8,
// 1 and-not 4, 2 or 0xE, 3 nand 7, 4 nor 1, 5 xor 6, else xnor 9), one
// shift in place of a switch over seven codes (chip_ab.py
// `apertures_switch`, PERF.md).
__device__ __forceinline__ bool xrt_aperture_logic(const int* api, int a, bool m_out,
                                                   bool test) {
    const unsigned int logic = min((unsigned int)api[a * XRT_AP_I + 1], 6u);
    return (0x9617E48u >> (4u * logic + 2u * m_out + test)) & 1u;
}

// Aperture logic (ops/aperture.py) over apertures [first, first + count)
// of the packed aperture block: m_in is the bounds mask, m_out the running
// value; updates apply only inside m_in. Returns m_out && m_in. kSingle:
// an optic of one aperture (a baffle plate's) takes a path of its own with
// no loop: m_out starts at m_in, so wherever the logic applies it reads
// (1, test). K1's and K3's chain takes it (K1 on baffle127 12 % faster,
// chip_ab.py `apertures_loop`), K5 does not; peeling the first aperture
// for every count in place of this path cost K1 6 % on baffle127 and
// spilled the marked builds (`apertures_peel`, PERF.md).
template <bool kSingle = false>
__device__ __forceinline__ bool xrt_apertures(const float* apf,
                                              const int* api, int first,
                                              int count, float lxv, float lyv,
                                              bool m_in) {
    if (kSingle && count == 1) {
        return m_in && xrt_aperture_logic(api, first, true,
                                          xrt_aperture_test(apf, api, first, lxv, lyv));
    }
    bool m_out = m_in;
    for (int a = first; a < first + count; ++a) {
        const bool test = xrt_aperture_test(apf, api, a, lxv, lyv) && m_in;
        const bool nv = xrt_aperture_logic(api, a, m_out, test);
        m_out = m_in ? nv : m_out;
    }
    return m_out && m_in;
}

"""
CHAIN_SPLIT["apertures_shared"] = {
    _COMMON: {_APERTURE_FN: _APERTURES_SHARED},
    _CHAIN: {_CHAIN_SINGLE: _CHAIN_SINGLE.replace("xrt_chain_apertures", "xrt_apertures<true>")}}
CHAIN_SPLIT["apertures_peel"] = {
    _COMMON: {_APERTURE_FN: """// Aperture a's shape test of a hit at local (lxv, lyv): the shapes by
// frequency, the baffles' circles first.
__device__ __forceinline__ bool xrt_aperture_test(const float* apf, const int* api, int a,
                                                  float lxv, float lyv) {
    const float ax = lxv - apf[a * XRT_AP_F];
    const float ay = lyv - apf[a * XRT_AP_F + 1];
    const float p0 = apf[a * XRT_AP_F + 2];
    const int shape = api[a * XRT_AP_I];
    if (shape == 1) return ax * ax + ay * ay < p0;
    if (shape == 2) return fabsf(ax) < p0 && fabsf(ay) < p0;
    if (shape == 3) return fabsf(ax) < p0 && fabsf(ay) < apf[a * XRT_AP_F + 3];
    if (shape == 0) return true;
    const float ex = ax / p0, ey = ay / apf[a * XRT_AP_F + 3];
    return ex * ex + ey * ey < 1.0f;
}

// Aperture a's logic applied to the running value m_out and its test: the
// logic's truth table, a nibble a code indexed by 2 m_out + test (0 and 8,
// 1 and-not 4, 2 or 0xE, 3 nand 7, 4 nor 1, 5 xor 6, else xnor 9), one
// shift in place of a switch over seven codes (chip_ab.py
// `apertures_switch`, PERF.md).
__device__ __forceinline__ bool xrt_aperture_logic(const int* api, int a, bool m_out,
                                                   bool test) {
    const unsigned int logic = min((unsigned int)api[a * XRT_AP_I + 1], 6u);
    return (0x9617E48u >> (4u * logic + 2u * m_out + test)) & 1u;
}

// Aperture logic (ops/aperture.py) over apertures [first, first + count)
// of the packed aperture block: m_in is the bounds mask, m_out the running
// value; updates apply only inside m_in. Returns m_out && m_in. kSingle:
// an optic of one aperture (a baffle plate's) takes a path of its own with
// no loop: m_out starts at m_in, so wherever the logic applies it reads
// (1, test). K1's and K3's chain takes it (K1 on baffle127 12 % faster,
// chip_ab.py `apertures_loop`), K5 does not; peeling the first aperture
// for every count in place of this path cost K1 6 % on baffle127 and
// spilled the marked builds (`apertures_peel`, PERF.md).
template <bool kSingle = false>
__device__ __forceinline__ bool xrt_apertures(const float* apf,
                                              const int* api, int first,
                                              int count, float lxv, float lyv,
                                              bool m_in) {
    if (count <= 0) return m_in;
    bool m_out = m_in && xrt_aperture_logic(api, first, true,
                                            xrt_aperture_test(apf, api, first, lxv, lyv));
    for (int a = first + 1; a < first + count; ++a) {
        const bool test = xrt_aperture_test(apf, api, a, lxv, lyv) && m_in;
        const bool nv = xrt_aperture_logic(api, a, m_out, test);
        m_out = m_in ? nv : m_out;
    }
    return m_out;
}

"""},
    _CHAIN: {_CHAIN_SINGLE: _CHAIN_SINGLE.replace("xrt_chain_apertures", "xrt_apertures")}}
# Layouts whose counts are not the twin's (times only).
TIMES_ONLY = {"source_only", "chain_no_count", "chain_no_apertures"}

# K5b's design (b), rejected: the replay build with a checkpoint every
# ceil(sqrt(n)) optics in shared memory, each segment's states run once more
# from its checkpoint when its adjoints come (about 3n - k - n / k
# forwards a ray), in place of every entry state saved (times only in
# ``long_rows``: the launcher's replay build of this tree is (b)); and the
# torus's Newton root found again in the replay from the entry state, in
# place of saved in the first pass.
_K5B_ROWS_DEF = """__host__ __device__ inline int replay_state_rows(int n_opt, bool torus) {
    return (XRT_STATE_ROWS + (torus ? 2 : 0)) * n_opt;
}
"""
_K5B_SEG_ROWS = """__host__ __device__ inline int replay_seg(int n_opt) {
    int seg = 1;
    while (seg * seg < n_opt) ++seg;
    return seg;
}
__host__ __device__ inline int replay_state_rows(int n_opt, bool) {
    const int seg = replay_seg(n_opt);
    return XRT_STATE_ROWS * ((n_opt + seg - 1) / seg + seg);
}
"""
_K5B_ROWS = """    constexpr int kRows = XRT_STATE_ROWS + (kTorus ? 2 : 0);
"""
_K5B_SHARED = """    const bool shared = h + sums + states <= cap;
"""
_K5B_LOOP = """        // The first pass, as far as optic n-1's entry. first_dead: the
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
"""
_K5B_SEG_LOOP = """        // The first pass, as far as the last state it saves. first_dead:
        // the first optic that lost the ray (alive never returns: every
        // shape's mask takes the incoming alive), so the ray enters optic
        // i alive where first_dead >= i.
        int first_dead = n_opt;
        const int last_saved = seg > 0 ? (n_opt - 1) / seg * seg : n_opt - 1;
        for (int e = 0; e <= last_saved; ++e) {
            if (seg == 0 || e % seg == 0) {
                save_state(rows + XRT_STATE_ROWS * (seg > 0 ? e / seg : e) * per_row, per_row,
                           st);
            }
            if (e == last_saved) break;
            OpticLocals L;
            grad_optic_fwd<kTorus, kCylinder, kMosaic>(
                fp + XRT_SRC_F + e * XRT_OPT_F, ip + XRT_HDR_I + e * XRT_OPT_I,
                P + e * XRT_GRAD_SLOTS, apf, api, aux, draw, st, L);
            if (!st.alive && first_dead == n_opt) first_dead = e;
        }
        // The draw cursor at optic hi, walked back an optic at a time.
        int cursor = draw.next;
        for (int e = last_saved; e < n_opt; ++e) cursor += optic_draws<kMosaic>(
            ip + XRT_HDR_I + e * XRT_OPT_I);

        Carry carry{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int hi = n_opt; hi > 0;) {
            const int lo = seg > 0 ? (hi - 1) / seg * seg : 0;
            if (seg > 0) {  // the segment's states again, from its checkpoint
                int at = cursor;
                for (int e = lo; e < hi; ++e) at -= optic_draws<kMosaic>(
                    ip + XRT_HDR_I + e * XRT_OPT_I);
                Draws d{uniforms, n_total, ray, seed0, seed1, at, -1, {0u, 0u, 0u, 0u}};
                RayState s = load_state(rows + XRT_STATE_ROWS * (lo / seg) * per_row,
                                        per_row, lam_r, first_dead >= lo);
                for (int e = lo; e < hi; ++e) {
                    save_state(seg_rows + XRT_STATE_ROWS * (e - lo) * per_row, per_row, s);
                    if (e == hi - 1) break;
                    OpticLocals L;
                    grad_optic_fwd<kTorus, kCylinder, kMosaic>(
                        fp + XRT_SRC_F + e * XRT_OPT_F, ip + XRT_HDR_I + e * XRT_OPT_I,
                        P + e * XRT_GRAD_SLOTS, apf, api, aux, d, s, L);
                    if (!s.alive && first_dead == n_opt) first_dead = e;
                }
            }
            for (int i = hi - 1; i >= lo; --i) {
                const int* oi = ip + XRT_HDR_I + i * XRT_OPT_I;
                cursor -= optic_draws<kMosaic>(oi);
                Draws d{uniforms, n_total, ray, seed0, seed1, cursor, -1, {0u, 0u, 0u, 0u}};
                RayState s = load_state(
                    seg > 0 ? seg_rows + XRT_STATE_ROWS * (i - lo) * per_row
                            : rows + XRT_STATE_ROWS * i * per_row,
                    per_row, lam_r, first_dead >= i);
                const float* o = fp + XRT_SRC_F + i * XRT_OPT_F;
                const float* Pi = P + i * XRT_GRAD_SLOTS;
                OpticLocals L;
                grad_optic_fwd<kTorus, kCylinder, kMosaic>(o, oi, Pi, apf, api, aux, d, s, L);
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
            hi = lo;
        }
"""
_K5B_FIRST_FWD = """            grad_optic_fwd<kTorus, kCylinder, kMosaic, kTorus>(
                fp + XRT_SRC_F + e * XRT_OPT_F, ip + XRT_HDR_I + e * XRT_OPT_I,
                P + e * XRT_GRAD_SLOTS, apf, api, aux, draw, st, L,
                rows + (kRows * e + XRT_STATE_ROWS) * per_row, per_row, false);
"""
_K5B_REPLAY_FWD = """            grad_optic_fwd<kTorus, kCylinder, kMosaic, kTorus>(
                o, oi, Pi, apf, api, aux, d, s, L,
                rows + (kRows * i + XRT_STATE_ROWS) * per_row, per_row, i < n_opt - 1);
"""
K5B_LEADS = {
    "checkpoints": {_FWD: {
        _K5B_ROWS_DEF: _K5B_SEG_ROWS,
        _K5B_ROWS: (
            "    const int seg = replay_seg(n_opt);\n"
            "    float* const seg_rows =\n"
            "        rows + XRT_STATE_ROWS * ((n_opt + seg - 1) / seg) * per_row;\n"),
        _K5B_SHARED: "    const bool shared = true;\n",
        _K5B_LOOP: _K5B_SEG_LOOP}},
    "root_found": {_FWD: {
        _K5B_ROWS_DEF: _K5B_ROWS_DEF.replace("(XRT_STATE_ROWS + (torus ? 2 : 0))",
                                             "XRT_STATE_ROWS"),
        _K5B_ROWS: "    constexpr int kRows = XRT_STATE_ROWS;\n",
        _K5B_FIRST_FWD: (
            "            grad_optic_fwd<kTorus, kCylinder, kMosaic>(\n"
            "                fp + XRT_SRC_F + e * XRT_OPT_F, ip + XRT_HDR_I + e * XRT_OPT_I,\n"
            "                P + e * XRT_GRAD_SLOTS, apf, api, aux, draw, st, L);\n"),
        _K5B_REPLAY_FWD: (
            "            grad_optic_fwd<kTorus, kCylinder, kMosaic>(o, oi, Pi, apf, api, aux, d, s, L);"
            "\n")}},
}

LAYOUTS = {"checkout": {}, "all_in": ALL_IN, **LEADS_UNDONE, **MOSAIC_LEADS,
           **K3_LEADS, **SPLIT_LAYOUTS, **K1B_LEADS, **PLASMA_LEADS, **PAIR_LEAD,
           **K1A_LEADS, **K2_LEADS, **K1D_LEADS, **K1E_LEADS, **K1C_LEADS, **HEAD_LEADS,
           **CHAIN_SPLIT, **K5B_LEADS}


def make_tree(name: str, edits: dict) -> str:
    """A copy of the checkout with the lines ``edits`` ({file: {line:
    replacement}}) replaced."""
    tree = os.path.join(AB_DIR, name)
    shutil.rmtree(tree, ignore_errors=True)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = [line.strip().rstrip("/") for line in f
                   if line.strip() and not line.startswith("#")]
    shutil.copytree(ROOT, tree, ignore=shutil.ignore_patterns(".git", *ignored))
    for relpath, lines in edits.items():
        path = os.path.join(tree, relpath)
        with open(path) as f:
            src = f.read()
        for line, new in lines.items():
            if src.count(line) != 1:
                raise AssertionError(f"{name}: line not found once in {relpath}: {line}")
            src = src.replace(line, new)
        with open(path, "w") as f:
            f.write(src)
    return tree


def child_command(tree: str, mode: str) -> list:
    """A process that runs this file's :func:`child` on ``tree``, importing
    that tree's package and ``chip_smoke.py``."""
    here = os.path.abspath(__file__)
    code = (f"import sys, runpy; sys.path[:0] = [{tree!r}]; "
            f"runpy.run_path({here!r})['child']({tree!r}, {mode!r})")
    return [sys.executable, "-c", code]


def blocks_per_sm(registers: int) -> int:
    """256-thread blocks a multiprocessor holds at ``registers`` a thread."""
    per_warp = -(-registers * 32 // 256) * 256
    return min(65536 // (per_warp * 8), 8)


def ptxas_lines(report: str) -> list:
    """(kernel, registers, spill stores, stack frame bytes, static shared
    memory bytes) of K1, K2, K3, K5f, K5b and R2 from ptxas's report."""
    out, name, stores, frame = [], None, 0, 0
    for line in report.splitlines():
        m = re.search(r"(fused_trace_kernel|fused_trace_flat_kernel|fused_trace_cylinder_kernel"
                      r"|fused_trace_dense_kernel|trace_only_kernel"
                      r"|fused_grad_fwd_kernel(?:_64)?"
                      r"|fused_grad_bwd_kernel|fused_grad_replay_kernel|mma_rate_kernel"
                      r"|bin_images?_kernel)(I\w+?E)?E",
                      line)
        if m and "Compiling entry" in line:
            name, stores, frame = m.group(1) + (m.group(2) or ""), 0, 0
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if name and spill:
            frame, stores = int(spill.group(1)), int(spill.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)), stores, frame,
                        int(smem.group(1)) if smem else 0))
            name = None
    return out


def blocks_by_smem(static: int, dynamic: int) -> int:
    """Blocks a multiprocessor holds by shared memory alone: its 228 KB over
    each block's static and dynamic bytes and the 1 KB the card reserves a
    block (the occupancy calculator's rule, for trees without an occupancy
    entry point)."""
    props = torch_props()
    per_sm = getattr(props, "shared_memory_per_multiprocessor", 233472)
    return per_sm // (static + dynamic + 1024)


def torch_props():
    import torch

    return torch.cuda.get_device_properties(0)


def launch_blocks(lib, name: str, regs_blocks: int, static: int, k1_floats: int,
                  k2_floats: int) -> tuple:
    """(blocks a multiprocessor, dynamic shared bytes, threads a block) of
    K1's build ``name``
    at the flagship's launch (``k1_floats`` image floats), or of K2 at its
    largest image (``k2_floats``): the tree's occupancy entry point
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor as the launcher calls
    it) where it has one, else the launcher's rule before it had one (the
    image in dynamic shared memory up to 51200 floats) by
    :func:`blocks_by_smem`."""
    if name.startswith("bin_image"):
        if hasattr(lib, "xrt_bin_images_occupancy"):
            unit = int("Lb1E" in name)
            return lib.xrt_bin_images_occupancy(k2_floats, unit), 4 * k2_floats, 256
        dyn = 4 * k2_floats
        return min(regs_blocks, blocks_by_smem(static, dyn)), dyn, 256
    args = [int(x) for x in re.findall(r"L[bi](\d+)E", name)]
    # (src, cheb, stages, kMark, shapes, dense) of the launcher that takes
    # the build; a tree before the cylinder and dense builds passes curved
    # for shapes and takes no dense.
    if name.startswith("fused_trace_flat_kernel"):  # <stages, mark>, or the parent's <mark>
        args = [0, 0, *([0] if len(args) == 1 else []), *args, 0, 0]
    elif name.startswith("fused_trace_cylinder_kernel"):  # <stages, mark>
        args = [0, 0, *args, 2, 0]
    elif name.startswith("fused_trace_dense_kernel"):  # <mark>
        args = [0, 0, 0, args[0], 0, 1]
    elif len(args) == 4:  # fused_trace_kernel<src, cheb, stages, mark>: every shape
        args = [*args, 3, 0]
    if hasattr(lib, "xrt_fused_trace_occupancy") and len(args) >= 6:
        import ctypes

        dyn = ctypes.c_int(0)
        src, cheb, stages, mark, shapes, dense = args[:6]
        fn = lib.xrt_fused_trace_marked_occupancy if mark else lib.xrt_fused_trace_occupancy
        occupancy = ((src, cheb, stages, shapes, dense, 0, 0)
                     if hasattr(lib, "xrt_fused_trace_build")
                     else (src, cheb, stages, int(shapes != 0)))
        # A tree whose kernels keep the packed buffers in the head of their
        # dynamic shared memory counts the flagship's head too.
        head = FLAGSHIP_FP_IP if hasattr(lib, "xrt_head_floats_of") else ()
        blocks = fn(*occupancy, k1_floats, *head, ctypes.byref(dyn))
        threads = (lib.xrt_fused_trace_threads(src, cheb, stages)
                   if hasattr(lib, "xrt_fused_trace_threads") else 256)
        return blocks, dyn.value, threads
    dyn = 4 * k1_floats
    return min(regs_blocks, blocks_by_smem(static, dyn)), dyn, 256


def sass_counts(lib_path: str, pattern: str) -> dict:
    """{function: {opcode: count}} of the SASS (``cuobjdump -sass`` of the
    built library) of each function whose mangled name matches ``pattern``,
    with ``ATOMS.CAST``, ``ATOMS.ADD``, ``ATOMS.POPC``, ``RED`` and ``ATOMG``
    beside each base opcode, ``all`` the instructions, and each full
    opcode of the atomics and conversions (``ATOM``, ``RED``, ``F2F``
    prefixes: whether an add or a conversion flushes subnormals shows as
    ``.FTZ``) under ``full:``; empty where the toolkit has no
    ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    dump = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True).stdout
    out, current = {}, None
    for line in dump.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            current = head.group(1) if re.search(pattern, head.group(1)) else None
            if current:
                out[current] = {}
            continue
        ins = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if current and ins:
            op = ins.group(1)
            c = out[current]
            c["all"] = c.get("all", 0) + 1
            base = op.split(".")[0]
            c[base] = c.get(base, 0) + 1
            for full in ("ATOMS.CAST", "ATOMS.ADD", "ATOMS.POPC", "ATOMG", "RED"):
                if op.startswith(full) and full != base:
                    c[full] = c.get(full, 0) + 1
            if op.startswith(("ATOM", "RED", "F2F")):
                c["full:" + op] = c.get("full:" + op, 0) + 1
    return out


def stage1_chains(cs, engine, ft, n: int, device="cuda") -> dict:
    """The chains K1 runs in its weight and bilinear (``kStages`` 1)
    builds, each in weight mode and with bilinear images, at ``n`` rays (a
    plasma's as many as its 1000 bundles give): the flagship (the flat
    build), ``plasma_torus``, phase 24's generic source, the mesh
    spectrometer's Chebyshev sphere and the cylinder (weight mode). Returns
    {name: (packed buffers, rays, bundles or None)}."""
    import torch

    from xicsrt_tpu_torch.draws import Draws

    cls, kw = cs.MESH_CRYSTALS["mesh_sphere"]
    modes = (("weight", {"interact_mode": "weight"}), ("bilinear", {"image_mode": "bilinear"}))
    out = {}
    for mode, general in modes:
        pipe = engine.Pipeline(cs.plasma_config(n, 1, engine="fused", **general), device=device)
        bundles = ft.plasma_bundles(pipe.source, pipe.params["sources"]["plasma"],
                                    pipe.params["filters"],
                                    Draws(torch.Generator(device=device).manual_seed(14)), 1)
        out[f"K1 plasma {mode}"] = (cs.k1_pack(pipe), pipe.num_rays, bundles)
        configs = {f"K1d-{mode}": cs.flagship(n, 1, engine="fused", **general),
                   f"K1b {mode}": cs.source_matrix_config(n, 1, "fused", **general),
                   f"K1c-cheb {mode}": cs.mesh_config(n, 1, "fused", cls, **kw)}
        configs[f"K1c-cheb {mode}"]["general"].update(general)
        if mode == "weight":
            configs["K1c-cylinder weight"] = cs.cylinder_config(n, 1, "fused")
            configs["K1c-cylinder weight"]["general"].update(general)
        for name, cfg in configs.items():
            out[name] = (cs.k1_pack(engine.Pipeline(cfg, device=device)), n, None)
    return out


def child(tree: str, mode: str) -> None:
    """Build ``tree``'s kernels (mode 'build'), or time them (mode 'time';
    'trace': K1, K1e and K3 only; 'stage1': :func:`stage1_chains`)."""
    from xicsrt_tpu_torch.ops import native

    if mode == "build":
        native.build()
        return
    import torch

    import chip_smoke as cs
    from xicsrt_tpu_torch import engine
    from xicsrt_tpu_torch.gradients import make_fused_differentiable
    from xicsrt_tpu_torch.ops import bundle_gather as bg
    from xicsrt_tpu_torch.ops import fused_grad as fg
    from xicsrt_tpu_torch.ops import fused_trace as ft

    label = os.path.basename(tree)
    # The checkout's chip_smoke.py helpers where the tree's lacks them. K2's
    # calls are shorter than the host's time to issue them: they are timed
    # on the card alone, queued behind a spin kernel (device_ms);
    # torch.bincount waits on the host inside a call, so its kernels are
    # timed by the profiler (kernel_ms).
    helpers = (vars(cs) if hasattr(cs, "kernel_ms")
               else runpy.run_path(os.path.join(ROOT, "chip_smoke.py")))
    device_ms, kernel_ms = helpers["device_ms"], helpers["kernel_ms"]
    lib = native.library()
    for name, regs, stores, frame, smem in ptxas_lines(native.ptxas_report()):
        line = (f"{label} ptxas {name}: {regs} registers, {stores} bytes spill stores, "
                f"{frame} bytes stack frame, {blocks_per_sm(regs)} blocks of 256 per "
                f"multiprocessor by registers")
        if name.startswith(("fused_trace_kernel", "fused_trace_flat_kernel",
                            "fused_trace_cylinder_kernel", "fused_trace_dense_kernel",
                            "bin_image")):
            blocks, dyn, threads = launch_blocks(lib, name, blocks_per_sm(regs), smem,
                                                 helpers["FLAGSHIP_IMG_FLOATS"],
                                                 max(helpers["K2_IMAGES"]))
            what = "the flagship's images" if name.startswith("fused") else "a 100 x 100 image"
            line += (f"; {smem} bytes static shared memory, at {what} {dyn} dynamic: "
                     f"{blocks} blocks of {threads} ({blocks * threads // 32} warps) by "
                     f"registers and shared memory")
        print(line, flush=True)
    lib_path = native.build()
    for fn, ops in sass_counts(lib_path, r"fused_trace_kernelILi0ELb0ELi[01]ELb0E|"
                               r"fused_trace_flat_kernelI(Li[01]E)?Lb[01]E|"
                               r"fused_trace_cylinder_kernelILi0ELb0E|"
                               r"fused_trace_dense_kernelILb0E|"
                               r"bin_images?_kernel").items():
        keys = ("all", "ATOMS", "ATOMS.CAST", "ATOMS.ADD", "ATOMS.POPC", "RED", "ATOM",
                "ATOMG", "MUFU", "LDS", "LDG", "BRA", "BSSY")
        full = sorted(k for k in ops if k.startswith("full:"))
        print(f"{label} sass {fn}: "
              + ", ".join(f"{k} {ops.get(k, 0)}" for k in keys + tuple(full)), flush=True)

    def ms(fn, timer=cs.cuda_ms) -> tuple:
        means = [timer(fn, 20) for _ in range(5)]
        if None in means:  # kernel_ms: the profiler recorded no device time
            return float("nan"), float("nan")
        return min(means), statistics.median(means)

    n = 1 << 22
    times = {}
    if mode == "stage1":
        stage1(cs, engine, ft, n, label, ms)
        return
    if mode == "k1e":
        k1e_rows(cs, engine, ft, label, ms)
        return
    if mode == "k4":
        k4_rows(cs, engine, ft, bg, label, ms)
        return
    if mode == "k1c":
        k1c_rows(cs, engine, ft, label, ms)
        return
    if mode == "long":
        long_rows(cs, engine, ft, fg, label, ms)
        return
    chains = {"K1a": cs.flagship(n, 1, engine="fused")}
    if hasattr(cs, "mesh_config"):
        cls, kw = cs.MESH_CRYSTALS["mesh_sphere"]
        chains.update({
            "K1c-mirror": cs.mirror_configs(n, 1, "fused")["flagship_no_check"],
            "K1c-file": cs.file_crystal_config(n, 1, "fused"),
            "K1c-cheb": cs.mesh_config(n, 1, "fused", cls, **kw),
            "K1c-cheb mesh41": cs.BS.SCENARIOS["mesh41"](n, 1)})
        example06 = cs.example_config("example_06_fused_engine.py")
        example06["sources"]["source"]["intensity"] = n
        chains["K1c-cheb example06"] = example06
    grad_chains = {"flagship": cs.grad_flagship(n, 1), **cs.grad_timing_configs()}
    if hasattr(cs, "mosaic15_config"):
        chains.update({
            "K1d-weight": cs.flagship(n, 1, engine="fused", interact_mode="weight"),
            "K1d-bilinear": cs.flagship(n, 1, engine="fused", image_mode="bilinear"),
            "K1c-mosaic mc": cs.mosaic15_config(n, 1, "fused"),
            "K1c-mosaic weight": cs.mosaic15_config(n, 1, "fused", interact_mode="weight"),
            "K1c-mosaic mesh mc": cs.mesh_mosaic_config(n, 1, "fused"),
            "K1c-mosaic mesh weight": cs.mesh_mosaic_config(n, 1, "fused",
                                                            interact_mode="weight")})
        grad_chains["mosaic_sphere"] = cs.grad_variant("mosaic_sphere", n)
    if hasattr(cs, "file_rocking_config"):
        grad_chains["file_rocking"] = cs.grad_variant("file_rocking", n)
        grad_chains["focused_gaussian_voigt"] = cs.grad_variant("focused_gaussian_voigt", n)
    # Example 08's chain: its detector image is 80 KB.
    grad_chains["example08"] = cs.repo_function("examples/example_08_plasma_fitting.py",
                                                "_config")(8.3e20, 2.0e4)
    equal = {}  # each timed K1 and K3 call's counts against its twin's

    def counts_equal(name, kernel, plain):
        if label == "skip_lookup" and "plasma" in name:
            return  # times only: its plasma rays all take bundle 0
        a, b = kernel()[0], plain()[0]
        if label == "source_only" and name.startswith("K1"):
            a, b = a[:1], b[:1]  # the chain is not traced: the source's count
        equal[name] = bool(torch.equal(a, b))
        if not equal[name]:
            print(f"{label} {name}: the counts differ from the twin's", flush=True)

    if hasattr(cs, "source_matrix_config"):
        chains.update({
            "K1b": cs.source_matrix_config(n, 1, "fused"),
            "K1b xy_asym": cs.source_variant_config("isotropic_xy_asym", n, 1,
                                                    engine="fused")})
    # K2 on phase 7's dense input (90 % of 2^22 uniform hits, each image of
    # the flagship) and on the main path's own (one eager iteration's
    # crystal and detector items), as the eager engine bins them: one
    # launch an item, or one for all where the tree packs them
    # (bin_images_cuda); torch.bincount on the same set rays beside each.
    from xicsrt_tpu_torch.ops import pallas_binning as pb

    gen = torch.Generator(device="cuda").manual_seed(3)
    dense = []
    for nx, ny, ps in cs.FLAGSHIP_IMAGES:
        xl, mask, _ = cs.hits(n, nx, ny, ps, gen)
        dense.append((xl, mask, torch.ones(n, device="cuda"), nx, ny, ps))
    k2_inputs = {"dense": dense, "main": helpers["eager_image_items"](n)}
    packed = getattr(pb, "bin_images_cuda", None)
    for key, items in k2_inputs.items():
        unit = all(bool(torch.all(w == 1)) for _, _, w, *_ in items)
        if packed is not None:
            run = lambda: packed(items, unit_weights=unit)  # noqa: E731
            first = lambda: packed(items[:1], unit_weights=unit)  # noqa: E731
        else:
            run = lambda: [pb.bin_image_cuda(*item) for item in items]  # noqa: E731
            first = lambda: pb.bin_image_cuda(*items[0])  # noqa: E731
        times[f"K2 {key}"] = ms(run, device_ms)
        times[f"K2 {key} 100x100"] = ms(first, device_ms)
        times[f"K2 {key} host"] = ms(run)
        equal[f"K2 {key}"] = all(bool(torch.equal(a, pb.bin_image_plain(*item)))
                                 for a, item in zip(run(), items))
        idx = helpers["bincount_inputs"](items)
        bincount = lambda: [torch.bincount(i, w, minlength=p) for i, w, p in idx]  # noqa: E731
        times[f"bincount {key}"] = ms(bincount, kernel_ms)
        times[f"bincount {key} host"] = ms(bincount)
        n_set = sum(int(m.sum()) for _, m, *_ in items)
        print(f"{label} K2 {key}: {len(items)} images, {n_set} of "
              f"{sum(m.numel() for _, m, *_ in items)} rays set, unit weights {unit}",
              flush=True)
    del dense, k2_inputs
    # The main path end to end: the flagship's raytrace on both engines as
    # phase 7 times it (fused 2^26 x 4, eager + K2 2^22 x 4; ms a call, 3
    # calls a mean), and the fused call's one K1 launch of 2^28 rays.
    import xicsrt_tpu_torch

    fused_cfg = cs.flagship(2**26, 4, engine="fused")
    eager_cfg = cs.flagship(2**22, 4, engine="xla", binning="pallas")
    big = cs.k1_pack(engine.Pipeline(fused_cfg, device="cuda"))

    def calls(fn) -> tuple:
        means = [cs.cuda_ms(fn, 3) for _ in range(3)]
        return min(means), statistics.median(means)

    times["K1a 2^28"] = calls(lambda: ft.fused_run_cuda(big, 2**28, 2**28, seed=(1, 2)))
    times["raytrace fused"] = calls(lambda: xicsrt_tpu_torch.raytrace(fused_cfg,
                                                                      device="cuda"))
    # Phase 34's fused calls: the flagship in weight mode and with bilinear
    # images, its K1 launch of 2^28 rays and the raytrace call.
    if hasattr(cs, "mosaic15_config"):
        for name, general in (("K1d-weight", {"interact_mode": "weight"}),
                              ("K1d-bilinear", {"image_mode": "bilinear"})):
            cfg_d = cs.flagship(2**26, 4, engine="fused", **general)
            big_d = cs.k1_pack(engine.Pipeline(cfg_d, device="cuda"))
            times[f"{name} 2^28"] = calls(
                lambda: ft.fused_run_cuda(big_d, 2**28, 2**28, seed=(1, 2)))
            times[f"raytrace fused {name}"] = calls(
                lambda: xicsrt_tpu_torch.raytrace(cfg_d, device="cuda"))
            del big_d
    times["raytrace eager"] = calls(lambda: xicsrt_tpu_torch.raytrace(eager_cfg,
                                                                      device="cuda"))
    chains["K1c-cylinder"] = cs.cylinder_config(n, 1, "fused")
    for name, cfg in chains.items():
        fparams = cs.k1_pack(engine.Pipeline(cfg, device="cuda"))
        times[name] = ms(lambda: ft.fused_run_cuda(fparams, n, n, seed=(1, 2)))
        counts_equal(name, lambda: ft.fused_run_cuda(fparams, n, n, seed=(1, 2)),
                     lambda: ft.fused_run_plain(fparams, n, n, seed=(1, 2)))
    # K1 on phase 16's plasma_torus slots at 1000 and 1e5 bundles, and K4
    # on the same tables.
    for name, bundle_count in (("K1 plasma", 1000), ("K1 plasma 1e5", 100000)):
        _, fparams, bundles, m = cs.plasma_k1_setup(ft, engine, n, 1, bundle_count)
        times[name] = ms(lambda: ft.fused_run_cuda(fparams, m, m, seed=(1, 2),
                                                   bundles=bundles))
        counts_equal(name, lambda: ft.fused_run_cuda(fparams, m, m, seed=(1, 2),
                                                     bundles=bundles),
                     lambda: ft.fused_run_plain(fparams, m, m, seed=(1, 2), bundles=bundles))
        cum, table = bundles[0][0], bundles[1][0]
        k4 = name.replace("K1 plasma", "K4")
        times[k4] = ms(lambda: bg.interval_gather_cuda(cum, table, m))
        equal[k4] = bool(torch.equal(bg.interval_gather_cuda(cum, table, m),
                                     bg.interval_gather_plain(cum, table, m)))
    if hasattr(cs, "mosaic15_config"):
        k1e_chains = {"flagship": cs.flagship(n, 1, engine="fused"),
                      "mosaic15": cs.mosaic15_config(n, 1, "fused")}
        for name, cfg in k1e_chains.items():  # the marked K1, then the record launch
            pipe = engine.Pipeline(cfg, device="cuda")
            fparams = cs.k1_pack(pipe)
            spec = ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, 8, "found")
            times[f"K1e found {name}"] = ms(
                lambda: ft.fused_run_cuda(fparams, n, n, seed=(1, 2), history=spec))
        pipe, fparams, bundles, m = cs.plasma_k1_setup(ft, engine, n, 1)
        spec = ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, 8, "found")
        times["K1e found plasma_torus"] = ms(lambda: ft.fused_run_cuda(
            fparams, m, m, seed=(1, 2), bundles=bundles, history=spec))
        # K3 on phase 25's plasma iteration, in weight mode on the flagship's
        # eager rays, and behind the mosaic on mosaic15's.
        plasma = cs.plasma_config(1 << 24, 2, bundle_count=8_000_000, engine="fused")
        plasma["sources"]["plasma"]["max_bundles"] = int(1e7)
        k3_chains = {
            "K3 plasma": (plasma, 27),
            "K3 weight": (cs.flagship(n, 1, engine="fused", interact_mode="weight"), 38),
            "K3 mosaic mc": (cs.mosaic15_config(n, 1, "fused"), 381),
            "K3 mosaic weight": (cs.mosaic15_config(n, 1, "fused", interact_mode="weight"),
                                 381)}
        for name, (cfg, seed) in k3_chains.items():
            pipe = engine.Pipeline(cfg, device="cuda")
            k3p = cs.k3_pack(ft, pipe)
            rays = cs.eager_rays(pipe, seed)
            args = (k3p, rays.origin, rays.direction, rays.wavelength, rays.mask)
            kw = {"seed": (1, 2), **({"weight": rays.weight} if k3p.weight else {})}
            times[name] = ms(lambda: ft.fused_trace_run_cuda(*args, **kw))
            counts_equal(name, lambda: ft.fused_trace_run_cuda(*args, **kw),
                         lambda: ft.fused_trace_run_plain(*args, **kw))
            del rays, args, kw
    if mode == "trace":
        grad_chains = {}
    for name, cfg in grad_chains.items():
        _, _, pack, pipe = make_fused_differentiable(cfg, device="cuda")
        pvec = pack(pipe.params).detach()
        spec = fg.build_fused_diff(pipe, num_iter=1)[3]
        st, lam = spec["static"], spec["lam"]
        m = n if name == "example08" else spec["n_total"]
        g = torch.randn(st.img_total, device="cuda")
        times[f"K5f {name}"] = ms(
            lambda: fg.fused_grad_forward_cuda(st, pvec, m, lam, seed=(1, 2)))
        times[f"K5b {name}"] = ms(
            lambda: fg.fused_grad_vjp_cuda(st, pvec, m, lam, g, seed=(1, 2)))
        if name == "example08":
            continue
        # The same rays' draws read from memory (n_draws float32 a ray)
        # instead of Philox, and the fixed cost against the cost a ray.
        u = torch.rand((st.n_draws, n), device="cuda")
        times[f"K5f {name} uniforms"] = ms(
            lambda: fg.fused_grad_forward_cuda(st, pvec, n, lam, uniforms=u))
        del u
        for k in (20, 24):
            times[f"K5f {name} 2^{k}"] = ms(
                lambda: fg.fused_grad_forward_cuda(st, pvec, 1 << k, lam, seed=(1, 2)))
    if mode == "time" and importlib.util.find_spec("xicsrt_tpu_torch.ops.roofline_probes"):
        from xicsrt_tpu_torch.ops import roofline_probes as rp

        seed = torch.tensor([0.011], dtype=torch.float32, device="cuda")
        times["R2"] = ms(lambda: rp.mma_rate_cuda(seed))
    for name, (low, mid) in times.items():
        print(f"{label} {name}: {low:.4f} ms least, {mid:.4f} ms median", flush=True)
    print(json.dumps({"tree": label, "ms": times, "counts_equal_twin": equal}), flush=True)


def stage1(cs, engine, ft, n: int, label: str, ms) -> None:
    """Times K1a and :func:`stage1_chains` (least and median of 5 means of
    20 calls, each checked once against its twin's counts), and the twins
    of K1a and the flagship's K1d rows on the card (3 means of 3 calls)."""
    import torch

    times, equal = {}, {}
    k1a = cs.k1_pack(engine.Pipeline(cs.flagship(n, 1, engine="fused"), device="cuda"))
    chains = {"K1a": (k1a, n, None), **stage1_chains(cs, engine, ft, n)}
    for name, (fparams, m, bundles) in chains.items():
        run = lambda: ft.fused_run_cuda(fparams, m, m, seed=(1, 2), bundles=bundles)  # noqa: E731
        times[name] = ms(run)
        equal[name] = bool(torch.equal(
            run()[0], ft.fused_run_plain(fparams, m, m, seed=(1, 2), bundles=bundles)[0]))
        if not equal[name]:
            print(f"{label} {name}: the counts differ from the twin's", flush=True)
    for name in ("K1a", "K1d-weight", "K1d-bilinear"):
        fparams = chains[name][0]
        means = [cs.cuda_ms(lambda: ft.fused_run_plain(fparams, n, n, seed=(1, 2)), 3)
                 for _ in range(3)]
        times[f"{name} twin"] = (min(means), statistics.median(means))
    for name, (low, mid) in times.items():
        print(f"{label} {name}: {low:.4f} ms least, {mid:.4f} ms median", flush=True)
    print(json.dumps({"tree": label, "ms": times, "counts_equal_twin": equal}), flush=True)


def k1e_chains(cs, engine, ft, n: int) -> dict:
    """The chains whose 'found' history K1e's rows time, one a build of K1
    (``chip_smoke.py``'s configs at ``n`` rays, a plasma's at its 1000
    bundles): {name: (pipeline, packed buffers, rays, bundles or None)}.
    ``sparse``: the flagship's detector narrowed until about a chunk in
    three keeps a ray (``SPARSE_DETECTOR_XSIZE``)."""
    cls, kw = cs.MESH_CRYSTALS["mesh_sphere"]
    configs = {
        "flagship": cs.flagship(n, 1, engine="fused"),
        "flagship weight": cs.flagship(n, 1, engine="fused", interact_mode="weight"),
        "flagship bilinear": cs.flagship(n, 1, engine="fused", image_mode="bilinear"),
        "mosaic15": cs.mosaic15_config(n, 1, "fused"),
        "K1b": cs.source_matrix_config(n, 1, "fused"),
        "K1c-cheb": cs.mesh_config(n, 1, "fused", cls, **kw),
        "cylinder": cs.cylinder_config(n, 1, "fused"),
        "sparse": cs.flagship(n, 1, engine="fused")}
    configs["sparse"]["optics"]["detector"]["xsize"] = cs.SPARSE_DETECTOR_XSIZE
    out = {}
    for name, cfg in configs.items():
        pipe = engine.Pipeline(cfg, device="cuda")
        out[name] = (pipe, cs.k1_pack(pipe), n, None)
    pipe, fparams, bundles, m = cs.plasma_k1_setup(ft, engine, n, 1)
    out["plasma_torus"] = (pipe, fparams, m, bundles)
    return out


def k4_rows(cs, engine, ft, bg, label: str, ms) -> None:
    """K4's A/B rows (``--k4-only``): ``interval_gather_cuda`` on phase 16's
    ``plasma_torus`` tables (one iteration's slots at 2^22 expected photons,
    1000 and 1e5 bundles) and on phase 13's (B = 4000 and 1e5, 2^24 rays
    plus 1000 past the last bundle, every tenth bundle empty), each checked
    bit for bit against its twin, with its bound (bytes: the rows written,
    ``cum`` and the table read once) and ``torch.repeat_interleave`` of the
    same rows zero-padded (``chip_smoke.repeat_rows``), the library call."""
    import torch

    times, equal, bounds = {}, {}, {}
    cases = {}
    for name, bundle_count in (("K4 plasma_torus 1000", 1000), ("K4 plasma_torus 1e5", 100000)):
        _, _, bundles, m = cs.plasma_k1_setup(ft, engine, 1 << 22, 1, bundle_count)
        cases[name] = (bundles[0][0], bundles[1][0], m)
    gen = torch.Generator(device="cuda").manual_seed(13)
    for B in (4000, 100000):
        cum, table = cs.gather_inputs(B, 1 << 24, gen)
        cases[f"K4 phase 13 B={B}"] = (cum, table, (1 << 24) + 1000)
    for name, (cum, table, m) in cases.items():
        times[name] = ms(lambda: bg.interval_gather_cuda(cum, table, m))
        equal[name] = bool(torch.equal(bg.interval_gather_cuda(cum, table, m),
                                       bg.interval_gather_plain(cum, table, m)))
        bounds[name] = cs.bound(cs.packed_bytes(cum, table) + m * 32, 0)[0]
        counts = torch.diff(cum.long(), prepend=cum.new_zeros(1).long())
        total = int(cum[-1])
        times[f"{name} library"] = ms(lambda: cs.repeat_rows(table, counts, total, m))
        print(f"{label} {name}: {m} rays, {table.shape[0]} bundles; K4 "
              f"{times[name][0]:.4f} ms least, {times[name][1]:.4f} median; bound "
              f"{bounds[name]:.4f} ms (bytes); repeat_interleave "
              f"{times[f'{name} library'][0]:.4f} ms; equal to the twin {equal[name]}",
              flush=True)
    print(json.dumps({"tree": label, "ms": times, "bound_ms": bounds,
                      "counts_equal_twin": equal}), flush=True)


def k1c_chains(cs, engine, ft, n: int, device="cuda") -> dict:
    """The chains of K1c-mirror's and K1c-cylinder's rows (``--k1c-only``)
    and the rows that share their code, at ``n`` rays (a plasma's as many
    as its 1000 bundles give): phase 27's four mirror chains, the cylinder
    crystal (phase 18) in mc and weight mode and with bilinear images, K1a
    as the control, K1d, K1c-file, K1c-cheb, K1b, K1c-mosaic and the
    plasma. Returns {name: (pipeline, packed buffers, rays, bundles or
    None)}."""
    cls, kw = cs.MESH_CRYSTALS["mesh_sphere"]
    configs = {"K1a": cs.flagship(n, 1, engine="fused")}
    for name, cfg in cs.mirror_configs(n, 1, "fused").items():
        configs[f"K1c-mirror {name}"] = cfg
    configs["K1c-cylinder"] = cs.cylinder_config(n, 1, "fused")
    for mode, general in (("weight", {"interact_mode": "weight"}),
                          ("bilinear", {"image_mode": "bilinear"})):
        configs[f"K1c-cylinder {mode}"] = cs.cylinder_config(n, 1, "fused")
        configs[f"K1c-cylinder {mode}"]["general"].update(general)
        configs[f"K1d-{mode}"] = cs.flagship(n, 1, engine="fused", **general)
    configs.update({"K1c-file": cs.file_crystal_config(n, 1, "fused"),
                    "K1c-cheb": cs.mesh_config(n, 1, "fused", cls, **kw),
                    "K1b": cs.source_matrix_config(n, 1, "fused"),
                    "K1c-mosaic mc": cs.mosaic15_config(n, 1, "fused")})
    out = {}
    for name, cfg in configs.items():
        pipe = engine.Pipeline(cfg, device=device)
        out[name] = (pipe, cs.k1_pack(pipe), n, None)
    if device == "cuda":
        pipe, fparams, bundles, m = cs.plasma_k1_setup(ft, engine, n, 1)
        out["K1 plasma"] = (pipe, fparams, m, bundles)
    return out


def k1c_rows(cs, engine, ft, label: str, ms) -> None:
    """K1c-mirror's and K1c-cylinder's A/B rows (``--k1c-only``): K1 on each
    of :func:`k1c_chains` at 2^22 rays (least and median of 5 means of 20
    calls, Philox), each checked once against its twin's counts; the
    'found' call (K1's marked build and the record launch; at 2^22 rays K1
    marks without a probe) on the flagship and the cylinder; K3 on phase
    25's 8e6-bundle plasma iteration and in weight mode on the flagship's
    eager rays (phase 38). With each chain, the build the tree's launcher
    picks where the tree's ``chip_smoke.k1_build_name`` can say."""
    import torch

    times, equal, builds = {}, {}, {}
    for name, (pipe, fparams, m, bundles) in k1c_chains(cs, engine, ft, 1 << 22).items():
        run = lambda: ft.fused_run_cuda(fparams, m, m, seed=(1, 2), bundles=bundles)  # noqa: E731
        times[name] = ms(run)
        equal[name] = bool(torch.equal(
            run()[0], ft.fused_run_plain(fparams, m, m, seed=(1, 2), bundles=bundles)[0]))
        if not equal[name]:
            print(f"{label} {name}: the counts differ from the twin's", flush=True)
        if hasattr(cs, "k1_build_name"):
            builds[name] = cs.k1_build_name(fparams)
        if name in ("K1a", "K1c-cylinder"):
            spec = ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, 8, "found")
            times[f"K1e found {name}"] = ms(
                lambda: ft.fused_run_cuda(fparams, m, m, seed=(1, 2), history=spec))
    plasma = cs.plasma_config(1 << 24, 2, bundle_count=8_000_000, engine="fused")
    plasma["sources"]["plasma"]["max_bundles"] = int(1e7)
    for name, (cfg, seed) in {
            "K3 plasma": (plasma, 27),
            "K3 weight": (cs.flagship(1 << 22, 1, engine="fused", interact_mode="weight"),
                          38)}.items():
        pipe = engine.Pipeline(cfg, device="cuda")
        k3p = cs.k3_pack(ft, pipe)
        rays = cs.eager_rays(pipe, seed)
        args = (k3p, rays.origin, rays.direction, rays.wavelength, rays.mask)
        kw = {"seed": (1, 2), **({"weight": rays.weight} if k3p.weight else {})}
        times[name] = ms(lambda: ft.fused_trace_run_cuda(*args, **kw))
        equal[name] = bool(torch.equal(ft.fused_trace_run_cuda(*args, **kw)[0],
                                       ft.fused_trace_run_plain(*args, **kw)[0]))
        del rays, args, kw
    for name, (low, mid) in times.items():
        build = f" ({builds[name]})" if name in builds else ""
        print(f"{label} {name}{build}: {low:.4f} ms least, {mid:.4f} ms median", flush=True)
    print(json.dumps({"tree": label, "ms": times, "builds": builds,
                      "counts_equal_twin": equal}), flush=True)


def k1e_rows(cs, engine, ft, label: str, ms) -> None:
    """K1e's A/B rows (``--k1e-only``): on each of :func:`k1e_chains` at
    2^22 rays, K1's launch without marks, with them, and (in a tree with
    the probe) with the probe's flag set, where the marked build leaves at
    once and the build without marks runs (``k1_direct``, ``pair``: the
    main step of a probed call); the whole 'found' call (``fused_run_cuda``
    with the reservoir; in a tree with the probe, also with the probe
    taken below its least run size, ``PROBE_MIN_RAYS`` 0); and the
    reservoir's launches on the card alone (``device_ms``: the selection
    and record launch; in a tree with the probe, the probe's launches); on
    the flagship at 2^28 rays the same (a tree with the probe takes it
    there, and times the marked build's call beside it); the 'found' call
    at 2^24 and 2^26 rays (in a tree with the probe, probed and marked
    too); K1 and the 'found' call on the flagship with its detector
    narrowed to ``RARE_DETECTOR_XSIZE`` at 2^26 and 2^28 rays, where the
    probe falls back after its last window; then ``raytrace`` with and
    without 'found' history (3 means of 3 calls) and the found/lost split
    of one 'found' call alone (``engine._sort_history``) on the flagship
    (2^26 x 4), ``mosaic15`` (2^24 x 4) and ``plasma_torus`` (2^22 x 4)."""
    import copy

    import numpy as np
    import torch

    import xicsrt_tpu_torch
    from xicsrt_tpu_torch import engine as eng

    times, equal = {}, {}
    device_ms = cs.device_ms
    k1_direct = getattr(cs, "k1_direct", None) or runpy.run_path(
        os.path.join(ROOT, "chip_smoke.py"))["k1_direct"]
    probe = getattr(ft, "history_probe_cuda", None)

    def calls(fn) -> tuple:
        means = [cs.cuda_ms(fn, 3) for _ in range(3)]
        return min(means), statistics.median(means)

    def probing(rays, fn):  # fn with ft.PROBE_MIN_RAYS set to rays
        def run():
            old, ft.PROBE_MIN_RAYS = ft.PROBE_MIN_RAYS, rays
            try:
                return fn()
            finally:
                ft.PROBE_MIN_RAYS = old
        return run

    def marks_of(spec, m, flag):
        marks = torch.zeros(spec.n_chunks(m) + 1, dtype=torch.int32, device="cuda")
        marks[-1] = flag
        return marks

    for name, (pipe, fparams, m, bundles) in k1e_chains(cs, engine, ft, 1 << 22).items():
        spec = ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, 8, "found")
        marks, flagged = marks_of(spec, m, 0), marks_of(spec, m, 1)
        times[f"K1 {name}"] = ms(lambda: k1_direct(ft, fparams, m, (1, 2), bundles))
        times[f"K1 marked {name}"] = ms(
            lambda: k1_direct(ft, fparams, m, (1, 2), bundles, marks, spec.chunk))
        if probe is not None:
            times[f"K1 flagged {name}"] = ms(lambda: k1_direct(
                ft, fparams, m, (1, 2), bundles, flagged, spec.chunk, pair=True))
        times[f"K1e found {name}"] = ms(lambda: ft.fused_run_cuda(
            fparams, m, m, seed=(1, 2), bundles=bundles, history=spec))
        if probe is not None:  # the probe below its least run size
            times[f"K1e found probe {name}"] = ms(probing(0, lambda: ft.fused_run_cuda(
                fparams, m, m, seed=(1, 2), bundles=bundles, history=spec)))
        times[f"record {name}"] = ms(lambda: ft.history_record_cuda(
            fparams, m, m, spec, marks[:-1], seed=(1, 2), bundles=bundles), device_ms)
        if probe is not None:
            times[f"probe {name}"] = ms(lambda: probe(fparams, m, m, spec, seed=(1, 2),
                                                      bundles=bundles), device_ms)
            found = probe(fparams, m, m, spec, seed=(1, 2), bundles=bundles)
            print(f"{label} {name}: the probe's windows cover {found.chunks} chunks, used "
                  f"{int(found.used)}, flag {int(found.marks[-1])}", flush=True)
        equal[f"K1 marked {name}"] = bool(torch.equal(
            k1_direct(ft, fparams, m, (1, 2), bundles),
            k1_direct(ft, fparams, m, (1, 2), bundles, marks, spec.chunk)))
        used = int(ft.fused_run_cuda(fparams, m, m, seed=(1, 2), bundles=bundles,
                                     history=spec)[2].used)
        print(f"{label} {name}: {int((marks[:-1] != 0).sum())} of {marks.numel() - 1} "
              f"chunks marked, {used} slots used", flush=True)
        del marks, flagged
    big_cfg = cs.flagship(2**26, 4, engine="fused")
    pipe = engine.Pipeline(big_cfg, device="cuda")
    big = cs.k1_pack(pipe)
    spec = ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, 8, "found")
    marks, flagged = marks_of(spec, 2**28, 0), marks_of(spec, 2**28, 1)
    times["K1 2^28"] = calls(lambda: k1_direct(ft, big, 2**28, (1, 2)))
    times["K1 marked 2^28"] = calls(
        lambda: k1_direct(ft, big, 2**28, (1, 2), marks=marks, chunk=spec.chunk))
    if probe is not None:
        times["K1 flagged 2^28"] = calls(lambda: k1_direct(
            ft, big, 2**28, (1, 2), marks=flagged, chunk=spec.chunk, pair=True))
        times["probe 2^28"] = ms(lambda: probe(big, 2**28, 2**28, spec, seed=(1, 2)),
                                 device_ms)
    times["K1e found 2^28"] = calls(
        lambda: ft.fused_run_cuda(big, 2**28, 2**28, seed=(1, 2), history=spec))
    if probe is not None:
        times["K1e found marked 2^28"] = calls(probing(NEVER, lambda: ft.fused_run_cuda(
            big, 2**28, 2**28, seed=(1, 2), history=spec)))
    # Where the probe starts to pay: 'found' on the flagship at 2^24 and
    # 2^26 rays, probed and marked.
    for k in (24, 26):
        times[f"K1e found 2^{k}"] = calls(
            lambda: ft.fused_run_cuda(big, 2**k, 2**k, seed=(1, 2), history=spec))
        if probe is not None:
            for tag, rays in (("probe", 0), ("marked", NEVER)):
                times[f"K1e found {tag} 2^{k}"] = calls(probing(rays, lambda: ft.fused_run_cuda(
                    big, 2**k, 2**k, seed=(1, 2), history=spec)))
    del big, marks, flagged
    # The fallback at its worst: a detector so narrow that the probe's
    # windows (1/PROBE_SHARE of the run) find fewer than 8 chunks that keep a ray,
    # so the probe traces all of them and K1 still marks.
    rare_cfg = cs.flagship(2**26, 4, engine="fused")
    rare_cfg["optics"]["detector"]["xsize"] = RARE_DETECTOR_XSIZE
    pipe = engine.Pipeline(rare_cfg, device="cuda")
    rare = cs.k1_pack(pipe)
    for k in (26, 28):
        times[f"K1 rare 2^{k}"] = calls(lambda: k1_direct(ft, rare, 2**k, (1, 2)))
        times[f"K1e found rare 2^{k}"] = calls(
            lambda: ft.fused_run_cuda(rare, 2**k, 2**k, seed=(1, 2), history=spec))
        if probe is not None:
            times[f"K1e found marked rare 2^{k}"] = calls(probing(
                NEVER, lambda: ft.fused_run_cuda(rare, 2**k, 2**k, seed=(1, 2),
                                                 history=spec)))
            found = probe(rare, 2**k, 2**k, spec, seed=(1, 2))
            print(f"{label} rare 2^{k}: the probe's windows cover {found.chunks} chunks, "
                  f"used {int(found.used)}, flag {int(found.marks[-1])}", flush=True)
    del rare
    found_configs = {
        "flagship": (big_cfg, cs.flagship(2**26, 4, engine="fused", keep_history="found",
                                          history_max_lost=10000)),
        "mosaic15": (cs.mosaic15_config(2**24, 4, "fused"),
                     cs.mosaic15_config(2**24, 4, "fused", keep_history="found",
                                        history_max_lost=10000)),
        "plasma_torus": (cs.plasma_config(1 << 22, 4, engine="fused"),
                         cs.plasma_config(1 << 22, 4, engine="fused", keep_history="found",
                                          history_max_lost=10000))}
    for name, (none_cfg, found_cfg) in found_configs.items():
        times[f"raytrace none {name}"] = calls(lambda: xicsrt_tpu_torch.raytrace(
            copy.deepcopy(none_cfg), device="cuda"))
        times[f"raytrace found {name}"] = calls(lambda: xicsrt_tpu_torch.raytrace(
            copy.deepcopy(found_cfg), device="cuda"))
        runner, pipe = eng.build_runner(copy.deepcopy(found_cfg), device="cuda")
        out = runner(pipe.params, eng._run_generator(pipe.general, 0, pipe.device))
        times[f"sort_history {name}"] = calls(lambda: eng._sort_history(
            out["history"], pipe.element_names, 10000, np.random.default_rng(0)))
        del out
    for name, (low, mid) in times.items():
        print(f"{label} {name}: {low:.4f} ms least, {mid:.4f} ms median", flush=True)
    print(json.dumps({"tree": label, "ms": times, "counts_equal_twin": equal}), flush=True)


def long_rows(cs, engine, ft, fg, label: str, ms) -> None:
    """The long chains' A/B rows (``--long-only``), per 2^22 rays (least
    and median of 5 means of 20 calls, Philox): K1 on ``baffle127`` (its
    counts checked once against the twin's but in ``TIMES_ONLY`` layouts),
    K1's marked build there (the K1e main step of a 'found' call below the
    probe's size), K3 on its 2^22 eager rays, and ``raytrace`` of 2^26 x 4
    rays fused (3 means of 3 calls); K5f and K5b on ``baffle42`` and its
    forward+vjp step of 2^22 x 4 rays (3 means of 3 calls); beside them K1a
    and K5b on the flagship, example 07's torus chain and ``mosaic_sphere``.
    Then K5b's cut-over: the launcher's pick on the flagship's, example
    07's torus and a plasma's cylinder chain behind 0-5 plates
    (``with_baffles``), and on the flagship's behind 9, and in a tree with
    ``K5B_BUILDS`` also each build where it runs. A ``K5B_LEADS`` tree
    times K5b alone: ``baffle42`` and its step (``checkpoints``), or the
    torus chains (``root_found``)."""
    import copy

    import torch

    import xicsrt_tpu_torch
    from xicsrt_tpu_torch.gradients import make_fused_differentiable

    times, equal, facts = {}, {}, {}
    n = 1 << 22
    bs = cs.BS
    builds = ("replay",) if label == "root_found" else getattr(fg, "K5B_BUILDS", None)

    def calls(fn) -> tuple:
        means = [cs.cuda_ms(fn, 3) for _ in range(3)]
        return min(means), statistics.median(means)

    def report():
        for name, value in times.items():
            if value is not None:
                print(f"{label} {name}: {value[0]:.4f} ms least, {value[1]:.4f} ms median",
                      flush=True)
        print(json.dumps({"tree": label, "ms": times, "counts_equal_twin": equal,
                          "k5b_launches": facts}), flush=True)

    k1_rows = (("K1 baffle127", bs.baffle_config(124, n, 1, engine="fused")),
               ("K1a", cs.flagship(n, 1, engine="fused")))
    for name, cfg in (() if label in K5B_LEADS else k1_rows):
        pipe = engine.Pipeline(cfg, device="cuda")
        fparams = cs.k1_pack(pipe)
        run = lambda: ft.fused_run_cuda(fparams, n, n, seed=(1, 2))  # noqa: E731
        times[name] = ms(run)
        if label not in TIMES_ONLY:
            equal[name] = bool(torch.equal(
                run()[0], ft.fused_run_plain(fparams, n, n, seed=(1, 2))[0]))
        if name == "K1 baffle127":
            spec = ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, 8, "found")
            marks = torch.zeros(spec.n_chunks(n) + 1, dtype=torch.int32, device="cuda")
            times["K1 marked baffle127"] = ms(lambda: cs.k1_direct(
                ft, fparams, n, (1, 2), None, marks, spec.chunk))
            k3_pipe = engine.Pipeline(bs.baffle_config(124, n, 1, engine="fused"),
                                      device="cuda")
            k3p = cs.k3_pack(ft, k3_pipe)
            rays = cs.eager_rays(k3_pipe, 50)
            args = (k3p, rays.origin, rays.direction, rays.wavelength, rays.mask)
            times["K3 baffle127"] = ms(lambda: ft.fused_trace_run_cuda(*args, seed=(1, 2)))
            if label not in TIMES_ONLY:
                equal["K3 baffle127"] = bool(torch.equal(
                    ft.fused_trace_run_cuda(*args, seed=(1, 2))[0],
                    ft.fused_trace_run_plain(*args, seed=(1, 2))[0]))
            del rays, args, marks
    if label not in K5B_LEADS:
        big = bs.baffle_config(124, 2**26, 4, engine="fused")
        times["raytrace baffle127 2^28"] = calls(
            lambda: xicsrt_tpu_torch.raytrace(copy.deepcopy(big), device="cuda"))
    if label in CHAIN_SPLIT:
        report()
        return

    def k5_setup(cfg):
        _, _, pack, pipe = make_fused_differentiable(cfg, device="cuda")
        spec = fg.build_fused_diff(pipe, num_iter=1)[3]
        st = spec["static"]
        g = torch.randn(st.img_total, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(3))
        return st, pack(pipe.params).detach(), spec["lam"], spec["n_total"], g

    weight = {"interact_mode": "weight", "image_mode": "bilinear"}
    if label != "root_found":
        st, pv, lam, _, g = k5_setup(bs.baffle_config(39, n, 1, **weight))
        if label not in K5B_LEADS:
            times["K5f baffle42"] = ms(lambda: fg.fused_grad_forward_cuda(
                st, pv, n, lam, seed=(1, 2)))
        times["K5b baffle42"] = ms(lambda: fg.fused_grad_vjp_cuda(st, pv, n, lam, g,
                                                                  seed=(1, 2)))
        if builds is not None:
            facts["K5b baffle42"] = fg.k5b_layout(st, pv.numel(), n)
        forward, vjp, pack, gpipe = make_fused_differentiable(
            bs.baffle_config(39, 2**22, 4, **weight), device="cuda")
        p0 = pack(gpipe.params).detach()
        times["step baffle42 2^24"] = calls(lambda: vjp(p0, 3, forward(p0, 3)["image"]))
        del forward, vjp, p0
    if label == "checkpoints":
        report()
        return
    torus = cs.grad_timing_configs()["torus"]
    plasma_cyl = cs.grad_variant("plasma_cubic", n)
    plasma_cyl["optics"]["crystal"]["class_name"] = "XicsrtOpticCylindricalCrystal"
    chains = {"torus": torus}
    if label != "root_found":
        chains.update({"flagship": cs.grad_flagship(n, 1),
                       "mosaic_sphere": cs.grad_variant("mosaic_sphere", n)})
    for plates in (1, 2, 3, 4, 5):
        chains[f"torus+{plates}"] = bs.with_baffles(torus, plates)
    if label != "root_found":
        chains["plasma_cylinder"] = plasma_cyl
        for plates in (1, 2, 3, 4, 5, 9):
            if plates != 9:
                chains[f"plasma_cylinder+{plates}"] = bs.with_baffles(plasma_cyl, plates)
            chains[f"flagship+{plates}"] = bs.baffle_config(plates, n, 1, **weight)
    for name, cfg in chains.items():
        st, pv, lam, m, g = k5_setup(cfg)
        times[f"K5b {name}"] = ms(lambda: fg.fused_grad_vjp_cuda(
            st, pv, m, lam, g, seed=(1, 2)))
        for build in builds or ():
            try:
                launch = fg.k5b_layout(st, pv.numel(), m, build)
            except RuntimeError:  # the recomputing build's rows do not fit
                times[f"K5b {name} {build}"] = None
                continue
            facts[f"K5b {name} {build}"] = launch
            times[f"K5b {name} {build}"] = ms(lambda: fg.fused_grad_vjp_cuda(
                st, pv, m, lam, g, seed=(1, 2), _build=build))
    report()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another tree to time as it is")
    ap.add_argument("--layouts", nargs="+", choices=sorted(LAYOUTS), default=list(LAYOUTS),
                    help="the layouts of the checkout to time (default: all)")
    ap.add_argument("--trace-only", action="store_true",
                    help="time K1, K1e and K3 only (not K5 or R2)")
    ap.add_argument("--stage1-only", action="store_true",
                    help="time K1's weight and bilinear builds only (stage1_chains)")
    ap.add_argument("--k1e-only", action="store_true",
                    help="time K1e's rows only (k1e_rows)")
    ap.add_argument("--k4-only", action="store_true",
                    help="time K4's rows only (k4_rows)")
    ap.add_argument("--long-only", action="store_true",
                    help="time the long chains' rows only (long_rows)")
    ap.add_argument("--k1c-only", action="store_true",
                    help="time K1c-mirror's and K1c-cylinder's rows only (k1c_rows)")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip() or 'unknown'}", flush=True)
    trees = [make_tree(name, LAYOUTS[name]) for name in args.layouts]
    if args.parent:
        trees.insert(0, os.path.abspath(args.parent))
    # A lead's tree that does not build, or whose timings fail, is reported
    # and left out; the checkout and the parent must build and run.
    def lead_failed(tree, what, log):
        label = os.path.basename(tree)
        print(f"{label}: {what}:\n{log[-6000:]}", flush=True)
        if tree == os.path.abspath(args.parent or "") or label == "checkout":
            raise RuntimeError(f"{label}: {what}")

    builds = [subprocess.Popen(child_command(t, "build"), cwd=t, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True) for t in trees]
    failed = set()
    for tree, proc in zip(trees, builds):
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            lead_failed(tree, "the kernels did not build", log)
            failed.add(tree)
    for tree in trees + trees[::-1]:
        if tree in failed:
            continue
        mode = ("stage1" if args.stage1_only else "k1e" if args.k1e_only
                else "long" if args.long_only
                else "k4" if args.k4_only else "k1c" if args.k1c_only
                else "trace" if args.trace_only else "time")
        proc = subprocess.run(child_command(tree, mode),
                              cwd=tree, text=True,
                              capture_output=True, timeout=900)
        print(proc.stdout, end="", flush=True)
        if proc.returncode:
            lead_failed(tree, "the timings failed", proc.stderr)
            failed.add(tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
