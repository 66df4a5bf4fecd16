"""Measured roofline of the fused kernel K1 on the card (counterpart of
``tools/roofline.py``).

For each scenario it sets three things side by side:

1. **A census of operations per ray, by class** (:func:`chain_ops_per_ray`):
   K1's plain twin ``ops/fused_trace.fused_run_plain`` runs one chunk of
   rays on the CPU under :func:`count_ops`, which classes every ATen
   operation it dispatches as ``mxu_macs`` (matrix products), ``trans``,
   ``sqrtdiv`` or ``simple``. These are counts, not speeds.
2. **The card's rate for each class** (:func:`microbench_rates`), measured
   by the probe kernels R1 (elementwise, ``elem_rate_cuda``) and R2 (tensor
   core bf16 MACs, ``mma_rate_cuda``) of ``ops/roofline_probes.py``.
3. **Prediction against measurement** (:func:`main`): the serial bound
   (1 / the sum of the class times a ray) and the overlap bound (1 / the
   largest class time) beside K1's measured rays/s and ``raytrace``'s.

The same census of K5's twins (:func:`k5_ops_per_ray`) with
:func:`serial_ms` gives the gradient kernels K5f and K5b their class-rate
serial bound (``chip_smoke.py`` phase 45).

It also holds the flat bound that ``chip_smoke.py`` gives every kernel:
``OPS_PER_RAY``, the float32 operations per ray and stage counted by hand
from ``csrc/``, and :func:`bound`, the larger of bytes over 3.35 TB/s and
those operations over 67 TFLOP/s.

Usage, on a machine with a CUDA card::

    python -m xicsrt_tpu_torch.tools.roofline [scenario ...] [--out PATH]

The JSON goes to ``--out``, by default ``build/xicsrt_tpu_torch/roofline.json``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from xicsrt_tpu_torch.ops import fused_trace as ft
from xicsrt_tpu_torch.ops.binning import fused_multiply_add
from xicsrt_tpu_torch.ops import native
from xicsrt_tpu_torch.ops import roofline_probes as rp
from xicsrt_tpu_torch.tools import bench_scenarios as BS

# Float32 operations per ray of each stage, counted from the device code
# of xicsrt_tpu_torch/csrc: each add, multiply, division, square root,
# comparison, select and math-library call is one operation; the Philox
# draws' integer operations and the images' atomics are not counted.
OPS_PER_RAY = {
    # The generic source (xrt_sample_source): the cone by kind (isotropic,
    # isotropic_xy, its asymmetric Newton of 12 steps, flat, flat_xy,
    # gaussian), then a constant rotation or the Focused per-ray basis; per
    # nonzero box size, a uniform or gaussian offset; a uniform band; a
    # Voigt line's Gauss and Cauchy parts; the Doppler shift; per sightline.
    "cone": {0: 11, 1: 40, 2: 993, 3: 13, 4: 14, 5: 24},
    "rotation": 15, "aim": 58, "box": {1: 8, 2: 13},
    "band": 2, "gauss": 8, "cauchy": 7, "doppler": 8, "sightline": 21,
    "plasma_k1": 105, "plasma_k5": 125,
    "shape_k1": {0: 22, 1: 39, 2: 327, 3: 93},   # hit, position, normal
    "shape_k5": {0: 22, 1: 45, 2: 366, 3: 98},
    # A Chebyshev surface of degree d with nnz nonzero coefficients in C, Cx
    # and Cy (xrt_cheb_hit), what the function needs: local frame, seed,
    # position, hit test and normal, then per Newton step (4) its own (u, v,
    # their clips, 2 u and 2 v, F, F', the step), per degree above 1 the
    # two recurrences' multiply and subtract each, and per nonzero
    # coefficient a multiply-multiply-add.
    "cheb": {"setup": 81, "step": 26, "per_degree": 4, "per_coef": 3},
    "bounds": 17, "aperture": 8,
    "crystal_mc": 32, "crystal_weight": 38, "mirror": 14,
    # A file rocking curve in place of the gaussian's exp (xrt_file_value:
    # index, range, clip, two cached loads, the lerp), and in K5 its slope.
    "crystal_mc_file": 46, "crystal_weight_file": 55,
    "image_nearest": 10, "image_bilinear": 24,
    # K5b, per optic: seeds, reflection, local coordinates and slot sums;
    # the crystal; the shape's normal and hit.
    "adjoint": 141, "adjoint_crystal": 41, "adjoint_crystal_file": 37,
    "adjoint_shape": {0: 53, 1: 98, 2: 175, 3: 150},
    "adjoint_plasma": 12,
    # K1's bilinear splat (xrt_splat): the clip and floor of both
    # coordinates, two x tents and four corners.
    "image_bilinear_k1": 50,
    # A mosaic crystal (xrt_mosaic), counted as a run needs it
    # (mosaic_work): the cutoff per ray the bounds keep, the crystallite
    # basis per ray past it; per layer two normals, the crystallite normal,
    # d.n, the Bragg deviation, the rocking curve and the acceptance test
    # (mc) or the survival estimator's update (weight); a reflection per
    # reflected ray.
    "mosaic": {"cutoff": 19, "setup": 33, "layer_mc": 64, "layer_weight": 69,
               "reflect": 7},
    # The same in K5 (grad_mosaic_fwd), and its adjoint: per layer the six
    # forward-carried sums and their per-unit terms, per ray the scaling,
    # the pick's routing and the basis's reverse.
    "mosaic_k5": {"cutoff": 19, "setup": 33, "layer": 67, "reflect": 7,
                  "adjoint_layer": 44, "adjoint": 158},
}
# The card's published peaks (H100 SXM data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_MACS_PER_S = 494.5e12  # 989 TFLOP/s dense bf16
# The special function units: 16 results per SM per clock (the CUDA C++
# programming guide's throughput table, compute capability 9.0) on 132 SMs
# at the 1980 MHz boost clock. Every trans and sqrtdiv operation of R1's
# bodies takes one of them (expf one MUFU.EX2, sqrtf one MUFU.RSQ, a
# division one MUFU.RCP), so neither class can pass this rate.
SFU_PER_S = 16 * 132 * 1.98e9
CLASSES = ("mxu_macs", "trans", "sqrtdiv", "simple")
# The most a class's measured rate can be; a rate past it means the probe
# ran fewer steps than it counts.
PEAK_PER_S = {"mxu_macs": BF16_MACS_PER_S, "trans": SFU_PER_S,
              "sqrtdiv": SFU_PER_S, "simple": FP32_OPS_PER_S}
SCENARIO_NAMES = ["toroidal", "mosaic15", "plasma_torus", "flagship"]
CHUNK = 8192  # the rays of the census's one twin call
RATE_ROUNDS = 3  # microbench_rates times every probe this often, in turn


def optic_structs(fparams) -> list:
    """(shape, interact, apertures, imaged, file rocking, Chebyshev operations)
    of each optic of packed buffers."""
    ip = [int(x) for x in fparams.ip.tolist()]
    out = []
    for e in range(ip[0]):
        oi = ip[ft.HDR_I + ft.OPT_I * e: ft.HDR_I + ft.OPT_I * (e + 1)]
        cheb = 0
        if oi[0] == 4:  # the degree, and the terms: one per nonzero coefficient
            c = OPS_PER_RAY["cheb"]
            cheb = c["setup"] + 4 * (c["step"] + c["per_degree"] * (oi[13] - 1)
                                     + c["per_coef"] * oi[14])
        out.append((oi[0], oi[2], oi[5], oi[7] >= 0, oi[2] == 1 and oi[3] == 2, cheb))
    return out


def generic_source_ops(fparams) -> int:
    """The generic source's float32 operations per ray, from its packed
    structure (header ints 2 and 8-15, the box sizes at fp[33:36])."""
    ip = [int(x) for x in fparams.ip.tolist()]
    sizes = [float(x) for x in fparams.fp[33:36].tolist()]
    ops = OPS_PER_RAY["cone"][ip[2]]
    ops += OPS_PER_RAY["aim"] if ip[10] else OPS_PER_RAY["rotation"]
    if ip[9]:
        ops += OPS_PER_RAY["box"][ip[9]] * sum(1 for x in sizes if x != 0.0)
    if ip[11] == 1:
        ops += OPS_PER_RAY["band"]
    ops += OPS_PER_RAY["gauss"] * ip[12] + OPS_PER_RAY["cauchy"] * ip[13]
    ops += OPS_PER_RAY["doppler"] * ip[14] + OPS_PER_RAY["sightline"] * ip[8]
    return ops


def optic_k1_ops(fparams) -> list:
    """K1's and K3's float32 operations per ray of each optic of the chain
    (a crystal's test or weighting, nearest or bilinear images; a mosaic
    crystal's layers are counted apart, ``mosaic_work``)."""
    image = OPS_PER_RAY["image_bilinear_k1" if fparams.bilinear else "image_nearest"]
    out = []
    for shape, interact, n_ap, imaged, file, cheb in optic_structs(fparams):
        crystal = OPS_PER_RAY["crystal_mc_file" if file else "crystal_mc"]
        ops = (cheb or OPS_PER_RAY["shape_k1"][shape]) + OPS_PER_RAY["bounds"]
        ops += n_ap * OPS_PER_RAY["aperture"]
        ops += {0: 0, 1: crystal, 2: OPS_PER_RAY["mirror"], 3: 0}[interact]
        out.append(ops + (image if imaged else 0))
    return out


def chain_k1_ops(fparams) -> int:
    """K1's and K3's chain: float32 operations per ray, every optic's
    (:func:`optic_k1_ops`)."""
    return sum(optic_k1_ops(fparams))


def k1_ops(fparams) -> int:
    """K1's float32 operations per ray: the source, then the chain."""
    ip = fparams.ip
    ops = OPS_PER_RAY["plasma_k1"] if int(ip[5]) == 1 else generic_source_ops(fparams)
    return ops + chain_k1_ops(fparams)


WARP = 32  # K1's lanes a warp; its rays r0 .. r0 + 31 with r0 a multiple of 32


def _trace_recorded(fparams, n: int, seed, uniforms, record, name: str) -> list:
    """K1's plain twin over ``n`` rays of a point or generic source
    (``fused_trace._trace_slice``, the Philox stream of ``seed`` or the
    explicit ``uniforms``), calling ``record(rays, e, px, py, pz, dx, dy,
    dz, alive, wt)`` with each slice's global ray indices after each element
    e (the source's 0, then the optics' 1 ..). Returns the twin's counts."""
    if fparams.plasma:
        raise ValueError(f"{name}: a point or generic source only")
    F = [float(x) for x in fparams.fp.tolist()]
    I = [int(x) for x in fparams.ip.tolist()]
    device = fparams.fp.device
    counts = torch.zeros(1 + fparams.n_optics, dtype=torch.int64, device=device)
    image = torch.zeros(fparams.img_total, dtype=torch.float32, device=device)
    for rays, alive, _ in ft._slices(fparams, n, n, None):
        ft._trace_slice(F, I, fparams.aux, alive, ft._draws(fparams, rays, uniforms, seed),
                        counts, image,
                        record=lambda e, *state, wl=None, rays=rays: record(rays, e, *state))
    return counts.tolist()


def live_lanes(fparams, n: int, seed=(1, 2), uniforms=None) -> dict:
    """What K1 really traces of ``n`` rays of a point or generic source:
    its plain twin (:func:`_trace_recorded`) gives each ray's alive mask
    into every optic, and a warp is K1's 32 rays of consecutive indices
    from a multiple of 32. Returns ``rays_into`` (the rays alive into each
    optic: the source's count, then the counts after each optic but the
    last), ``warps_into`` (the warps with a live lane into each optic),
    ``warps`` (all of them), ``dead_warp_share`` (the share of warps with no
    live lane at each optic) and ``counts`` (the twin's counts)."""
    device = fparams.fp.device
    into = torch.zeros((fparams.n_optics, n), dtype=torch.bool, device=device)

    def record(rays, e, *state):
        if e < fparams.n_optics:
            into[e, rays] = state[6]

    counts = _trace_recorded(fparams, n, seed, uniforms, record, "live_lanes")
    warps = -(-n // WARP)
    padded = torch.zeros((fparams.n_optics, warps * WARP), dtype=torch.bool, device=device)
    padded[:, :n] = into
    live = padded.reshape(fparams.n_optics, warps, WARP).any(dim=2).sum(dim=1)
    return {"rays_into": into.sum(dim=1).tolist(), "warps_into": live.tolist(),
            "warps": warps, "dead_warp_share": [1.0 - w / warps for w in live.tolist()],
            "counts": counts}


def _image_terms(o, oi, bilinear: bool, lxv, lyv, alive, w):
    """The terms an optic's hits add to its image (``xrt_trace_chain``,
    ``xrt_nearest_pixel``, ``xrt_splat``): the optic's packed floats ``o``
    and ints ``oi``, the hits' local coordinates (lxv, lyv), the rays alive
    after it and their weights w. Yields the terms that land on the grid,
    one tensor for nearest images, one a corner for bilinear ones; none
    where the optic keeps no image."""
    if oi[7] < 0:
        return
    nx, ny = oi[8], oi[9]
    fx = fused_multiply_add(lxv, o[23], o[24])[alive]
    fy = fused_multiply_add(lyv, o[23], o[25])[alive]
    w = w[alive]
    if not bilinear:
        fx, fy = torch.round(fx), torch.round(fy)
        yield w[(fx >= 0) & (fx < nx) & (fy >= 0) & (fy < ny)]
        return
    fx, fy = torch.clamp(fx, -2.0, nx + 1.0), torch.clamp(fy, -2.0, ny + 1.0)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    for xi in (x0, x0 + 1.0):
        wx = (1.0 - torch.abs(fx - xi)) * w
        for yi in (y0, y0 + 1.0):
            ok = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
            yield (wx * (1.0 - torch.abs(fy - yi)))[ok]


def image_adds(fparams, n: int, seed=(1, 2), uniforms=None) -> list:
    """The image terms K1 adds on ``n`` rays of a point or generic source,
    from its plain twin's record hook (:func:`_trace_recorded`): each
    optic's hits after it, their local coordinates from the recorded
    positions and their weights, through the kernels' nearest pixel or
    bilinear splat (:func:`_image_terms`). One dict an imaged optic:
    ``optic`` (its index in the chain), ``adds`` (the terms, one atomic
    each before K1 skipped zero terms), ``zero`` (those of exactly 0, which
    K1 does not issue) and ``subnormal`` (those below the smallest normal
    float32)."""
    F = [float(x) for x in fparams.fp.tolist()]
    I = [int(x) for x in fparams.ip.tolist()]
    bilinear = bool(I[ft.H_BILINEAR])
    out = {}

    def record(rays, e, px, py, pz, dx, dy, dz, alive, wt):
        if e == 0:
            return
        o = F[ft.SRC_F + (e - 1) * ft.OPT_F: ft.SRC_F + e * ft.OPT_F]
        oi = I[ft.HDR_I + (e - 1) * ft.OPT_I: ft.HDR_I + e * ft.OPT_I]
        rx, ry, rz = px - o[0], py - o[1], pz - o[2]
        lxv = rx * o[3] + ry * o[4] + rz * o[5]
        lyv = rx * o[6] + ry * o[7] + rz * o[8]
        w = torch.ones_like(px) if wt is None else wt
        for terms in _image_terms(o, oi, bilinear, lxv, lyv, alive, w):
            tally = out.setdefault(e - 1, {"optic": e - 1, "adds": 0, "zero": 0,
                                           "subnormal": 0})
            tally["adds"] += terms.numel()
            tally["zero"] += int((terms == 0).sum())
            tally["subnormal"] += int(((terms != 0) & (terms.abs() < 2.0**-126)).sum())

    _trace_recorded(fparams, n, seed, uniforms, record, "image_adds")
    return [out[e] for e in sorted(out)]


def k1_live_ops(fparams, live: dict, n: int) -> dict:
    """K1's float32 operations over ``n`` rays beside the flat census
    (``k1_ops`` a ray, every ray through every optic): ``live_rays``, the
    source's for every ray and each optic's (:func:`optic_k1_ops`) for the
    rays alive into it; ``live_warps``, each optic's for every lane of the
    warps with a live lane into it (what a kernel that skips dead warps
    issues). ``live``: :func:`live_lanes` of the same rays."""
    per_optic = optic_k1_ops(fparams)
    source = k1_ops(fparams) - sum(per_optic)
    return {"flat": k1_ops(fparams) * n,
            "live_rays": source * n + sum(o * r for o, r in zip(per_optic,
                                                                  live["rays_into"])),
            "live_warps": source * n + sum(o * w * WARP for o, w in zip(
                per_optic, live["warps_into"]))}


def k5_ops(static, backward: bool) -> int:
    """K5f's (or K5b's: forward plus adjoint) float32 operations per ray."""
    ip = static.ip
    plasma = int(ip[5]) == 2
    ops = OPS_PER_RAY["plasma_k5"] if plasma else generic_source_ops(static)
    if backward and plasma:
        ops += OPS_PER_RAY["adjoint_plasma"]
    for shape, interact, n_ap, imaged, file, _ in optic_structs(static):
        crystal = OPS_PER_RAY["crystal_weight_file" if file else "crystal_weight"]
        ops += (OPS_PER_RAY["shape_k5"][shape] + OPS_PER_RAY["bounds"]
                + n_ap * OPS_PER_RAY["aperture"]
                + {0: 0, 1: crystal, 2: OPS_PER_RAY["mirror"], 3: 0}[interact]
                + (OPS_PER_RAY["image_bilinear"] if imaged else 0))
        if backward:
            ops += (OPS_PER_RAY["adjoint"] + OPS_PER_RAY["adjoint_shape"][shape]
                    + (OPS_PER_RAY["adjoint_crystal_file" if file else "adjoint_crystal"]
                       if interact == 1 else 0))
    return ops


def bound(n_bytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the card's peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_pack(pipe):
    """K1's packed buffers of a pipeline, on its device and in its run modes."""
    src = ft._source_spec(pipe.source, {f.name: f for f in pipe.filters})
    return ft.pack_params(src, [ft._optic_spec(o) for o in pipe.optics], pipe.params,
                          pipe.device, **ft._chain_modes(pipe.general))


def k3_pack(pipe):
    """K3's packed buffers of a pipeline (rays read from memory), on its
    device and in its run modes."""
    return ft.pack_params({"name": None, "kind": ft.SRC_RAYS, "n_draws": 0},
                          [ft._optic_spec(o) for o in pipe.optics], pipe.params,
                          pipe.device, **ft._chain_modes(pipe.general))


def mosaic_work(fparams, n, weight) -> dict:
    """What a mosaic chain's run of ``n`` rays (Philox, seed (1, 2)) needs
    of its mosaic stage, counted by K1 itself on the card: the rays its
    bounds keep (with the cutoff off), the rays M past its cutoff, the
    layers it must evaluate and the reflections. In weight mode every ray
    past the cutoff evaluates all D layers and reflects once; in mc mode a
    ray evaluates layers until one accepts, so with A(d) the rays accepted
    within d layers (K1 run at depth d: the draws are keyed by index, so the
    first d layers are the same) the layers are sum_{l=1..D} (M - A(l - 1)),
    and A(D) reflect."""
    e = next(i for i in range(fparams.n_optics)
             if int(fparams.ip[ft.HDR_I + i * ft.OPT_I + 2]) == ft._INTERACT["mosaic"])
    io = ft.HDR_I + e * ft.OPT_I
    depth = int(fparams.ip[io + ft.OI_DEPTH])
    device = fparams.fp.device

    def count(depth_, weighted, cut=True):
        ip, fp = fparams.ip_host.copy(), fparams.fp.clone()
        ip[io + ft.OI_DEPTH] = depth_
        ip[ft.H_WEIGHT] = int(weighted)
        if not cut:
            fp[ft.SRC_F + e * ft.OPT_F + ft.O_MOSAIC_CUT] = -1.0
        fp_ = dataclasses.replace(fparams, fp=fp, ip=torch.as_tensor(ip, device=device),
                                  ip_host=ip)
        return int(ft.fused_run_cuda(fp_, n, n, seed=(1, 2))[0][1 + e])

    kept, entering = count(depth, True, cut=False), count(depth, True)
    accepted = None
    if weight:
        layers, reflected = entering * depth, entering
    else:
        accepted = [0] + [count(d, False) for d in range(1, depth + 1)]
        layers, reflected = sum(entering - a for a in accepted[:-1]), accepted[-1]
    cut = float(fparams.fp[ft.SRC_F + e * ft.OPT_F + ft.O_MOSAIC_CUT]) >= 0.0
    return {"kept": kept, "entering": entering, "layers": layers, "reflected": reflected,
            "depth": depth, "cut": cut, "accepted": accepted}


def mosaic_k1_ops(fparams, n, weight) -> tuple:
    """K1's float32 operations for ``n`` rays of a mosaic chain: every
    other stage per ray (``k1_ops``), the mosaic's cutoff per ray its
    bounds keep, its basis per ray past the cutoff, its layers and
    reflections as the run needs them (``mosaic_work``) and, in weight mode,
    one weighting per ray past the cutoff. Returns (operations, the
    work)."""
    w = mosaic_work(fparams, n, weight)
    m = OPS_PER_RAY["mosaic"]
    ops = k1_ops(fparams) * n + w["kept"] * (m["cutoff"] if w["cut"] else 0)
    ops += w["entering"] * (m["setup"] + (1 if weight else 0))
    ops += w["layers"] * m["layer_weight" if weight else "layer_mc"]
    ops += w["reflected"] * m["reflect"]
    return ops, w


def mosaic_needed(work, n, seed=0) -> np.ndarray:
    """Layers each of ``n`` rays must evaluate in a mosaic run whose work
    ``mosaic_work`` counted, drawn in random order from that run's
    distribution: 0 for a ray that does not enter the layers; in mc mode l
    for a ray first accepted at layer l - 1 (A(l) - A(l - 1) of them) and
    the depth for one no layer accepts; in weight mode the depth."""
    depth, entering = work["depth"], work["entering"]
    if work["accepted"] is None:
        sizes = [n - entering] + [0] * (depth - 1) + [entering]
    else:
        a = work["accepted"]
        sizes = [n - entering] + [a[l] - a[l - 1] for l in range(1, depth + 1)]
        sizes[depth] += entering - a[depth]
    needed = np.repeat(np.arange(depth + 1), sizes)
    return np.random.default_rng(seed).permutation(needed)


def mosaic_schedule(needed, depth: int, group: int, weight: bool, chunk: int = 4) -> dict:
    """Lane-layer slots (32 a warp and layer step) the mosaic stage takes
    for rays whose needed layers are ``needed`` ((n,), 0 for a ray that
    does not enter; n a multiple of 32, warps of consecutive rays):

    - ``serial``: each lane runs its own ray's layers, so a warp runs as
      many layer steps as its slowest ray needs;
    - ``cooperative`` (``xrt_mosaic``): each lane evaluates ``chunk``
      consecutive layers a round. In mc mode each round the first 32 /
      ``group`` rays still searching take ``group`` chunks each, and a ray
      stops after the round whose chunks hold its last needed layer; in
      weight mode a warp's E entering rays take ceil(E ceil(depth / chunk) /
      32) rounds. A round counts ``chunk`` steps, the most a lane of it
      runs.

    Returns those and ``layers``, the layers the rays need."""
    w = np.asarray(needed, dtype=np.int64).reshape(-1, 32)
    out = {"layers": int(w.sum()), "serial": 32 * int(w.max(axis=1).sum())}
    if weight:
        entering = (w > 0).sum(axis=1)
        rounds = -(-entering * -(-depth // chunk) // 32)
        out["cooperative"] = 32 * chunk * int(rounds.sum())
        return out
    tasks = 32 // group
    base = np.zeros_like(w)
    searching = w > 0
    rounds = 0
    while searching.any():
        rounds += int(searching.any(axis=1).sum())
        taken = searching & (np.cumsum(searching, axis=1) <= tasks)
        done = taken & (w <= base + group * chunk)
        base = base + group * chunk * taken
        searching = searching & ~done
    out["cooperative"] = 32 * chunk * rounds
    return out


# ---------------------------------------------------------------------------
# The census.
# ---------------------------------------------------------------------------

TRANS = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sin", "cos", "tan",
    "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh", "asinh", "acosh",
    "atanh", "erf", "erfc", "erfinv", "sigmoid", "pow", "float_power",
}
SQRTDIV = {"sqrt", "rsqrt", "div", "reciprocal", "remainder", "fmod", "floor_divide"}
MATMULS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot"}
FREE = {
    "_unsafe_view", "clone", "copy", "contiguous", "index", "index_select", "gather",
    "take", "masked_select", "nonzero", "cat", "stack", "full", "zeros", "ones",
    "empty", "empty_strided", "new_zeros", "new_ones", "new_full", "new_empty",
    "zeros_like", "ones_like", "full_like", "empty_like", "fill", "zero",
    "scalar_tensor", "arange", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
    "repeat", "flip", "roll", "resize",
}
REDUCTIONS = {
    "sum", "mean", "prod", "amax", "amin", "any", "all", "argmax", "argmin",
    "count_nonzero", "cumsum", "cumprod", "logsumexp", "norm", "linalg_vector_norm",
    "var", "std", "nansum", "max", "min",
}
SCATTER_ADDS = {"index_add", "scatter_add", "scatter_reduce", "index_reduce", "bincount"}


def _numel(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (tuple, list)):
        return next((t.numel() for t in x if isinstance(t, torch.Tensor)), 0)
    return 0


def _classify(func, args, kwargs, out) -> tuple:
    """(class, count) of one ATen operation; class None for a free one."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]  # an in-place variant counts as its operation, once
    overload = func._overloadname
    if name in MATMULS:
        a = args[1] if name in ("addmm", "baddbmm", "addmv") else args[0]
        k = a.numel() if name == "dot" else a.shape[-1]
        return "mxu_macs", _numel(out) * k
    if name == "index_put":
        accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        if not accumulate:
            return None, 0  # a store
        idx = [t.numel() for t in args[1] if t is not None and t.dtype != torch.bool]
        return "simple", max([args[2].numel(), *idx])
    if func.is_view or name in FREE:
        return None, 0
    if name == "_to_copy":
        changed = "dtype" in kwargs and kwargs["dtype"] != args[0].dtype
        return ("simple", _numel(out)) if changed else (None, 0)
    if name == "searchsorted":
        return "simple", _numel(out) * max(1, math.ceil(math.log2(max(args[0].shape[-1], 1))))
    if name in SCATTER_ADDS:
        source = args[0] if name == "bincount" else args[3]
        return "simple", _numel(source)
    if name in REDUCTIONS and overload not in ("other", "out"):  # max.other is binary
        return "simple", _numel(args[0])
    if name == "pow" and overload == "Tensor_Scalar":
        exponent = args[1]
        if float(exponent).is_integer():
            return "simple", 2 * _numel(out)  # as JAX's integer_pow
    if name in TRANS:
        return "trans", _numel(out)
    if name in SQRTDIV:
        return "sqrtdiv", _numel(out)
    return "simple", _numel(out)


class OpCensus(TorchDispatchMode):
    """Counts, by class, the operations that run inside the ``with`` block;
    ``by_op`` keeps each ATen operation's count under its class."""

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(CLASSES, 0.0)
        self.by_op = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cls, n = _classify(func, args, kwargs, out)
        if cls is not None:
            self.counts[cls] += n
            self.by_op[(cls, func.overloadpacket.__name__)] += n
        return out


def count_ops(fn, *args, **kwargs) -> dict:
    """Census by class of the ATen operations ``fn(*args, **kwargs)``
    dispatches: ``{"mxu_macs", "trans", "sqrtdiv", "simple"}``.

    The rules, after JAX's ``tools/roofline.count_ops``:

    - ``mxu_macs``: a matrix product (mm, bmm, addmm, baddbmm, mv, addmv,
      dot) counts its output elements times its contraction length;
    - ``trans``: exp, log, the trigonometric and hyperbolic functions and
      their inverses, erf, erfc, erfinv, sigmoid and pow count their output
      elements; pow by an integral scalar counts 2 simple operations an
      element instead, as JAX's integer_pow;
    - ``sqrtdiv``: sqrt, rsqrt, div, reciprocal, remainder, fmod and
      floor_divide count their output elements;
    - free: views, indexing and gathers, copies and stores (``index_put_``
      without accumulation), ``cat`` and ``stack``, ``full``, ``zeros``,
      ``empty`` and their kin, ``arange``, and ``_to_copy`` that keeps the
      dtype (a device copy); a ``_to_copy`` that changes it is a type
      conversion, one simple operation an element, as in JAX;
    - reductions (sum, max, any, ...) count their input elements, and
      scatter-adds (``index_add_``, ``scatter_add``, ``index_put_`` with
      ``accumulate=True``, ``bincount``) the elements they scatter;
    - ``searchsorted`` counts ceil(log2 B) simple operations an output
      element, the binary search over B sorted values that K1f and K4 do;
    - everything else that computes is ``simple``, one an output element.

    An in-place variant (``add_``) counts once, as its operation. Only
    tensor operations are seen: arithmetic on Python floats (the twin's
    scalar parameter list) is per-call set-up and counts nothing.
    """
    with OpCensus() as census:
        fn(*args, **kwargs)
    return dict(census.counts)


def _chain_census(config, chunk: int) -> tuple:
    """(counts, by_op, pipeline) of K1's twin on one chunk: see
    :func:`chain_ops_per_ray`. The draws and bundle tables come from seed 0."""
    from xicsrt_tpu_torch.draws import Draws
    from xicsrt_tpu_torch.engine import Pipeline

    pipe = Pipeline(config, device="cpu")
    fparams = k1_pack(pipe)
    rng = np.random.default_rng(0)
    uniforms = torch.from_numpy(rng.random((fparams.n_draws, chunk), dtype=np.float32))
    bundles = None
    if fparams.plasma:
        bundles = ft.plasma_bundles(pipe.source, pipe.params["sources"][pipe.source.name],
                                    pipe.params["filters"],
                                    Draws(torch.Generator().manual_seed(0)), 1)
    with OpCensus() as census:
        ft.fused_run_plain(fparams, chunk, chunk, uniforms, (0, 0), bundles)
    return census.counts, census.by_op, pipe


def chain_ops_per_ray(config, chunk: int = CHUNK):
    """K1's census per ray for a config: :func:`count_ops` of the plain twin
    ``fused_run_plain`` on one chunk of ``chunk`` rays on the CPU, divided
    by the chunk. It covers the source, the chain and the images; the
    draws are explicit uniforms from a seeded numpy generator, so no Philox
    work is counted, and a plasma's bundle tables (``plasma_bundles``, one
    iteration) are drawn before the census. The twin evaluates every layer
    of a mosaic crystal for every ray, so for a mosaic the census bounds
    the run's work from above (K1 stops at a ray's accepting layer).
    Returns (counts per ray, the pipeline)."""
    counts, _, pipe = _chain_census(config, chunk)
    return {k: v / chunk for k, v in counts.items()}, pipe


def k5_ops_per_ray(config, backward: bool, chunk: int = CHUNK):
    """K5's census per ray for a config, taken to the gradient path's modes
    (weight mode, bilinear images, as ``make_fused_differentiable`` takes
    it): :func:`count_ops` of K5f's plain twin
    ``fused_grad_forward_plain`` (``backward`` False) or K5b's
    ``fused_grad_vjp_plain`` (True: the forward, saved once, then the hand
    adjoint and the slot sums) on one chunk of ``chunk`` rays on the CPU,
    divided by the chunk. The draws are explicit uniforms and the cotangent
    images normal deviates, both from a seeded numpy generator. The twin's
    slot sums convert each term to float64 before its sum, one simple
    operation a term more than K5b's float32 column adds. Returns (counts
    per ray, the pipeline)."""
    from xicsrt_tpu_torch.engine import Pipeline
    from xicsrt_tpu_torch.gradients import _differentiable_config
    from xicsrt_tpu_torch.ops import fused_grad as fg

    pipe = Pipeline(_differentiable_config(config), device="cpu")
    _, _, pack, spec = fg.build_fused_diff(pipe, num_iter=1)
    static, lam = spec["static"], spec["lam"]
    pvec = pack(pipe.params).detach()
    rng = np.random.default_rng(0)
    uniforms = torch.from_numpy(rng.random((static.n_draws, chunk), dtype=np.float32))
    if backward:
        g = torch.from_numpy(rng.standard_normal(static.img_total).astype(np.float32))
        counts = count_ops(fg.fused_grad_vjp_plain, static, pvec, chunk, lam, g,
                           uniforms=uniforms, chunk=chunk)
    else:
        counts = count_ops(fg.fused_grad_forward_plain, static, pvec, chunk, lam,
                           uniforms=uniforms, chunk=chunk)
    return {k: v / chunk for k, v in counts.items()}, pipe


def k3_ops_per_ray(config, chunk: int = CHUNK):
    """K3's census per ray for a config: :func:`count_ops` of its twin
    ``fused_trace_run_plain`` on the first ``chunk`` rays of one iteration of
    the config's eager source, generated on the CPU from seed 0 (their
    weights in weight mode). It is the chain alone, without a source: K3
    reads its rays, 29 bytes a ray (origin and direction, wavelength, a
    mask byte), 33 in weight mode (the weight). The draws are explicit
    uniforms from a seeded numpy generator. Returns (counts per ray, bytes a
    ray, the pipeline)."""
    from xicsrt_tpu_torch.draws import Draws
    from xicsrt_tpu_torch.engine import Pipeline

    pipe = Pipeline(config, device="cpu")
    fparams = k3_pack(pipe)
    rays = pipe.source.generate(pipe.params["sources"][pipe.source.name],
                                Draws(torch.Generator().manual_seed(0)),
                                pipe.params["filters"])
    m = min(chunk, rays.n)
    rng = np.random.default_rng(0)
    uniforms = torch.from_numpy(rng.random((fparams.n_draws, m), dtype=np.float32))
    weight = rays.weight[:m].float().contiguous() if fparams.weight else None
    counts = count_ops(ft.fused_trace_run_plain, fparams, rays.origin[:m].float(),
                       rays.direction[:m].float(), rays.wavelength[:m].float(),
                       rays.mask[:m], uniforms, weight=weight)
    return {k: v / m for k, v in counts.items()}, 29 + 4 * int(fparams.weight), pipe


def mosaic_ops_as_run(config, work, n: int, chunk: int = CHUNK) -> dict:
    """K1's census per ray of a mosaic chain as a run of ``n`` rays needs
    its layers (``work``: :func:`mosaic_work` of that run): the twin's
    census (:func:`chain_ops_per_ray`: every layer of every ray) less the
    layers the run does not evaluate, depth - layers / n a ray, each at one
    layer's census, the census at the chain's depth less that at one layer
    fewer."""
    full, _ = chain_ops_per_ray(config, chunk)
    fewer_cfg = copy.deepcopy(config)
    crystal = next(o for o in fewer_cfg["optics"].values() if "mosaic_depth" in o)
    if int(crystal["mosaic_depth"]) != work["depth"] or work["depth"] < 2:
        raise ValueError("mosaic_ops_as_run: the work is of another depth, or depth < 2")
    crystal["mosaic_depth"] = work["depth"] - 1
    fewer, _ = chain_ops_per_ray(fewer_cfg, chunk)
    unused = work["depth"] - work["layers"] / n
    return {c: full[c] - unused * (full[c] - fewer[c]) for c in full}


def serial_ms(counts: dict, rates: dict, n_rays: int, n_bytes: float = 0.0) -> float:
    """The class-rate serial bound of ``n_rays`` rays in ms: each class's
    count per ray over the card's rate for it (``rates``, as
    :func:`microbench_rates` gives them), summed, and ``n_bytes`` read or
    written over the memory rate, added."""
    t = n_rays * sum(counts.get(cls, 0.0) / rates[f"{cls}_per_s"] for cls in CLASSES)
    return (t + n_bytes / HBM_BYTES_PER_S) * 1e3


def overlap_ms(counts: dict, rates: dict, n_rays: int, n_bytes: float = 0.0) -> float:
    """The class-rate overlap bound in ms: the largest of the classes'
    times and of ``n_bytes`` over the memory rate."""
    times = [n_rays * counts.get(cls, 0.0) / rates[f"{cls}_per_s"] for cls in CLASSES]
    return max(*times, n_bytes / HBM_BYTES_PER_S) * 1e3


# ---------------------------------------------------------------------------
# The card's class rates.
# ---------------------------------------------------------------------------

def body_ops(body: str) -> dict:
    """The census of one step of R1's ``body`` per element. Each body is
    named for the class it measures: the numerator of its rate is that
    class's count times the steps a call runs."""
    n = 1024
    counts = count_ops(rp.BODIES[body], torch.ones(n))
    return {k: v / n for k, v in counts.items()}


def nvidia_smi(fields: str = "name,power.limit") -> str:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader``: by
    default the card's name and power limit."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"unavailable ({err})"
    return out.stdout.strip() or "unavailable"


def microbench_rates(device="cuda") -> dict:
    """The card's rate of each class, measured by R1 and R2 at the TPU
    tool's sizes: elements (or MACs) per second, each rate the census of its
    body times the steps over the CUDA-event time of one launch. The probes
    are timed in turn, ``RATE_ROUNDS`` times over, and each keeps its best:
    after a burst of tensor-core work the card can run power-capped at a
    lower clock for a while, and a probe timed then reads low. A rate above
    ``PEAK_PER_S`` for its class is a fault of the probe, and raises."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("microbench_rates measures the card and needs CUDA; there is "
                           "no CPU fallback")
    seeds = torch.tensor([0.5 + 0.125 * (k % 5) for k in range(BS.LAUNCHES)],
                         dtype=torch.float32, device=device)
    mm_seeds = 0.01 + 0.002 * seeds
    launches = {body: functools.partial(_elem_launch, seeds, body) for body in rp.BODIES}
    launches["mma"] = lambda k: rp.mma_rate_cuda(mm_seeds[k:k + 1])
    ms = dict.fromkeys(launches, float("inf"))
    for _ in range(RATE_ROUNDS):
        for name, launch in launches.items():
            ms[name] = min(ms[name], BS.time_launches(launch))
    clocks = nvidia_smi("clocks.sm,power.draw,temperature.gpu,clocks_event_reasons.active")
    ops_per_step = {body: body_ops(body)[body] for body in rp.BODIES}
    rates = {body: rp.elem_steps(body) * ops_per_step[body] / (ms[body] * 1e-3)
             for body in rp.BODIES}
    rates["mxu_macs"] = rp.mma_macs() / (ms["mma"] * 1e-3)
    for cls, rate in rates.items():
        if not rate <= PEAK_PER_S[cls]:
            raise RuntimeError(f"microbench_rates: {cls} at {rate:.4g}/s exceeds the card's "
                               f"peak {PEAK_PER_S[cls]:.4g}/s: the probe is at fault")
    return {**{f"{cls}_per_s": rates[cls] for cls in CLASSES}, "ms": ms,
            "ops_per_step": ops_per_step, "device": torch.cuda.get_device_name(device),
            "nvidia_smi": nvidia_smi(), "sm_clock_power_temperature_after": clocks}


def _elem_launch(seeds, body, k):
    return rp.elem_rate_cuda(seeds[k:k + 1], body)


# ---------------------------------------------------------------------------
# The roofline.
# ---------------------------------------------------------------------------

def scenario_config(name: str) -> tuple:
    """(config on the fused engine, iterations) of a roofline scenario: the
    others of ``SCENARIOS`` at 2^22 rays x 4, the flagship at 2^27 x 1."""
    if name == "flagship":
        return BS._spectrometer_config(intensity=1 << 27, num_iter=1, keep_images=True,
                                       engine="fused"), 1
    config = BS.SCENARIOS[name](1 << 22, 4)
    config["general"]["engine"] = "fused"
    return config, 4


def measure_k1(config, num_iter: int) -> dict:
    """K1's rays/s on a config's packed buffers at its whole budget (the
    pipeline's rays times ``num_iter``; a plasma's slots), CUDA events over
    launches with a fresh seed each, and the launches counted."""
    from xicsrt_tpu_torch.draws import Draws
    from xicsrt_tpu_torch.engine import Pipeline
    pipe = Pipeline(config, device="cuda")
    fparams = k1_pack(pipe)
    n = pipe.num_rays * num_iter
    bundles = None
    if fparams.plasma:
        bundles = ft.plasma_bundles(pipe.source, pipe.params["sources"][pipe.source.name],
                                    pipe.params["filters"],
                                    Draws(torch.Generator(device="cuda").manual_seed(5)),
                                    num_iter)
    before = ft.fused_run_cuda.launches
    ms = BS.time_launches(lambda k: ft.fused_run_cuda(fparams, n, n, seed=(k, 11),
                                                   bundles=bundles))
    return {"rays": n, "ms": ms, "rays_per_s": n / (ms * 1e-3),
            "launches": ft.fused_run_cuda.launches - before, "fparams": fparams}


def measure_raytrace(config, n_rays: int) -> tuple:
    """(rays/s, seconds) of ``raytrace(config, device='cuda')`` over
    ``n_rays``, host work included: the second of two calls, by the host
    clock."""
    import time

    from xicsrt_tpu_torch import raytrace

    raytrace(config, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raytrace(config, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return n_rays / seconds, seconds


def _g(x: float) -> float:
    return float(f"{x:.4g}")


def roofline_row(name: str, rates: dict) -> dict:
    """One scenario's row: census, class times and shares, the two
    predictions, K1's measured rays/s, raytrace's, and the hand count."""
    config, num_iter = scenario_config(name)
    totals, by_op, _ = _chain_census(config, CHUNK)
    counts = {k: v / CHUNK for k, v in totals.items()}
    t_classes = {cls: counts[cls] / rates[f"{cls}_per_s"] for cls in CLASSES}
    pred_serial = 1.0 / sum(t_classes.values())
    pred_overlap = 1.0 / max(t_classes.values())
    k1 = measure_k1(config, num_iter)
    measured = k1["rays_per_s"]
    fparams = k1.pop("fparams")
    row = {
        "ops_per_ray": {k: round(v, 1) for k, v in counts.items()},
        "class_time_share": {k: round(v * pred_serial, 3) for k, v in t_classes.items()},
        "predicted_serial_rays_per_s": _g(pred_serial),
        "predicted_overlap_rays_per_s": _g(pred_overlap),
        "measured_rays_per_s": _g(measured),
        "measured_vs_serial_bound": float(f"{measured / pred_serial:.3g}"),
        "measured_vs_overlap_bound": float(f"{measured / pred_overlap:.3g}"),
        "census_ops_per_ray": round(sum(counts[c] for c in CLASSES if c != "mxu_macs"), 1),
        "hand_ops_per_ray": k1_ops(fparams),
        "census_by_op": {f"{cls} {op}": round(n / CHUNK, 2)
                         for (cls, op), n in by_op.most_common() if n / CHUNK >= 0.005},
        "k1": {k: (_g(v) if isinstance(v, float) else v) for k, v in k1.items()},
    }
    if name == "mosaic15":  # the hand count as the run needs the layers
        n_rays = 1 << 22
        ops, work = mosaic_k1_ops(fparams, n_rays, weight=False)
        row["hand_ops_per_ray"] = round(ops / n_rays, 1)
        row["mosaic_work"] = work
        row["census_is_upper_bound"] = (
            f"the twin evaluates all {work['depth']} layers of every ray; the run needs "
            f"{work['layers'] / n_rays:.2f} a ray")
    rps, seconds = measure_raytrace(config, k1["rays"])
    row["raytrace_rays_per_s"] = _g(rps)
    row["raytrace_seconds"] = _g(seconds)
    return row


def main(argv=None) -> dict:
    """Measure the rates, then one row per scenario; print a line per
    scenario and write the JSON to ``--out``. Returns the JSON."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("scenarios", nargs="*", choices=["flagship", *BS.SCENARIOS],
                        metavar="scenario",
                        help=f"'flagship' or a key of SCENARIOS (default: "
                             f"{' '.join(SCENARIO_NAMES)})")
    parser.add_argument("--out", default=os.path.join(native.BUILD_ROOT, "roofline.json"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline measures the card and needs CUDA; there is no "
                           "CPU fallback")
    rates = microbench_rates()
    print(f"card: {rates['nvidia_smi']}; rates: "
          + ", ".join(f"{c} {rates[f'{c}_per_s']:.4g}/s" for c in CLASSES)
          + f"; SM clock, power, temperature, clock limits after: "
          f"{rates['sm_clock_power_temperature_after']}", flush=True)
    out = {"device": rates["device"], "nvidia_smi": rates["nvidia_smi"],
           "rates": {k: v for k, v in rates.items() if k.endswith("_per_s")},
           "rate_ms": rates["ms"], "ops_per_step": rates["ops_per_step"],
           "sm_clock_power_temperature_after": rates["sm_clock_power_temperature_after"],
           "scenarios": {}}
    for name in args.scenarios or SCENARIO_NAMES:
        row = roofline_row(name, rates)
        out["scenarios"][name] = row
        print(name, json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
