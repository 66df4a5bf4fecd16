"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``. Phases:

1. device: the card's name and power limit, toolchain versions;
2. build: compile the CUDA kernels of ``xicsrt_tpu_torch/csrc``; the
   registers, spills, stack frame, block size and resident warps of every
   K5f and K5b variant, of every K1, K2 and K3 build and of R2, for K1 and
   K2 also the warps their launch's shared memory leaves resident (a K5f,
   K5b, K1 or K3 build that spills fails); K1 has a point, a generic and a
   plasma source build of each chain stage, and the point source's builds
   without the torus code: with neither it nor the cylinder's
   (``fused_trace_flat_kernel``), with the cylinder's
   (``fused_trace_cylinder_kernel``), each without further stages or with
   the weight and bilinear stages, and with neither and a window of its
   images staged (``fused_trace_dense_kernel``) (23, and 23 marked for
   K1e);
3. K2 (binning kernel) against its plain twin on the card: each flagship
   image alone, then one launch for both on dense hits and on the main
   path's own eager items;
4. K1a (fused trace kernel) against its plain twin on the card, 0 rays
   and pixels apart;
5. the main path on the fused engine, ``raytrace(config, device='cuda')``;
6. the main path on the eager engine with the binning kernel;
7. timings: kernels against their twins, K2 on the main path's own input
   and on dense hits beside ``torch.bincount``, calls back to back and on
   the card alone (K2 by ``device_ms``, bincount's kernels by
   ``kernel_ms``), both engines' rays/s;
8. K5f (fused gradient forward kernel) against its plain twin;
9. K5b (its adjoint kernel) against its float32 and float64 twins, and
   linear in g;
10. the gradient path: ``make_fused_differentiable`` on the flagship at
    full width (forward + vjp), then sign descent recovering a perturbed
    crystal d-spacing (example 07's loop);
11. eager autograd on CUDA: ``make_differentiable`` + ``align`` on example
    04's task, and d(detector)/d(spacing) from autograd against K5b;
12. gradient timings: K5f and K5b against their twins, the rays/s of one
    forward+vjp step, the eager autograd step;
13. K4 (bundle-gather kernel: a warp's rays search their bundles
    together and store their rows lane-contiguous) against its plain twin:
    B = 4000 and 1e5,
    2^24 rays plus 1000 past the last bundle, zero-count bundles; beside
    its time, ``torch.repeat_interleave`` of the table by the bundles'
    counts, zero-padded to its rows (equal to K4's), the yardstick;
14. K1 with a plasma source and a toroidal crystal (K1f, K1c-torus)
    against its twin: ``plasma_torus`` at 2^20 rays x 2 iterations, the
    same bundle tables, both RNG modes; and at 1e5 bundles with runs of
    zero-photon bundles and 32 m + 17 slots an iteration
    (``ragged_bundles``: a warp's live lanes in two iterations);
15. the plasma path: the bundle counts' Poisson statistics on the card,
    then example 03 exactly as written through
    ``raytrace(config, device='cuda')`` on the eager engine (K4), and on the
    fused engine with ``keep_history=False`` (K1);
16. plasma at full width with timings: ``plasma_torus`` and ``plasma_100k``
    at 2^24 expected photons per iteration x 4 on the fused engine, the
    eager engine at 2^22, K4 and K1-plasma against their twins; K1-plasma
    on the same slots at 1000 and at 1e5 bundles, with flat bounds;
17. the torus golden (``tests/golden/torus_reference_image.npz``) on both
    engines with the statistical test of
    ``tests/test_reference_parity_families.py``;
18. K1's cylinder stage (K1c-cylinder): the build the launcher picks in mc
    mode, in weight mode and with bilinear images
    (``fused_trace_cylinder_kernel``, or the phase fails) and the blocks
    resident at its launch; K1 against its twin at 2^20 rays in both RNG
    modes in the three modes (``twin_equal``: 0 rays and 0 pixels apart in
    mc) and with 'found' history (K1e, ``k1e_against_twin``); then a
    cylindrical crystal through ``raytrace`` on both engines; K1's time
    on it beside K1a's, and the build's registers;
19. K5f and K5b with the torus, cylinder and plasma stages against their
    float32 and float64 twins on ``tests/test_fused_grad.py``'s variants
    (toroidal crystal, convex toroidal mirror, cylindrical crystal, convex
    cylindrical mirror, cubic plasma) at 2^20 rays, both RNG modes;
20. example 07 as written (``examples/example_07_fused_gradients.py``):
    sign descent on its toroidal crystal, and on its cylindrical twin;
21. example 08 as written (``examples/example_08_plasma_fitting.py``):
    200 Adam steps on (log E, log T); d/dE against a finite difference of
    K5f, d/dT against the eager engine's autograd;
22. gradient timings at full width: example 07's chain, its cylindrical
    twin and a cubic plasma, 2^22 rays x 4 iterations each;
23. K1b (the generic source matrix in K1) against its twin on eight source
    variants (boxes, Voigt and uniform lines, Doppler, Focused, flat,
    flat_xy, gaussian and asymmetric isotropic_xy cones, a sightline) at
    2^20 rays, both RNG modes, and on phase 24's source at its 2^24 rays;
    its time; then every K1 build of the plasma and of the generic sampler
    past their own (weight mode, bilinear images, a mosaic and a mesh
    crystal; K1e 'found') against its twin at 2^18 rays;
24. the source matrix through ``raytrace(config, device='cuda')`` on both
    engines at 2^22 rays x 4: a focused gaussian source of the Ar XVII line
    (1 keV, natural width, 1e5 m/s flow along the sightline) on the
    flagship crystal, and a sightline-filtered uniform box; each engine's
    images against the other's (two-sample chi-square), the eager engine's
    detected line against scipy's Voigt profile shifted by the flow;
25. K3 (the trace-only kernel) against its twin, then ``plasma_torus`` with
    8e6 bundles at 2^24 expected photons x 2 on ``engine='fused'`` (K4
    generates, K3 traces), and K3's time and its twin's output on those
    1.97e7 rays, and the census a ray of K3's chain (``k3_ops_per_ray``);
26. K5f and K5b with the generic sampler against their twins on
    ``tests/test_fused_grad.py``'s six source-matrix variants at 2^20
    rays, then ``make_fused_differentiable`` on ``focused_gaussian_voigt``
    at 2^22 rays x 4 with timings;
27. mirrors (K1c-mirror): the build of K1 each of four mirror chains takes
    (``MIRROR_BUILDS``: a window of the images staged where no torus is in
    the chain), then K1 and K3 against their twins, 0 rays apart in both
    RNG modes, on them (a plane fold, convex toroidal crystals without
    their Bragg check, a convex cylindrical mirror, the flagship with its
    crystal unchecked) at 2^20 rays; the fold and the unchecked flagship
    through ``raytrace`` on both engines at 2^22 x 4;
28. file rocking curves (K1c-file): the script writes its own XOP table;
    K1 and K3 against their twins on the flagship's file crystal (sigma and
    pi mixed 0.7 : 0.3); the two engines at 2^22 x 4; the pure-sigma table
    against the gaussian crystal it tabulates within 6 sqrt(N);
29. K5f and K5b with a file curve (K5c-file) on ``file_rocking`` at 2^22
    rays against their float32 and float64 twins, then
    ``make_fused_differentiable`` on it;
30. meshes (K1c-cheb): example 06 as written on both of its engines; its
    mesh crystal and the mesh cylinder and torus at 2^24 x 4 fused, each
    against its analytic shape, and 2^22 x 2 eager; the
    ``mesh_sphere`` golden on both engines; K1 and K3 with the Chebyshev
    stage against their twins at 2^20 rays, and K3 behind a plasma;
31. timings per 2^22 rays of K1c-mirror, K1c-file, K1c-cheb and K5f/K5b
    with a file curve beside K1a, and the ptxas registers of K1a's and
    K1c-mirror's builds; the build the launcher picks
    (``xrt_fused_trace_build``, ``k1_build_name``) for K1a's and K1c-file's
    chains (``fused_trace_flat_kernel<0>``) and K1c-mirror's
    (``fused_trace_dense_kernel``), or the phase fails;
32. ``mosaic15`` (``tools/bench_scenarios.py``: a spherical mosaic crystal,
    depth 15, 0.05 deg, 150 urad) in mc mode through ``raytrace`` on
    ``engine='fused'`` at 2^26 x 4 (K1c-mosaic) and on the eager engine at
    2^22 x 4: budgets, images summing to counts, the engines within 5
    binomial sigma, rays/s;
33. ``mosaic15`` in weight mode on both engines: the crystals' counts
    within 5 binomial sigma, the weighted detector sums within 5 sigma of
    each other and of phase 32's mc count;
34. the flagship in weight mode, with bilinear images and with both
    (K1d), fused at 2^26 x 4 and eager at 2^22 x 4, with
    ``tests/test_fused_engine.py:897-942``'s checks, and the fused
    detector images' sums held within 1e-5 of what they must sum to: the
    bilinear mc image its count, the weight and 'both' images (the same
    rays, nearest and bilinear) each other's; the largest relative error
    printed;
35. the reference's ``mosaic`` golden on both engines;
36. K1 and K3 against their twins in both RNG modes at 2^20 rays on
    mosaic chains (mc, weight, a cutoff, a file curve, depth 33 with half
    the rays dead, a mesh) and on the weight, bilinear and 'both'
    flagship: counts equal, images within the bound of float32 summation
    order;
37. K5d: K5f and K5b with the mosaic stage on ``mosaic_sphere`` at 2^22
    rays against their twins, then ``make_fused_differentiable`` on it;
38. K3 in weight mode on its own route (an 8e6-bundle plasma, mc against
    weight), and the timings per 2^22 rays of K1d, K1c-mosaic, K3-weight,
    K3 behind a mosaic and K5d beside K1a, with the ptxas registers of their
    builds; the image terms K1d adds and those of exactly zero, which it
    does not issue (``tools/roofline.image_adds``, the twin on 2^17 rays);
    K3-weight's census, and ``mosaic15``'s layer work (``mosaic_
    work``), its lane-layer slots a ray a lane and spread over the warp
    (``mosaic_schedule``) and its census as run (``mosaic_ops_as_run``);
39. the history reservoir K1e (the probe, K1's marked build, the chunk
    selection and the record launch) against its twin on the flagship at
    2^20 rays, chunk 8192: 'found' and 'sampled', mc and weight mode, both
    RNG modes, 'found' on ``mosaic15`` in mc and weight mode, and 'found'
    on a narrowed detector where about a third of the chunks keep a ray:
    counts, images, kept chunks and every recorded value equal; for each
    'found' run the probe's marks, count and flag equal to its twin's, and
    the call that probes (two K1 launches) against the one whose K1 marks
    every chunk (``probe_from``): counts, images and reservoir equal to
    each other's and the twin's; the flagship and ``mosaic15`` found by
    the probe, the narrowed detector by the marks (the fallback);
40. the flagship at 2^26 x 4 through ``raytrace(config, device='cuda')``
    with ``keep_history`` False, 'found' and 'sampled': rays/s of each, the
    K1, probe and record launches of each, the ``raytrace_run`` and
    ``sort_history`` spans of the 'found' call, its meta and images and
    the 'sampled' call's equal to the call's without history, the found
    history's bounds and invariants, the sampled found share within 5
    binomial sigma of the run's efficiency and its lost sample truncated,
    the probe path against the marked build at full width (and the probe
    against its twin), K1e's time against K1's
    (the main launch, the probe, the selection and record, and
    ``torch.nonzero`` of the marks beside the selection), and the
    registers of its builds;
41. ``plasma_torus`` with ``keep_history='found'`` at 2^22 photons x 4: the
    same invariants, and the probe path against the marked build;
42. ``python -m xicsrt_tpu_torch`` as a subprocess on a written config
    (``--save --numiter 2 --seed 3``): exit 0, its results file's meta equal
    to an in-process run's, the found history in it; the script imports
    neither h5py nor matplotlib.

43. the roofline's elementwise probe R1 (``elem_rate_cuda``) for the exp,
    sqrt-division and simple bodies against its plain chains summed in
    float64, held to a float32 summation-order bound (``r1_bound``): at
    K = 1 .. 4 steps, each K at least 10 bounds from the last, and at the
    TPU tool's sizes; the time its steps add (less its time at K = 0) at
    K = 128 within 5 % of twice that at K = 64, so the loop runs the steps
    the rates count;
44. the tensor-core probe R2 (``mma_rate_cuda``, ``wgmma``) against its
    plain version at 264 and 8192 grid steps, held to ``r2_bound``; its
    time beside ``torch.matmul`` of the same MACs on bf16 operands, the
    yardstick, in turns;
45. ``python -m xicsrt_tpu_torch.tools.roofline``'s ``main`` on
    ``toroidal``, ``mosaic15``, ``plasma_torus``, the flagship and
    ``mesh41`` (a 41 x 41 mesh crystal, K1c-cheb): the class rates (R1's
    and R2's times; the kernel rows report R1's, and R2's of phase 44,
    taken beside its yardstick), each beside the card's
    peak for its class, each scenario's census by class, the predicted
    serial and overlap rays/s beside K1's and ``raytrace``'s measured ones;
    every row finite and positive, R1, R2 and K1 launched in its run; then
    each K5 chain's census per ray (its twins on the CPU), its class-rate
    serial bound at 2^22 rays, and K5f's and K5b's times over it; and K3's
    (phases 25 and 38) and K1c-mosaic's (38, as run) serial and overlap
    bounds at these rates beside their times; and K1b's (phase 23),
    K1c-mirror's (31), K1c-cylinder's (18) and K1 plasma+torus's at 1000
    and 1e5 bundles (16)
    census a ray and serial bound (``chain_ops_per_ray``, no Philox work
    counted) beside their times;
46. ray-sharded runs in one process (``parallel.make_sharded_run``): the
    flagship fused over a mesh of one CUDA device and ``raytrace_mp`` on
    one card, each equal to ``raytrace`` to the bit; the flagship fused at
    2^26 x 2 (K1) and example 03 as written on the eager engine (K4) over
    2 shards on ``cuda:0``, counters read around each run: totals, images
    summing to counts, the efficiency within 5 binomial sigma of the
    unsharded run (phases 5 and 15), the shards' own runs different and
    summing to the result;
47. two ranks on the card through ``torch.distributed`` (gloo; this script
    run as ``--rank RANK PORT OUT`` in two processes): the flagship fused
    at 2^26 x 2 sharded over the ranks, meta and images equal on both and
    to phase 46's two shards in one process; rays/s of the two ranks
    against one process by ``scaling_efficiency``, one card shared, not a
    scaling result;
48. the gradient paths over 2 shards on ``cuda:0``:
    ``make_fused_differentiable`` (K5f, K5b) at 2^24 rays, its images and
    vjp vector against the sums of its shards' own, and
    ``make_differentiable``'s autograd gradient at 2^20 rays against its
    shards' sum;
49. the long optic chains (``tools/bench_scenarios.baffle_config``: the
    flagship behind aperture plates): K1 on ``baffle127`` (127 optics) in
    mc and weight mode and with bilinear images, K1e 'found' and K3 on it
    against their twins at 2^18 rays, both RNG modes; ``baffle127`` at 2^26
    x 4 through ``raytrace`` on the fused engine, with and without 'found'
    history, against the eager engine at 2^22 x 4; K1's and K3's ms per
    2^22 rays beside their bounds over the rays alive into each optic, and
    K1's ms a plate (against the flagship's); K5f and K5b on ``baffle42``
    (42 optics, K5b's replay build) against their twins at 2^18 rays, one
    ``make_fused_differentiable`` step at 2^22 x 4 and their times per 2^22
    rays, K5b's optic forwards a ray as built, and K5b on the flagship in
    its recomputing and its replay build, in turns.

It prints one JSON line of kernel results, then, as its last line, the
device summary. Any failure raises, and the script exits non-zero without
the summary. It needs one CUDA device and no network.

Each kernel's ``bound_ms`` is the least time the card could take for the
same work at the timed call's inputs: the larger of its bytes (each input
read once, each output written once) over 3.35 TB/s and its float32
operations over 67 TFLOP/s. Operations are counted per ray and stage in
``OPS_PER_RAY`` (``xicsrt_tpu_torch/tools/roofline.py``) from
``xicsrt_tpu_torch/csrc``; K1 on a point or generic source counts each
optic's for the rays alive into it (``k1_bounds``; ``bound_ms_flat``:
every ray through every optic); K5b's work is one forward and one adjoint per
ray, not the kernel's recomputation. R1's operations are its bodies'
census; R2's bound is 2 x its MACs over 989 TFLOP/s (dense bf16).
"""

from __future__ import annotations

import copy
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from xicsrt_tpu_torch.tools import bench_scenarios as BS
from xicsrt_tpu_torch.tools.roofline import (OPS_PER_RAY, bound, chain_k1_ops,
                                             chain_ops_per_ray, k1_ops,
                                             k1_pack, k3_ops_per_ray, k5_ops, k5_ops_per_ray,
                                             mosaic_k1_ops, mosaic_needed, mosaic_ops_as_run,
                                             mosaic_schedule, mosaic_work, overlap_ms,
                                             serial_ms)
from xicsrt_tpu_torch.tools.roofline import k3_pack as _k3_pack

# Efficiency of the flagship chain on the JAX fused engine (source ->
# aperture -> crystal -> detector); a physics figure, not a speed.
REFERENCE_EFFICIENCY = 0.01334
FLAGSHIP_IMAGES = ((100, 100, 0.002), (100, 50, 0.004))


def packed_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def log(msg: str) -> None:
    print(msg, flush=True)


def tool_version(cmd: list) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"unavailable ({err})"
    return out.stdout.strip().splitlines()[-1] if out.stdout.strip() else "unavailable"


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, hold_cycles: int = 50_000_000) -> float:
    """Mean milliseconds per call of ``fn`` on the card alone: the calls are
    queued behind a spin kernel of ``hold_cycles`` clocks
    (``torch.cuda._sleep``, about 25 ms), so the host's time to issue them,
    which passes a short kernel's own, stays out of the events' span."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_ms(fn, reps: int):
    """Mean milliseconds per call that ``fn``'s kernels and copies spend on
    the card: ``torch.profiler``'s device time, their own durations summed,
    with no host time or gap between them. For a call that waits on the
    host inside (``torch.bincount`` reads its input's range back), where
    :func:`device_ms` would time the round trip. None where the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / reps / 1e3 if total_us > 0 else None


def k1_bounds(fparams, n: int, seed=(1, 2)) -> tuple:
    """K1's bound on ``n`` rays of a point or generic source (Philox
    ``seed``), and its flat bound: the same bytes (packed chain, images,
    counts), the operations of the rays alive into each optic (what this
    run's data needs, ``k1_live_ops``'s ``live_rays`` from the twin's
    masks) or of every ray through every optic (``k1_ops``, the flat
    census, kept beside it so that a row compares with its older records)."""
    # Imported here: chip_ab.py loads this module's timers against older
    # trees' packages, which lack these two.
    from xicsrt_tpu_torch.tools.roofline import k1_live_ops, live_lanes

    n_bytes = (packed_bytes(fparams.fp, fparams.ip, fparams.aux) + fparams.img_total * 4
               + 8 * (1 + fparams.n_optics))
    ops = k1_live_ops(fparams, live_lanes(fparams, n, seed=seed), n)
    return bound(n_bytes, ops["live_rays"]), bound(n_bytes, ops["flat"])


def tie_positions(n_pix: int, ps: float) -> np.ndarray:
    """Float32 positions x whose pixel coordinate fma(x, 1/ps, (n-1)/2),
    rounded once to float32, is exactly k + 0.5: the float32 neighbours of
    each pixel boundary, kept where they tie."""
    inv = np.float64(np.float32(1.0) / np.float32(ps))
    half = (n_pix - 1) / 2.0
    base = ((np.arange(-1, n_pix + 1) + 0.5 - half) * ps).astype(np.float32)
    cand = np.concatenate([(base.view(np.int32) + d).view(np.float32)
                           for d in range(-64, 65)])
    f = (cand.astype(np.float64) * inv + half).astype(np.float32)
    return np.unique(cand[f == np.floor(f) + np.float32(0.5)])


def hits(n: int, nx: int, ny: int, ps: float, gen: torch.Generator):
    """Random local hits over the image and a margin, with exact half-pixel
    ties: rays whose pixel coordinate fma(x, 1/ps, (nx-1)/2) is k + 0.5."""
    dev = "cuda"
    xl = torch.empty((n, 3), device=dev)
    xl[:, 0] = (torch.rand(n, generator=gen, device=dev) - 0.5) * (nx + 4) * ps
    xl[:, 1] = (torch.rand(n, generator=gen, device=dev) - 0.5) * (ny + 4) * ps
    xl[:, 2] = 0.0
    ties = torch.from_numpy(tie_positions(nx, ps)).to(dev)
    n_tie = min(ties.numel() * 64, n // 8)
    xl[:n_tie, 0] = ties.repeat(64)[:n_tie]
    mask = torch.rand(n, generator=gen, device=dev) < 0.9
    return xl, mask, int(ties.numel())


def phase_k2(plain_bin):
    """Phase 3: K2 (``bin_images_cuda``) against its twin, each flagship
    image alone (unit and random weights on 90 % dense hits with exact
    ties), then both images in one launch on the dense hits and on the main
    path's own eager items, unit weights by the unit flag and as floats,
    and random weights. Returns the largest weighted difference."""
    from xicsrt_tpu_torch.ops.pallas_binning import bin_images_cuda, bin_images_plain

    def native_bin(*item):
        return bin_images_cuda([item])[0]

    gen = torch.Generator(device="cuda").manual_seed(1)
    n = 1 << 22
    worst = 0.0
    dense = []
    for nx, ny, ps in FLAGSHIP_IMAGES:
        xl, mask, n_ties = hits(n, nx, ny, ps, gen)
        ones = torch.ones(n, device="cuda")
        a = native_bin(xl, mask, ones, nx, ny, ps)
        b = plain_bin(xl, mask, ones, nx, ny, ps)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"K2 unit weights differ on ({nx},{ny}): "
                                 f"{(a - b).abs().max().item()}")
        w = torch.rand(n, generator=gen, device="cuda")
        a = native_bin(xl, mask, w, nx, ny, ps)
        b = plain_bin(xl, mask, w, nx, ny, ps)
        err = (a - b).abs().max().item()
        # Tolerance: atomics add in another order than index_put_.
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-4):
            raise AssertionError(f"K2 weighted images differ on ({nx},{ny}): {err}")
        worst = max(worst, err)
        log(f"phase 3 K2 ({nx},{ny}) ps={ps}: unit weights equal "
            f"(sum {a.sum().item():.1f} incl. {n_ties} tie positions), "
            f"weighted max |diff| {err:.3g} (rtol 1e-5)")
        dense.append((xl, mask, w, nx, ny, ps))
    for label, items in (("dense", dense), ("main path", eager_image_items(n))):
        ones = [(xl, m, torch.ones_like(w), nx, ny, ps) for xl, m, w, nx, ny, ps in items]
        for unit in (True, False):
            got = bin_images_cuda(ones, unit_weights=unit)
            for a, item in zip(got, ones):
                if not torch.equal(a, plain_bin(*item)):
                    raise AssertionError(f"K2 packed ({label}, unit flag {unit}) differs "
                                         f"from its twin")
        w_items = [(xl, m, torch.rand(m.shape[0], generator=gen, device="cuda"), nx, ny, ps)
                   for xl, m, _, nx, ny, ps in items]
        for a, b in zip(bin_images_cuda(w_items), bin_images_plain(w_items)):
            err = (a - b).abs().max().item()
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-4):
                raise AssertionError(f"K2 packed weighted images differ ({label}): {err}")
            worst = max(worst, err)
        log(f"phase 3 K2 one launch for both images ({label}, "
            f"{sum(int(m.sum()) for _, m, *_ in items)} rays set): unit weights equal "
            f"with and without the unit flag, weighted within rtol 1e-5")
    return worst


def flagship(intensity, num_iter, **general):
    return BS._spectrometer_config(intensity=intensity, num_iter=num_iter, **general)


def eager_image_items(n, seed=6, device="cuda") -> list:
    """The items (x_local, mask, weight, nx, ny, pixel_size) that one
    iteration of the eager flagship (phase 6's chain, ``n`` rays) hands to
    ``bin_images_fused``: the crystal's and the detector's, about 1.3 % of
    their rays set."""
    from xicsrt_tpu_torch import engine
    from xicsrt_tpu_torch.draws import Draws

    pipe = engine.Pipeline(flagship(n, 1, engine="xla", binning="pallas"), device=device)
    seen, real = [], engine.bin_images_fused

    def keep(items, *args, **kwargs):
        seen.extend(items)
        return real(items, *args, **kwargs)

    engine.bin_images_fused = keep
    try:
        gen = torch.Generator(device=device).manual_seed(seed)
        pipe.make_iteration(keep_history=False)(pipe.params, Draws(gen))
    finally:
        engine.bin_images_fused = real
    return seen


def bincount_inputs(items) -> list:
    """(flat indices, weights, pixels) of each item's set rays on its grid,
    computed before the yardstick ``torch.bincount`` is timed."""
    out = []
    for x_local, mask, weight, nx, ny, ps in items:
        fx = torch.round(x_local[:, 0] / ps + (nx - 1) / 2.0).long()
        fy = torch.round(x_local[:, 1] / ps + (ny - 1) / 2.0).long()
        ok = mask & (fx >= 0) & (fx < nx) & (fy >= 0) & (fy < ny)
        out.append((fx[ok] * ny + fy[ok], weight[ok], nx * ny))
    return out


def k2_bound(items):
    """K2's bound on ``items``: each mask byte read, each set ray's x, y and
    weight (12 bytes), each image written; 10 operations a set ray."""
    n_set = sum(int(mask.sum()) for _, mask, *_ in items)
    return bound(sum(mask.numel() for _, mask, *_ in items) + 12 * n_set
                 + 4 * sum(nx * ny for *_, nx, ny, _ in items), 10 * n_set)


def phase_k1a(ft, engine):
    n = 1 << 20
    pipe = engine.Pipeline(flagship(n, 1, engine="fused"), device="cuda")
    src = ft._source_spec(pipe.source)
    optics = [ft._optic_spec(o) for o in pipe.optics]
    fparams = ft.pack_params(src, optics, pipe.params, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    uniforms = torch.rand((fparams.n_draws, n), generator=gen, device="cuda")
    worst = 0.0
    for label, kwargs in (("input", {"uniforms": uniforms}),
                          ("hw", {"seed": (12345, 678)})):
        ck, ik = ft.fused_run_cuda(fparams, n, n, **kwargs)
        cp, iq = ft.fused_run_plain(fparams, n, n, **kwargs)
        torch.cuda.synchronize()
        dc = (ck - cp).abs()
        di = (ik - iq).abs()
        log(f"phase 4 K1a rng={label}: kernel counts {ck.tolist()}, twin "
            f"{cp.tolist()}; differing rays per element {dc.tolist()}, image "
            f"L1 diff {di.sum().item():.0f} (held to 0: the FMA-free build "
            f"rounds as the twin)")
        if dc.max().item() > 0 or di.sum().item() > 0:
            raise AssertionError(f"K1a differs from its twin (rng={label})")
        worst = max(worst, float(dc.max().item()), float(di.max().item()))
    return worst, fparams


def check_main_path(result, budget, label):
    meta = {k: v["num_out"] for k, v in result["total"]["meta"].items()}
    images = result["total"]["image"]
    if meta["source"] != budget:
        raise AssertionError(f"{label}: source {meta['source']} != {budget}")
    for name, img in images.items():
        if not (img.shape and math.isfinite(float(img.sum()))):
            raise AssertionError(f"{label}: bad image {name}")
        if int(img.sum()) != meta[name]:
            raise AssertionError(f"{label}: image {name} sums to {img.sum()} "
                                 f"but {meta[name]} rays reached it")
    if meta["detector"] <= 0:
        raise AssertionError(f"{label}: no detector hits")
    eff = meta["detector"] / meta["source"]
    sigma = math.sqrt(REFERENCE_EFFICIENCY * (1 - REFERENCE_EFFICIENCY) / meta["source"])
    if abs(eff - REFERENCE_EFFICIENCY) > max(6 * sigma, 0.005 * REFERENCE_EFFICIENCY):
        raise AssertionError(f"{label}: efficiency {eff} vs {REFERENCE_EFFICIENCY}")
    log(f"{label}: meta {meta}, efficiency {eff:.6f}")
    return meta


def grad_flagship(intensity, num_iter, **general):
    """The flagship in the gradient path's modes (weight, bilinear)."""
    return flagship(intensity, num_iter, interact_mode="weight",
                    image_mode="bilinear", **general)


def phase_k5f(fg, engine):
    """K5f against its twin at 2^20 flagship rays, both RNG modes."""
    n = 1 << 20
    pipe = engine.Pipeline(grad_flagship(n, 1), device="cuda")
    _, _, pack, spec = fg.build_fused_diff(pipe)
    static, lam = spec["static"], spec["lam"]
    pvec = pack(pipe.params).detach()
    gen = torch.Generator(device="cuda").manual_seed(4)
    uniforms = torch.rand((static.n_draws, n), generator=gen, device="cuda")
    worst = 0.0
    for label, kwargs in (("input", {"uniforms": uniforms}),
                          ("hw", {"seed": (2024, 7)})):
        k = fg.fused_grad_forward_cuda(static, pvec, n, lam, **kwargs)
        t = fg.fused_grad_forward_plain(static, pvec, n, lam, chunk=n, **kwargs)
        torch.cuda.synchronize()
        off = 0
        for name, nx, ny in spec["images"]:
            a, b = k[off:off + nx * ny], t[off:off + nx * ny]
            off += nx * ny
            rel_total = abs(a.sum().item() - b.sum().item()) / b.sum().item()
            pix = (a - b).abs().max().item() / b.abs().max().item()
            log(f"phase 8 K5f rng={label} {name}: total {a.sum().item():.6g} vs "
                f"twin {b.sum().item():.6g} (rel {rel_total:.3g}, tolerance 1e-4), "
                f"max pixel diff {pix:.3g} of the image maximum (tolerance 1e-3)")
            # Tolerance: atomics add in another order than index_put, and
            # expf/sinf round apart from PyTorch's.
            if not (rel_total < 1e-4 and pix < 1e-3):
                raise AssertionError(f"K5f differs from its twin (rng={label}, {name})")
            worst = max(worst, (a - b).abs().max().item())
    return worst, pipe, spec, pvec, uniforms


def phase_k5b(fg, spec, pvec, uniforms):
    """K5b against its float32 twin (the same arithmetic: every slot held
    tight) and against the float64 twin (the accuracy statement) on the
    same uniforms and a random g; vjp(2g) = 2 vjp(g). Returns the largest
    |kernel - float32 twin|."""
    n = uniforms.shape[1]
    static, lam = spec["static"], spec["lam"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = torch.randn(static.img_total, generator=gen, device="cuda")
    kernel = fg.fused_grad_vjp_cuda(static, pvec, n, lam, g, uniforms=uniforms)
    twin = fg.fused_grad_vjp_plain(static, pvec, n, lam, g, uniforms=uniforms,
                                   chunk=1 << 18)
    truth = fg.fused_grad_vjp_plain(static, pvec.double(), n, lam, g.double(),
                                    uniforms=uniforms, chunk=1 << 18)
    doubled = fg.fused_grad_vjp_cuda(static, pvec, n, lam, 2.0 * g, uniforms=uniforms)
    torch.cuda.synchronize()
    k, w = kernel.double().cpu(), twin.double().cpu()
    t, d = truth.cpu(), doubled.double().cpu()
    # The float32 twin: the same float32 operations per ray, slots summed in
    # another order (tests/test_torch_cuda.py's bound).
    scale32 = w.abs().max().item()
    err32 = (k - w).abs()
    used32 = (err32 / (1e-3 * w.abs() + 1e-5 * scale32)).max().item()
    atol32 = 1e-5 * scale32
    # The float64 twin: per-ray terms cancel in some slots
    # (test_fused_grad.py:250-259).
    scale = t.abs().max().item()
    err = (k - t).abs()
    used = (err / (2e-2 * t.abs() + 5e-3 * scale)).max().item()
    lin = (d - 2.0 * k).abs().max().item() / max(2.0 * k.abs().max().item(), 1e-30)
    nonzero = w != 0
    log(f"phase 9 K5b: max |kernel - f32 twin| {err32.max().item():.4g} of scale "
        f"{scale32:.4g}, the worst slot uses {used32:.3g} of the tolerance (rtol "
        f"1e-3, atol 1e-5 scale = {atol32:.4g}; {int((w.abs() > atol32).sum())} of "
        f"{int(nonzero.sum())} non-zero slots exceed that atol, the smallest non-zero "
        f"|slot| is {w.abs()[nonzero].min().item():.4g}); max |kernel - f64 twin| "
        f"{err.max().item():.4g} of scale {scale:.4g}, the worst slot uses {used:.3g} "
        f"of the tolerance (rtol 2e-2, atol 5e-3 scale); |vjp(2g) - 2 vjp(g)| / max "
        f"{lin:.3g} (tolerance 1e-5); slots {int((t != 0).sum())} non-zero of "
        f"{t.numel()}")
    if used32 > 1.0:
        raise AssertionError(f"K5b differs from the f32 twin: {(k - w).tolist()}")
    if used > 1.0:
        raise AssertionError(f"K5b differs from the f64 twin: {(k - t).tolist()}")
    if lin > 1e-5:
        raise AssertionError(f"K5b is not linear in g: {lin}")
    return err32.max().item()


def fold_chain_config(n, num_iter=1):
    """Three optics for K5b's slot sums: ``tests/test_fused_grad.py``'s
    spherical crystal and detector behind a planar mirror at z = 0.4 whose
    normal (0, 1, -1) / sqrt(2) folds the source's +z beam onto +y; the
    crystal and detector are the variant's mirrored through that plane.
    Weight mode, bilinear images, ``n`` rays an iteration."""
    cfg = variant_config("uniform_wavelength")
    cfg["general"].update(interact_mode="weight", image_mode="bilinear",
                          number_of_iter=num_iter)
    src = cfg["sources"]["source"]
    src.update(intensity=n, wavelength_dist="monochrome")
    src.pop("wavelength_range")
    crystal = cfg["optics"]["crystal"]
    crystal.update(origin=[0.0, 0.40374151, 0.3997], zaxis=[0.0, -0.80374151, 0.59497864],
                   pixel_size=0.01)
    detector = cfg["optics"]["detector"]
    detector.update(origin=[0.0, 0.16904832, 1.1687129], zaxis=[0.0, 0.29200084, -0.95641806],
                    xsize=0.4, ysize=0.4)
    mirror = {"class_name": "XicsrtOpticPlanarMirror", "origin": [0.0, 0.0, 0.4],
              "zaxis": [0.0, 0.70710678, -0.70710678], "xsize": 0.3, "ysize": 0.3,
              "pixel_size": 0.01}
    cfg["optics"] = {"mirror": mirror, "crystal": crystal, "detector": detector}
    return cfg


def sign_descent(forward, vjp, pvec0, slot, seed, steps=14):
    """Example 07's loop: perturb one slot by 2e-4 (relative), then step
    against the sign of the gradient with a shrinking step. Returns the
    errors before and after each step."""
    target = forward(pvec0, seed)["image"]
    d_true = float(pvec0[slot])
    pvec = pvec0.clone()
    pvec[slot] = d_true * (1.0 + 2e-4)
    errs = [abs(float(pvec[slot]) - d_true)]
    step = 2.5e-4
    for _ in range(steps):
        out = forward(pvec, seed)["image"]
        g = {k: out[k] - target[k] for k in out}
        gv = vjp(pvec, seed, g)
        pvec[slot] -= step * float(torch.sign(gv[slot]))
        step *= 0.6
        errs.append(abs(float(pvec[slot]) - d_true))
    return errs


def example04_config():
    """Example 04's alignment task (examples/example_04_differentiable_alignment.py)."""
    return {
        "general": {"number_of_iter": 1, "random_seed": 0,
                    "print_results": False, "dtype": "float64"},
        "sources": {"source": {
            "class_name": "XicsrtSourceDirected", "intensity": 50000,
            "wavelength": 3.9492, "spread": math.radians(10.0)}},
        "optics": {
            "crystal": {
                "class_name": "XicsrtOpticSphericalCrystal",
                "origin": [0.0, 0.0, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151],
                "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
                "crystal_spacing": 2.45676, "rocking_type": "gaussian",
                "rocking_fwhm": 2e-4},
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4, "ysize": 0.2, "pixel_size": 0.01},
        },
    }


def statistics_config(dtype):
    """``tests/test_fused_grad.py``'s chain (aperture, spherical crystal of
    1e-3 rad rocking width, detector; 0.01 m pixels) at 2^15 rays."""
    cfg = flagship(1 << 15, 1, dtype=dtype)
    cfg["optics"]["crystal"].update(origin=[0.0, -3e-4, 0.80374151],
                                    rocking_fwhm=1e-3, pixel_size=0.01)
    cfg["optics"]["detector"]["pixel_size"] = 0.01
    return cfg


def spacing_gradients(fg, make_differentiable, engine):
    """d(sum detector)/d(crystal_spacing) over 4 seeds from K5b and from
    eager autograd at float64 (``test_fused_grad.py:270-310``)."""
    cfg = statistics_config("float32")
    cfg["general"].update(interact_mode="weight", image_mode="bilinear")
    pipe = engine.Pipeline(cfg, device="cuda")
    _, vjp, pack, spec = fg.build_fused_diff(pipe)
    pvec = pack(pipe.params).detach()
    g = {k: torch.full((nx, ny), 1.0 if k == "detector" else 0.0, device="cuda")
         for k, nx, ny in spec["images"]}
    slot = fg.SLOTS_PER_OPTIC * 1 + 13
    g_fused = np.array([float(vjp(pvec, k, g)[slot]) for k in range(4)])

    image_fn, pipe64 = make_differentiable(statistics_config("float64"), device="cuda")
    d0 = pipe64.params["optics"]["crystal"]["crystal_spacing"]
    g_eager = []
    for k in range(4):
        d = d0.detach().clone().requires_grad_(True)
        params = dict(pipe64.params)
        params["optics"] = dict(params["optics"])
        params["optics"]["crystal"] = dict(params["optics"]["crystal"],
                                           crystal_spacing=d)
        gen = torch.Generator(device="cuda").manual_seed(100 + k)
        image_fn(params, gen)["detector"].sum().backward()
        g_eager.append(float(d.grad))
    return g_fused, np.array(g_eager)


def eager_step(image_fn, pipe):
    """One eager autograd step: forward and backward of the summed
    images with respect to the crystal's scalar parameters."""
    crystal = {k: (v.detach().clone().requires_grad_(True)
                   if isinstance(v, torch.Tensor) else v)
               for k, v in pipe.params["optics"]["crystal"].items()}
    params = dict(pipe.params)
    params["optics"] = dict(params["optics"], crystal=crystal)
    images = image_fn(params, torch.Generator(device="cuda").manual_seed(1))
    sum(v.sum() for v in images.values()).backward()


def gradient_phases(smi, fg, engine) -> dict:
    """Phases 8-12; returns the K5f/K5b launch counts, errors and times."""
    # Phase 8-9: the gradient kernels against their twins.
    k5f_err, grad_pipe, grad_spec, grad_pvec, grad_u = phase_k5f(fg, engine)
    k5b_err = phase_k5b(fg, grad_spec, grad_pvec, grad_u)

    # Phase 10: the gradient path at full width, counters read around it.
    from xicsrt_tpu_torch.gradients import (
        align, make_differentiable, make_fused_differentiable)

    fg.fused_grad_forward_cuda.launches = 0
    fg.fused_grad_vjp_cuda.launches = 0
    forward, vjp, pack, pipe = make_fused_differentiable(
        grad_flagship(2**22, 4), device="cuda")
    pvec0 = pack(pipe.params).detach()
    out = forward(pvec0, 11)["image"]
    g_ones = {k: torch.ones_like(v) for k, v in out.items()}
    gvec = vjp(pvec0, 11, g_ones)
    torch.cuda.synchronize()
    for name, img in out.items():
        if not (torch.isfinite(img).all() and img.sum() > 0):
            raise AssertionError(f"phase 10: bad gradient-path image {name}")
    if not torch.isfinite(gvec).all() or gvec.abs().max() <= 0:
        raise AssertionError("phase 10: bad gradient vector")
    slot = fg.SLOTS_PER_OPTIC * 1 + 13  # the crystal's d-spacing
    errs = sign_descent(forward, vjp, pvec0, slot, seed=12)
    k5f_launches = fg.fused_grad_forward_cuda.launches
    k5b_launches = fg.fused_grad_vjp_cuda.launches
    if k5f_launches <= 0 or k5b_launches <= 0:
        raise AssertionError("the gradient path did not launch K5f and K5b")
    log(f"phase 10 gradient path at 2^24 rays: images "
        f"{ {k: round(float(v.sum()), 3) for k, v in out.items()} }, "
        f"d(sum images)/d(spacing) {float(gvec[slot]):.6g}; sign descent "
        f"d-spacing error {errs[0]:.3g} -> {errs[-1]:.3g} "
        f"(criterion < {0.2 * errs[0]:.3g}); launches K5f {k5f_launches}, "
        f"K5b {k5b_launches}")
    if not errs[-1] < 0.2 * errs[0]:
        raise AssertionError(f"sign descent did not recover the spacing: {errs}")

    # Phase 11: eager autograd on CUDA (example 04), and its gradient
    # against K5b's on the same chain.
    ex04 = example04_config()
    image_fn, pipe04 = make_differentiable(ex04, device="cuda")
    target = image_fn(pipe04.params, torch.Generator(device="cuda").manual_seed(7))
    target = target["detector"].detach()
    perturbed = copy.deepcopy(ex04)
    perturbed["optics"]["crystal"]["crystal_spacing"] = 2.45676 * (1 + 2e-4)
    t_align = time.perf_counter()
    final, losses = align(perturbed, {"detector": target},
                          [("optics", "crystal", "crystal_spacing")], steps=60,
                          learning_rate=2e-5, seed=7, resample=False, device="cuda")
    t_align = time.perf_counter() - t_align
    recovered = float(final["optics"]["crystal"]["crystal_spacing"])
    log(f"phase 11 align (example 04, 60 steps, {t_align:.2f} s): loss "
        f"{losses[0]:.4g} -> {losses[-1]:.4g}; d-spacing {recovered:.6f} "
        f"(true 2.456760, perturbed {2.45676 * (1 + 2e-4):.6f})")
    if not (losses[-1] < 0.25 * losses[0]
            and abs(recovered - 2.45676) < 0.5 * 2.45676 * 2e-4):
        raise AssertionError("eager align did not recover the spacing")
    g_fused, g_eager = spacing_gradients(fg, make_differentiable, engine)
    mf, sf = g_fused.mean(), g_fused.std(ddof=1) / 2.0
    mx, sx = g_eager.mean(), g_eager.std(ddof=1) / 2.0
    limit = 6 * math.sqrt(sf**2 + sx**2) + 0.02 * abs(mx)
    log(f"phase 11 d(detector)/d(spacing): K5b {mf:.6g} +- {sf:.3g}, eager "
        f"autograd {mx:.6g} +- {sx:.3g} (4 seeds each; |diff| "
        f"{abs(mf - mx):.3g} < {limit:.3g} required, and |K5b| > 5 sigma)")
    if not (abs(mf) > 5 * sf and abs(mf - mx) < limit):
        raise AssertionError("eager and fused spacing gradients disagree")

    # Phase 12: gradient timings.
    n = 1 << 22
    pipe22 = engine.Pipeline(grad_flagship(n, 1), device="cuda")
    _, _, pack22, spec22 = fg.build_fused_diff(pipe22)
    st22, lam = spec22["static"], spec22["lam"]
    pv22 = pack22(pipe22.params).detach()
    g22 = torch.randn(st22.img_total, device="cuda")
    k5f_ms = cuda_ms(lambda: fg.fused_grad_forward_cuda(st22, pv22, n, lam, seed=(1, 2)), 20)
    k5f_plain_ms = cuda_ms(lambda: fg.fused_grad_forward_plain(
        st22, pv22, n, lam, seed=(1, 2), chunk=n), 3)
    k5b_ms = cuda_ms(lambda: fg.fused_grad_vjp_cuda(st22, pv22, n, lam, g22, seed=(1, 2)), 20)
    k5b_plain_ms = cuda_ms(lambda: fg.fused_grad_vjp_plain(
        st22, pv22, n, lam, g22, seed=(1, 2), chunk=n), 3)
    step_ms = cuda_ms(lambda: vjp(pvec0, 3, forward(pvec0, 3)["image"]), 5)
    eager_fn, eager_pipe = make_differentiable(grad_flagship(n, 1), device="cuda")
    eager_step_ms = cuda_ms(lambda: eager_step(eager_fn, eager_pipe), 3)
    k5_bytes = packed_bytes(st22.fp, st22.ip, pv22) + st22.img_total * 4
    k5f_bound = bound(k5_bytes, k5_ops(st22, False) * n)
    k5b_bound = bound(k5_bytes + pv22.numel() * 4, k5_ops(st22, True) * n)
    log(f"phase 12 timings on {smi}: K5f {k5f_ms:.4f} ms vs twin {k5f_plain_ms:.4f} ms; "
        f"K5b {k5b_ms:.4f} ms vs twin {k5b_plain_ms:.4f} ms (2^22 flagship rays, "
        f"Philox); fused forward+vjp step {2**24 / step_ms * 1e3:.4g} rays/s "
        f"({step_ms:.2f} ms for 2^24 rays); eager autograd step "
        f"{eager_step_ms:.2f} ms for 2^22 rays ({n / eager_step_ms * 1e3:.4g} rays/s, "
        f"remat); example 04 align {t_align / 60 * 1e3:.2f} ms per step")
    return {"k5f_launches": k5f_launches, "k5b_launches": k5b_launches,
            "k5f_err": k5f_err, "k5b_err": k5b_err, "k5f_ms": k5f_ms,
            "k5f_plain_ms": k5f_plain_ms, "k5b_ms": k5b_ms,
            "k5b_plain_ms": k5b_plain_ms, "k5f_bound": k5f_bound,
            "k5b_bound": k5b_bound}


# ---------------------------------------------------------------------------
# Phases 13-17: the plasma spectrometer (example 03), K4 and K1-plasma.
# ---------------------------------------------------------------------------

def example_config(filename: str):
    """``config`` of examples/<filename>, read from the file as written
    (the example itself runs the JAX package)."""
    import ast
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        filename)
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "config"
                                                for t in node.targets):
            return eval(compile(ast.Expression(node.value), path, "eval"), {"np": np})
    raise AssertionError(f"no config in {path}")


def repo_function(relpath: str, name: str, *helpers: str):
    """Function ``name`` of another file of the repository (with the
    functions it calls, ``helpers``), read with ``ast`` so that nothing that
    file imports (JAX) is imported."""
    import ast
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath)
    defs = [node for node in ast.parse(open(path).read()).body
            if isinstance(node, ast.FunctionDef) and node.name in (name, *helpers)]
    namespace = {"np": np}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), namespace)
    return namespace[name]


def plasma_config(intensity, num_iter, bundle_count=1000, **general):
    """``plasma_torus`` (``plasma_100k`` with 1e5 bundles) of the scenario
    configs: the expected photon count per iteration is ``intensity``."""
    cfg = BS._plasma_config(intensity, num_iter, bundle_count=bundle_count)
    cfg["general"].update(general)
    return cfg


def expected_photons(cfg) -> float:
    """The real-units expectation of a cubic plasma with a fixed spread:
    iterations x emissivity x time x volume x sin^2(spread / 2)."""
    p = cfg["sources"]["plasma"]
    return (cfg["general"]["number_of_iter"] * p["emissivity"] * p["time_resolution"]
            * p["xsize"] * p["ysize"] * p["zsize"] * math.sin(p["spread"] / 2.0) ** 2)


def gather_inputs(B, n_rays, gen):
    """cum with every 10th bundle empty and cum[-1] = n_rays, a random
    (B, 8) table."""
    cut = torch.sort(torch.randint(0, n_rays, (B - 1,), generator=gen,
                                   device="cuda")).values
    cum = torch.cat([cut, torch.tensor([n_rays], device="cuda")])
    idx = torch.arange(10, B, 10, device="cuda")
    cum[idx] = cum[idx - 1]
    table = torch.randn((B, 8), generator=gen, device="cuda")
    return cum.to(torch.int32).contiguous(), table


def repeat_rows(table, counts, total: int, n: int):
    """K4's function by the library: the bundle table's rows repeated by
    their photon counts (``torch.repeat_interleave``, ``total`` rows), zero
    rows after them up to ``n``."""
    return torch.nn.functional.pad(
        torch.repeat_interleave(table, counts, dim=0, output_size=total),
        (0, 0, 0, n - total))


def k4_library(bg, cum, table, n, label) -> float:
    """The yardstick of K4 at its inputs: ``repeat_rows`` on the counts
    (``cum``'s differences, taken before the timing), its rows equal to
    K4's; its time and the bare ``repeat_interleave``'s beside K4's, in
    turns (library, K4, K4, library). Returns the library's ms."""
    counts = torch.diff(cum.long(), prepend=cum.new_zeros(1).long())
    total = int(cum[-1])
    lib = repeat_rows(table, counts, total, n)
    if not torch.equal(lib, bg.interval_gather_cuda(cum, table, n)):
        raise AssertionError(f"{label}: repeat_interleave's rows differ from K4's")
    lib_ms = bare_ms = k4_ms = float("inf")
    for which in ("library", "k4", "k4", "library"):
        if which == "library":
            lib_ms = min(lib_ms, cuda_ms(lambda: repeat_rows(table, counts, total, n), 20))
            bare_ms = min(bare_ms, cuda_ms(lambda: torch.repeat_interleave(
                table, counts, dim=0, output_size=total), 20))
        else:
            k4_ms = min(k4_ms, cuda_ms(lambda: bg.interval_gather_cuda(cum, table, n), 20))
    log(f"{label}: K4 {k4_ms:.4f} ms; torch.repeat_interleave zero-padded to {n} rows "
        f"{lib_ms:.4f} ms (its rows equal K4's; K4 / library {k4_ms / lib_ms:.3f}), "
        f"repeat_interleave alone ({total} rows) {bare_ms:.4f} ms")
    return lib_ms


def phase_k4(bg):
    """K4 against its twin: bit-identical; returns the largest |difference|
    measured (0.0 when they agree). Beside each timing, its library
    yardstick (``k4_library``)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    n = (1 << 24) + 1000
    worst = 0.0
    for B in (4000, 100000):
        cum, table = gather_inputs(B, 1 << 24, gen)
        a = bg.interval_gather_cuda(cum, table, n)
        b = bg.interval_gather_plain(cum, table, n)
        torch.cuda.synchronize()
        empty = int((cum[1:] == cum[:-1]).sum())
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        if not torch.equal(a, b):
            raise AssertionError(f"K4 differs from its twin at B={B}: {err}")
        if a[1 << 24:].abs().max().item() != 0.0:
            raise AssertionError("K4: rays past cum[-1] are not zero rows")
        ms = cuda_ms(lambda: bg.interval_gather_cuda(cum, table, n), 20)
        plain_ms = cuda_ms(lambda: bg.interval_gather_plain(cum, table, n), 5)
        log(f"phase 13 K4 B={B}: equal to its twin on {n} rays ({empty} empty "
            f"bundles, 1000 tail rays zero); {ms:.4f} ms vs twin {plain_ms:.4f} ms "
            f"({n * 32 / ms / 1e6:.1f} GB/s of output)")
        k4_library(bg, cum, table, n, f"phase 13 K4 B={B}, {n} rays")
    return worst


def plasma_k1_setup(ft, engine, intensity, num_iter, bundle_count=1000, seed=14):
    """Specs, packed buffers and per-iteration bundle tables of
    ``plasma_torus`` on the card."""
    pipe = engine.Pipeline(plasma_config(intensity, num_iter, bundle_count,
                                         engine="fused"), device="cuda")
    src = ft._source_spec(pipe.source)
    optics = [ft._optic_spec(o) for o in pipe.optics]
    fparams = ft.pack_params(src, optics, pipe.params, "cuda")
    from xicsrt_tpu_torch.draws import Draws

    bundles = ft.plasma_bundles(pipe.source, pipe.params["sources"]["plasma"],
                                pipe.params["filters"],
                                Draws(torch.Generator(device="cuda").manual_seed(seed)),
                                num_iter)
    return pipe, fparams, bundles, pipe.num_rays * num_iter


def phase_k1_plasma(ft, engine):
    """K1 (plasma source, toroidal crystal) against its twin, both RNG modes:
    0 rays apart at 1000 bundles, and at 1e5 bundles with runs of
    zero-photon bundles and 32 m + 17 slots an iteration
    (``ragged_bundles``)."""
    pipe, fparams, bundles, n = plasma_k1_setup(ft, engine, 1 << 20, 2)
    _, fparams_w, bundles_w, _ = plasma_k1_setup(ft, engine, 1 << 20, 2, 100000, seed=16)
    bundles_w, n_w = ragged_bundles(bundles_w, 14)
    gen = torch.Generator(device="cuda").manual_seed(15)
    worst = 0.0
    for case, fp_, bundles_, m in (("1000 bundles", fparams, bundles, n),
                                   ("1e5 ragged bundles", fparams_w, bundles_w, n_w)):
        uniforms = torch.rand((fp_.n_draws, m), generator=gen, device="cuda")
        for label, kwargs in (("input", {"uniforms": uniforms}),
                              ("hw", {"seed": (4321, 99)})):
            ck, ik = ft.fused_run_cuda(fp_, m, m, bundles=bundles_, **kwargs)
            cp, iq = ft.fused_run_plain(fp_, m, m, bundles=bundles_, **kwargs)
            torch.cuda.synchronize()
            log(f"phase 14 K1 plasma+torus, {case}, rng={label}: {m} ray slots, kernel "
                f"counts {ck.tolist()}, twin {cp.tolist()}; image L1 diff "
                f"{(ik - iq).abs().sum().item():.0f} (tolerance 0: same float32 "
                f"operations, FMA-free build)")
            if not (torch.equal(ck, cp) and torch.equal(ik, iq)):
                raise AssertionError(f"K1 plasma+torus differs from its twin ({case}, "
                                     f"rng={label})")
            if ck[-1].item() <= 0:
                raise AssertionError("phase 14: no detector hits")
            worst = max(worst, (ik - iq).abs().max().item())
    return worst


def phase_poisson_counts():
    """Bundle counts on the card: over 2^22 draws of one rate, the mean of
    ``Draws.poisson_counts`` within 5 standard errors of the rate, its
    variance within 5 sqrt(2/R), relative, and its third central moment
    within 5 standard errors, sqrt((6 rate^3 + 18 rate^2 + rate) / R), of
    the rate; ``torch.poisson``'s own mean and third moment are printed
    beside them (cuRAND is biased in [64, 4000] and has no skew above)."""
    from xicsrt_tpu_torch.draws import Draws

    R = 1 << 22
    gen = torch.Generator(device="cuda").manual_seed(16)

    def third(x):
        return ((x - x.mean()) ** 3).mean().item()

    for rate in (152.0, 1000.0, 4000.0, 16777.0):
        lam = torch.full((R,), rate, device="cuda")
        ours = Draws(gen).poisson_counts(lam).double()
        raw = torch.poisson(lam, generator=gen).double()
        se = math.sqrt(rate / R)
        se3 = math.sqrt((6 * rate**3 + 18 * rate**2 + rate) / R)
        dev = (ours.mean().item() - rate) / se
        dev_raw = (raw.mean().item() - rate) / se
        var = ours.var().item() / rate - 1.0
        dev3, dev3_raw = (third(ours) - rate) / se3, (third(raw) - rate) / se3
        log(f"phase 15 Poisson counts at rate {rate:g}: mean {ours.mean().item():.4f} "
            f"({dev:+.2f} standard errors), variance / rate - 1 {var:+.2e} (bound "
            f"{5 * math.sqrt(2 / R):.2e}), third moment {dev3:+.2f} standard errors; "
            f"torch.poisson mean {raw.mean().item():.4f} ({dev_raw:+.2f} standard "
            f"errors), third moment {dev3_raw:+.2f} standard errors")
        if abs(dev) > 5 or abs(var) > 5 * math.sqrt(2 / R) or abs(dev3) > 5:
            raise AssertionError(f"Poisson counts at rate {rate} are off")


def check_plasma_result(result, cfg, label):
    meta = {k: v["num_out"] for k, v in result["total"]["meta"].items()}
    expected = expected_photons(cfg)
    n = meta["plasma"]
    if abs(n - expected) > 5 * math.sqrt(expected):
        raise AssertionError(f"{label}: {n} photons, expected {expected:.6g}")
    for name, img in result["total"]["image"].items():
        if not (np.isfinite(img).all() and int(img.sum()) == meta[name]):
            raise AssertionError(f"{label}: image {name} does not sum to its count")
    if meta["detector"] <= 0:
        raise AssertionError(f"{label}: no detector hits")
    log(f"{label}: meta {meta}; {n} photons vs expectation {expected:.6g} "
        f"({(n - expected) / math.sqrt(expected):+.2f} sigma)")
    return meta


def binomial_sigmas(m1, m2):
    """|p1 - p2| in pooled binomial sigmas of detector / plasma."""
    p1 = m1["detector"] / m1["plasma"]
    p2 = m2["detector"] / m2["plasma"]
    pooled = (m1["detector"] + m2["detector"]) / (m1["plasma"] + m2["plasma"])
    sigma = math.sqrt(pooled * (1 - pooled) * (1 / m1["plasma"] + 1 / m2["plasma"]))
    return p1, p2, abs(p1 - p2) / sigma


def torus_golden_check(result, golden, label):
    """``tests/test_reference_parity_families.py``'s four checks."""
    meta = {k: v["num_out"] for k, v in result["total"]["meta"].items()}
    n_gen, n_ref = meta["source"], float(golden["n_generated"])
    for elem in ("crystal", "detector"):
        k, k_ref = meta[elem], float(golden[f"meta_{elem}"])
        p = (k + k_ref) / (n_gen + n_ref)
        sigma = math.sqrt(p / n_gen + p / n_ref)
        if abs(k / n_gen - k_ref / n_ref) >= 5 * sigma:
            raise AssertionError(f"{label}: {elem} {k / n_gen} vs ref {k_ref / n_ref}")
    ref = golden["image"].astype(np.float64)
    img = result["total"]["image"]["detector"].astype(np.float64)
    R = ref.reshape(10, 10, 5, 10).sum(axis=(1, 3))
    O = img.reshape(10, 10, 5, 10).sum(axis=(1, 3))
    scale = R.sum() / O.sum()
    O = O * scale
    keep = (R + O) > 50
    chi2 = ((O[keep] - R[keep]) ** 2 / (R[keep] + scale * O[keep])).sum() / keep.sum()
    ys = np.arange(ref.shape[1])

    def moments(prof):
        prof = prof / prof.sum()
        mu = (prof * ys).sum()
        return mu, math.sqrt((prof * (ys - mu) ** 2).sum())

    (mu_r, sd_r), (mu_o, sd_o) = moments(ref.sum(axis=0)), moments(img.sum(axis=0))
    width_ok = sd_o < 1.0 if sd_r < 1.0 else abs(sd_o - sd_r) < 0.05 * sd_r
    log(f"{label}: meta {meta}; chi2/ndof {chi2:.3f} over {int(keep.sum())} superpixels "
        f"(< 3), centroid {mu_o:.3f} vs {mu_r:.3f} px (< 0.75), width {sd_o:.3f} vs "
        f"{sd_r:.3f} px")
    if not (keep.sum() > 0 and chi2 < 3.0 and abs(mu_o - mu_r) < 0.75 and width_ok):
        raise AssertionError(f"{label}: torus golden image disagrees")


def torus_golden_config(engine_kind):
    """``tests/test_reference_parity_families.py::_config`` for the torus."""
    cfg = flagship(100000, 5, engine=engine_kind, random_seed=11)
    del cfg["optics"]["aperture"]
    cfg["sources"]["source"]["angular_dist"] = "isotropic"
    crystal = cfg["optics"]["crystal"]
    del crystal["radius"]
    crystal.update(class_name="XicsrtOpticToroidalCrystal", radius_major=1.0,
                   radius_minor=0.2, rocking_fwhm=1e-3)
    cfg["optics"]["detector"]["pixel_size"] = 0.004
    return cfg


def plasma_phases(smi, ft, bg, engine, raytrace) -> dict:
    """Phases 13-17; returns the K4 and K1-plasma results for the kernels
    line."""
    import os

    k4_err = phase_k4(bg)
    k1p_err = phase_k1_plasma(ft, engine)
    phase_poisson_counts()

    # Phase 15: example 03 as written (eager, full history), counters read
    # around the run; then the same config on the fused engine.
    cfg = example_config("example_03_plasma_spectrometer.py")
    bg.interval_gather_cuda.launches = 0
    ft.fused_run_cuda.launches = 0
    eager = raytrace(copy.deepcopy(cfg), device="cuda")
    k4_launches = bg.interval_gather_cuda.launches
    if k4_launches <= 0:
        raise AssertionError("example 03 on the eager engine did not launch K4")
    m_eager = check_plasma_result(eager, cfg, "phase 15 example 03 eager")
    w = eager["found"]["history"]["plasma"]["wavelength"]
    doppler = 3.9492 * math.sqrt(1000 * 1.602e-19 / (40 * 1.661e-27 * 9e16))
    log(f"phase 15 example 03: detected line width (std) {w.std():.3e} A over "
        f"{len(w)} rays (Doppler expectation ~{doppler:.3e} A)")
    fused_cfg = copy.deepcopy(cfg)
    fused_cfg["general"].update(engine="fused", keep_history=False)
    bg.interval_gather_cuda.launches = 0
    ft.fused_run_cuda.launches = 0
    fused = raytrace(fused_cfg, device="cuda")
    k1p_launches = ft.fused_run_cuda.launches
    if k1p_launches <= 0:
        raise AssertionError("example 03 on the fused engine did not launch K1")
    m_fused = check_plasma_result(fused, cfg, "phase 15 example 03 fused")
    p1, p2, nsig = binomial_sigmas(m_eager, m_fused)
    log(f"phase 15 engines agree: efficiency eager {p1:.6g}, fused {p2:.6g}, "
        f"{nsig:.2f} binomial sigma (< 5); K4 launches {k4_launches}, K1 {k1p_launches}")
    if nsig >= 5:
        raise AssertionError("example 03: the engines disagree")

    # Phase 16: full width, with timings.
    rates = {}
    for label, kwargs in (("plasma_torus", {}), ("plasma_100k", {"bundle_count": 100000})):
        pcfg = plasma_config(1 << 24, 4, engine="fused", **kwargs)
        res = raytrace(pcfg, device="cuda")
        meta = check_plasma_result(res, pcfg, f"phase 16 {label} fused")
        ms = cuda_ms(lambda: raytrace(pcfg, device="cuda"), 3)
        rates[label] = meta["plasma"] / ms * 1e3
        log(f"phase 16 {label} fused: {ms:.2f} ms per raytrace, "
            f"{rates[label]:.4g} photons/s")
    ecfg = plasma_config(1 << 22, 4, engine="xla")
    res = raytrace(ecfg, device="cuda")
    check_plasma_result(res, ecfg, "phase 16 plasma_torus eager+K4")
    ms = cuda_ms(lambda: raytrace(ecfg, device="cuda"), 3)
    rates["eager"] = res["total"]["meta"]["plasma"]["num_out"] / ms * 1e3
    log(f"phase 16 plasma_torus eager+K4: {ms:.2f} ms per raytrace, "
        f"{rates['eager']:.4g} photons/s")
    _, fparams, bundles, n = plasma_k1_setup(ft, engine, 1 << 22, 1)
    k1p_ms = cuda_ms(lambda: ft.fused_run_cuda(fparams, n, n, seed=(1, 2),
                                               bundles=bundles), 20)
    k1p_plain_ms = cuda_ms(lambda: ft.fused_run_plain(fparams, n, n, seed=(1, 2),
                                                      bundles=bundles), 3)
    cum, table = bundles[0][0], bundles[1][0]
    k4_ms = cuda_ms(lambda: bg.interval_gather_cuda(cum, table, n), 20)
    k4_plain_ms = cuda_ms(lambda: bg.interval_gather_plain(cum, table, n), 5)
    k1p_bound = bound(packed_bytes(fparams.fp, fparams.ip, bundles[0], bundles[1])
                      + fparams.img_total * 4 + 8 * (1 + fparams.n_optics),
                      k1_ops(fparams) * n)
    k4_bound = bound(packed_bytes(cum, table) + n * 32, 0)
    log(f"phase 16 timings on {smi}: K1 plasma+torus {k1p_ms:.4f} ms vs twin "
        f"{k1p_plain_ms:.4f} ms ({n} ray slots, 1000 bundles, Philox); K4 "
        f"{k4_ms:.4f} ms vs twin {k4_plain_ms:.4f} ms (the same rays and tables)")
    # The same slots on plasma_100k's 1e5 bundles, where the lookup's
    # rounds grow with log2 B.
    _, fparams_w, bundles_w, n_w = plasma_k1_setup(ft, engine, 1 << 22, 1, 100000)
    k1p_ms_w = cuda_ms(lambda: ft.fused_run_cuda(fparams_w, n_w, n_w, seed=(1, 2),
                                                 bundles=bundles_w), 20)
    k1p_bound_w = bound(packed_bytes(fparams_w.fp, fparams_w.ip, bundles_w[0], bundles_w[1])
                        + fparams_w.img_total * 4 + 8 * (1 + fparams_w.n_optics),
                        k1_ops(fparams_w) * n_w)
    log(f"phase 16 timings on {smi}: K1 plasma+torus {k1p_ms_w:.4f} ms ({n_w} ray slots, "
        f"1e5 bundles, Philox); flat bound {k1p_bound_w[0]:.4f} ms ({k1p_bound_w[1]}); "
        f"at 1000 bundles {k1p_ms:.4f} ms, flat bound {k1p_bound[0]:.4f} ms")
    k4_library_ms = k4_library(bg, cum, table, n, f"phase 16 K4, {n} ray slots, 1000 bundles")

    # Phase 17: the torus golden on both engines.
    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                               "golden", "torus_reference_image.npz")
    golden = dict(np.load(golden_path))
    for kind in ("xla", "fused"):
        torus_golden_check(raytrace(torus_golden_config(kind), device="cuda"),
                           golden, f"phase 17 torus golden, engine {kind}")
    return {"k4_launches": k4_launches, "k4_err": k4_err, "k4_ms": k4_ms,
            "k4_plain_ms": k4_plain_ms, "k4_library_ms": k4_library_ms,
            "k1p_launches": k1p_launches, "k1p_err": k1p_err, "k1p_ms": k1p_ms,
            "k1p_plain_ms": k1p_plain_ms, "k1p_bound": k1p_bound, "k1p_slots": n,
            "k1p_ms_1e5": k1p_ms_w, "k1p_bound_1e5": k1p_bound_w, "k1p_slots_1e5": n_w,
            "k4_bound": k4_bound, "example03_meta": m_eager}


# ---------------------------------------------------------------------------
# Phases 18-22: the cylinder in K1, and K5f/K5b with curved optics and a
# plasma (examples 07 and 08).
# ---------------------------------------------------------------------------

GRAD_VARIANTS = ("torus_crystal", "convex_torus_mirror", "cylinder_crystal",
                 "convex_cylinder_mirror", "plasma_cubic")


def variant_config(kind):
    """``tests/test_fused_grad.py::_variant_config``."""
    return repo_function("tests/test_fused_grad.py", "_variant_config")(kind)


def grad_variant(kind, n, num_iter=1):
    """A variant in the gradient path's modes with ``n`` rays per iteration
    (a plasma's emissivity scaled to n expected photons; the variant holds
    1534.6)."""
    cfg = file_rocking_config() if kind == "file_rocking" else variant_config(kind)
    cfg["general"].update(interact_mode="weight", image_mode="bilinear",
                          number_of_iter=num_iter)
    if "plasma" in cfg["sources"]:
        # max_rays bounds the eager engine's Poisson budget, which this
        # path does not trace.
        cfg["sources"]["plasma"].update(
            emissivity=cfg["sources"]["plasma"]["emissivity"] * n / 1534.6,
            max_rays=8 * n)
    else:
        cfg["sources"]["source"]["intensity"] = n
    return cfg


def cylinder_config(intensity, num_iter, engine_kind):
    """``tests/test_fused_grad.py``'s cylindrical crystal in mc mode."""
    cfg = variant_config("cylinder_crystal")
    cfg["general"].update(engine=engine_kind, number_of_iter=num_iter,
                          interact_mode="mc", image_mode="nearest")
    cfg["sources"]["source"]["intensity"] = intensity
    return cfg


CYLINDER_MODES = {"mc": ({}, "fused_trace_cylinder_kernel<0>"),
                  "weight": ({"interact_mode": "weight"}, "fused_trace_cylinder_kernel<1>"),
                  "bilinear": ({"image_mode": "bilinear"}, "fused_trace_cylinder_kernel<1>")}


def cylinder_mode_config(mode, intensity, num_iter=1, engine_kind="fused"):
    """:func:`cylinder_config` in ``mode`` (``CYLINDER_MODES``: mc, weight,
    bilinear)."""
    cfg = cylinder_config(intensity, num_iter, engine_kind)
    cfg["general"].update(CYLINDER_MODES[mode][0])
    return cfg


def phase_k1_cylinder(smi, ft, engine, raytrace, k1a) -> dict:
    """K1's cylinder stage (K1c-cylinder) in its build without the torus
    code: the launcher's pick (``fused_trace_cylinder_kernel``, or the phase
    fails) and the warps its launch keeps resident; the kernel against its
    twin at 2^20 rays in both RNG modes, 0 rays and 0 pixels apart in mc
    mode, the counts equal and each pixel within the bound of float32
    summation order in weight mode and with bilinear images
    (``twin_equal``), and K1e 'found' on the mc chain (``k1e_against_twin``);
    then a cylindrical crystal through raytrace on both engines (counters
    read around the fused run); then the kernel's time beside K1a's
    (``k1a``: the flagship's packed buffers)."""
    from xicsrt_tpu_torch.ops import native

    n = 1 << 20
    worst = 0.0
    for mode, (_, want) in CYLINDER_MODES.items():
        fparams = k1_pack(engine.Pipeline(cylinder_mode_config(mode, n), device="cuda"))
        build = k1_build_name(fparams)
        dyn = ctypes.c_int(0)
        blocks = native.library().xrt_fused_trace_occupancy(
            0, 0, fparams.stages, fparams.shapes, int(fparams.dense_images),
            *fparams.stage_window, fparams.img_total, fparams.fp.numel(),
            fparams.ip.numel(), ctypes.byref(dyn))
        log(f"phase 18 K1 cylinder {mode}: the launcher picks {build} ({want} wanted), "
            f"{blocks} blocks of 256 resident at its launch ({fparams.img_total} image "
            f"floats, window {fparams.stage_window}, {dyn.value} bytes of dynamic shared "
            f"memory)")
        if build != want:
            raise AssertionError(f"phase 18: the cylinder in {mode} takes {build}")
        gen = torch.Generator(device="cuda").manual_seed(18)
        uniforms = torch.rand((fparams.n_draws, n), generator=gen, device="cuda")
        for label, kwargs in (("input", {"uniforms": uniforms}), ("hw", {"seed": (181, 18)})):
            worst = max(worst, twin_equal(
                ft.fused_run_cuda(fparams, n, n, **kwargs),
                ft.fused_run_plain(fparams, n, n, **kwargs, terms=True),
                f"phase 18 K1 cylinder {mode} rng={label}", fparams))
        if mode == "mc":
            spec = ft.HistorySpec("found", 8, 8192)
            for kwargs in ({"seed": (182, 18)}, {"uniforms": uniforms}):
                worst = max(worst, k1e_against_twin(ft, fparams, n, spec,
                                                    "phase 18 K1e found cylinder",
                                                    **kwargs)[0])

    ft.fused_run_cuda.launches = 0
    fused = raytrace(cylinder_config(1 << 22, 4, "fused"), device="cuda")
    launches = ft.fused_run_cuda.launches
    if launches <= 0:
        raise AssertionError("the cylinder on the fused engine did not launch K1")
    eager = raytrace(cylinder_config(1 << 20, 4, "xla"), device="cuda")
    metas = [{k: v["num_out"] for k, v in r["total"]["meta"].items()} for r in (fused, eager)]
    for meta, res in zip(metas, (fused, eager)):
        for name, img in res["total"]["image"].items():
            if not (np.isfinite(img).all() and int(img.sum()) == meta[name]):
                raise AssertionError(f"phase 18: image {name} does not sum to its count")
    p = [m["detector"] / m["source"] for m in metas]
    pooled = sum(m["detector"] for m in metas) / sum(m["source"] for m in metas)
    sigma = math.sqrt(pooled * (1 - pooled) * sum(1 / m["source"] for m in metas))
    log(f"phase 18 cylindrical crystal through raytrace: fused {metas[0]}, eager "
        f"{metas[1]}; efficiency {p[0]:.6g} vs {p[1]:.6g}, {abs(p[0] - p[1]) / sigma:.2f} "
        f"binomial sigma (< 5); K1 launches {launches}")
    if abs(p[0] - p[1]) > 5 * sigma or metas[0]["detector"] <= 0:
        raise AssertionError("phase 18: the engines disagree on the cylinder")

    n = 1 << 22
    fparams = k1_pack(engine.Pipeline(cylinder_config(n, 1, "fused"), device="cuda"))
    ms = cuda_ms(lambda: ft.fused_run_cuda(fparams, n, n, seed=(1, 2)), 20)
    k1a_ms = cuda_ms(lambda: ft.fused_run_cuda(k1a, n, n, seed=(1, 2)), 20)
    plain_ms = cuda_ms(lambda: ft.fused_run_plain(fparams, n, n, seed=(1, 2)), 3)
    k1c_bound, k1c_flat = k1_bounds(fparams, n)
    log(f"phase 18 timings on {smi}: K1 cylinder ({k1_build_name(fparams)}) {ms:.4f} ms vs "
        f"twin {plain_ms:.4f} ms (2^22 rays, Philox), K1a beside it {k1a_ms:.4f} ms; "
        f"bound {k1c_bound[0]:.4f} ms ({k1c_bound[1]}, the rays alive into each optic; "
        f"flat {k1c_flat[0]:.4f} ms); {ptxas_registers('fused_trace_cylinder_kernelILi0ELb0E')}")
    return {"launches": launches, "err": worst, "ms": ms, "plain_ms": plain_ms,
            "k1a_ms": k1a_ms, "bound": k1c_bound, "bound_flat": k1c_flat,
            "build": k1_build_name(fparams)}


def phase_k5_variants(fg, engine, kinds=GRAD_VARIANTS, phase="19", n=1 << 20) -> tuple:
    """K5f and K5b against their float32 twins (the bounds of phases 8-9)
    and K5b against the float64 twin, on each variant of ``n`` rays, both
    RNG modes. Returns the largest |K5f - twin| pixel and |K5b - f32 twin|
    slot."""
    worst_f = worst_b = 0.0
    for kind in kinds:
        pipe = engine.Pipeline(grad_variant(kind, n), device="cuda")
        _, _, pack, spec = fg.build_fused_diff(pipe)
        static, lam, n_total = spec["static"], spec["lam"], spec["n_total"]
        pvec = pack(pipe.params).detach()
        gen = torch.Generator(device="cuda").manual_seed(19)
        uniforms = torch.rand((static.n_draws, n_total), generator=gen, device="cuda")
        g = torch.randn(static.img_total, generator=gen, device="cuda")
        for label, kwargs in (("input", {"uniforms": uniforms}), ("hw", {"seed": (1919, 7)})):
            k = fg.fused_grad_forward_cuda(static, pvec, n_total, lam, **kwargs)
            t = fg.fused_grad_forward_plain(static, pvec, n_total, lam, chunk=1 << 18,
                                            **kwargs)
            torch.cuda.synchronize()
            rel_total = abs(k.sum().item() - t.sum().item()) / t.sum().item()
            pix = (k - t).abs().max().item() / t.abs().max().item()
            worst_f = max(worst_f, (k - t).abs().max().item())
            kb = fg.fused_grad_vjp_cuda(static, pvec, n_total, lam, g, **kwargs).double().cpu()
            wb = fg.fused_grad_vjp_plain(static, pvec, n_total, lam, g, chunk=1 << 18,
                                         **kwargs).double().cpu()
            tb = fg.fused_grad_vjp_plain(static, pvec.double(), n_total, lam, g.double(),
                                         chunk=1 << 18, **kwargs).cpu()
            scale32, scale = wb.abs().max().item(), tb.abs().max().item()
            used32 = ((kb - wb).abs() / (1e-3 * wb.abs() + 1e-5 * scale32)).max().item()
            used = ((kb - tb).abs() / (2e-2 * tb.abs() + 5e-3 * scale))
            # On a convex mirror a ray on a pixel boundary within float32
            # rounding flips its tent slope, in the mirror's origin-x slot
            # (tests/test_torch_fused_grad.py); that slot is reported.
            slot0 = f"{kb[0].item():.6g} vs f64 {tb[0].item():.6g}"
            if kind.startswith("convex") and "mirror" in kind:
                used[0] = 0.0
            used = used.max().item()
            worst_b = max(worst_b, (kb - wb).abs().max().item())
            log(f"phase {phase} {kind} rng={label} ({n_total} rays): K5f total rel "
                f"{rel_total:.3g} (< 1e-4), pixel {pix:.3g} of the maximum (< 1e-3); "
                f"K5b uses {used32:.3g} of the f32-twin bound (rtol 1e-3, atol 1e-5 "
                f"scale) and {used:.3g} of the f64 bound (rtol 2e-2, atol 5e-3 scale); "
                f"slot 0 {slot0}")
            if not (rel_total < 1e-4 and pix < 1e-3):
                raise AssertionError(f"K5f differs from its twin on {kind} ({label})")
            if used32 > 1.0 or used > 1.0:
                raise AssertionError(f"K5b differs from its twins on {kind} ({label}): "
                                     f"{(kb - wb).tolist()} / {(kb - tb).tolist()}")
            if kind == "plasma_cubic":
                b = len(pipe.optics) * fg.SLOTS_PER_OPTIC
                if not (tb[b] != 0 and tb[b + 1] != 0):
                    raise AssertionError("phase 19: no emissivity or temperature gradient")
            elif kind in GRAD_SOURCE_VARIANTS and not static.full_source:
                raise AssertionError(f"phase {phase}: {kind} did not take the full sampler")
    return worst_f, worst_b


def sign_descent_example07(forward, vjp, pack, pipeline, fg):
    """Example 07's main() on the port: the target at the true parameters,
    a perturbed d-spacing, 14 sign steps of a shrinking size. Returns the
    errors and the unpacked gradient at the perturbed start."""
    pvec_true = pack(pipeline.params).detach()
    target = forward(pvec_true, 7)["image"]
    slot = fg.SLOTS_PER_OPTIC * 0 + 13
    d_true = float(pvec_true[slot])
    pvec = pvec_true.clone()
    pvec[slot] = d_true * (1 + 2e-4)
    errs = [abs(float(pvec[slot]) - d_true)]
    step, gvec0 = 2.5e-4, None
    for _ in range(14):
        out = forward(pvec, 7)["image"]
        gvec = vjp(pvec, 7, {k: out[k] - target[k] for k in out})
        gvec0 = gvec if gvec0 is None else gvec0
        pvec[slot] -= step * float(torch.sign(gvec[slot]))
        step *= 0.6
        errs.append(abs(float(pvec[slot]) - d_true))
    return errs, fg.unpack_grads(pipeline, gvec0)


def phase_example07(fg, make_fused_differentiable):
    cfg = example_config("example_07_fused_gradients.py")
    for label, config in (("torus", cfg), ("cylinder twin", cylindrical(cfg))):
        t0 = time.perf_counter()
        errs, grads = sign_descent_example07(
            *make_fused_differentiable(config, device="cuda"), fg)
        crystal = grads["crystal"]
        log(f"phase 20 example 07 ({label}, {time.perf_counter() - t0:.2f} s): "
            f"d-spacing error {errs[0]:.3g} -> {errs[-1]:.3g} (< {0.2 * errs[0]:.3g}); "
            f"d(loss)/d(radius) {crystal['radius']:.6g}, d(loss)/d(radius_minor) "
            f"{crystal['radius_minor']:.6g}, d(loss)/d(origin) {crystal['origin']}")
        if not errs[-1] < 0.2 * errs[0]:
            raise AssertionError(f"example 07 ({label}) did not recover the spacing: {errs}")
        if crystal["radius"] == 0.0 or (label == "torus" and crystal["radius_minor"] == 0.0):
            raise AssertionError(f"example 07 ({label}): zero radius gradients")


def cylindrical(cfg):
    """Example 07's chain with a cylindrical crystal of the torus's major
    radius."""
    cfg = copy.deepcopy(cfg)
    crystal = cfg["optics"]["crystal"]
    crystal["class_name"] = "XicsrtOpticCylindricalCrystal"
    crystal["radius"] = crystal.pop("radius_major")
    del crystal["radius_minor"]
    return cfg


def phase_example08(fg, engine, make_fused_differentiable, make_differentiable):
    """Example 08's main() on the port, then its gradients: d/dE against a
    central finite difference of K5f, d/dT against one of K5f and against
    the eager engine's autograd (tests/test_fused_grad.py:720-817)."""
    example = repo_function("examples/example_08_plasma_fitting.py", "_config")
    E_true, T_true = 8.3e20, 2.0e4
    t0 = time.perf_counter()
    forward, vjp, pack, pipeline = make_fused_differentiable(
        example(E_true, T_true), chunk=8192, device="cuda")
    pvec_true = pack(pipeline.params).detach()
    b = len(pipeline.optics) * fg.SLOTS_PER_OPTIC
    target = forward(pvec_true, 3)["image"]["detector"]
    pvec = pvec_true.clone()
    pvec[b] *= 0.6
    pvec[b + 1] *= 0.5
    m, v = np.zeros(2), np.zeros(2)
    lr, b1, b2 = 0.08, 0.9, 0.999
    for step in range(200):
        out = forward(pvec, 3)["image"]
        g_img = {k: out[k] - target if k == "detector" else torch.zeros_like(out[k])
                 for k in out}
        gvec = vjp(pvec, 3, g_img).double().cpu().numpy()
        theta = np.log(pvec[b:b + 2].double().cpu().numpy())
        grad = gvec[b:b + 2] * np.exp(theta)
        m = b1 * m + (1 - b1) * grad
        v = b2 * v + (1 - b2) * grad * grad
        mh, vh = m / (1 - b1 ** (step + 1)), v / (1 - b2 ** (step + 1))
        theta = theta - lr * mh / (np.sqrt(vh) + 1e-12)
        pvec[b:b + 2] = torch.from_numpy(np.exp(theta)).float().to("cuda")
    E_fit, T_fit = float(pvec[b]), float(pvec[b + 1])
    log(f"phase 21 example 08 ({int(fg.build_fused_diff(pipeline)[3]['n_total'])} "
        f"rays, 200 Adam steps, "
        f"{time.perf_counter() - t0:.2f} s): E {E_fit:.4e} ({abs(E_fit / E_true - 1) * 100:.2f} "
        f"% off, < 5 %), T {T_fit:.1f} ({abs(T_fit / T_true - 1) * 100:.2f} % off, < 15 %)")
    if not (abs(E_fit / E_true - 1) < 0.05 and abs(T_fit / T_true - 1) < 0.15):
        raise AssertionError("example 08 did not recover E and T")

    # The gradients on a second-moment loss of the detector image.
    img0 = forward(pvec_true, 4)["image"]
    prof = img0["detector"].sum(dim=1).double().cpu().numpy()
    cx = (np.arange(len(prof)) * prof).sum() / max(prof.sum(), 1e-9)
    nx, ny = img0["detector"].shape
    g_det = torch.from_numpy(np.broadcast_to(((np.arange(nx) - cx) ** 2)[:, None],
                                             (nx, ny)).astype(np.float32).copy()).cuda()
    gs = {"crystal": torch.zeros_like(img0["crystal"]), "detector": g_det}
    gv = vjp(pvec_true, 4, gs).double().cpu().numpy()

    def loss_at(k, scale):
        pv = pvec_true.clone()
        pv[k] *= scale
        return float((forward(pv, 4)["image"]["detector"].double() * g_det.double()).sum())

    E0, T0 = float(pvec_true[b]), float(pvec_true[b + 1])
    fd_E = (loss_at(b, 1.05) - loss_at(b, 0.95)) / (0.1 * E0)
    fd_T = (loss_at(b + 1, 1.02) - loss_at(b + 1, 0.98)) / (0.04 * T0)
    xconfig = example(E_true, T_true)
    xconfig["general"]["dtype"] = "float64"
    image_fn, pipe64 = make_differentiable(xconfig, device="cuda")
    g_x = []
    for k in range(6):
        T = pipe64.params["sources"]["plasma"]["temperature"].clone().requires_grad_(True)
        params = dict(pipe64.params)
        params["sources"] = {"plasma": dict(params["sources"]["plasma"], temperature=T)}
        img = image_fn(params, torch.Generator(device="cuda").manual_seed(100 + k))
        (img["detector"] * g_det.double()).sum().backward()
        g_x.append(float(T.grad))
    g_f = np.array([float(vjp(pvec_true, 200 + k, gs)[b + 1]) for k in range(6)])
    mf, sf = g_f.mean(), g_f.std(ddof=1) / math.sqrt(6)
    mx, sx = float(np.mean(g_x)), float(np.std(g_x, ddof=1)) / math.sqrt(6)
    log(f"phase 21 example 08 gradients: d/dE K5b {gv[b]:.6g} vs finite difference "
        f"{fd_E:.6g} ({abs(gv[b] / fd_E - 1) * 100:.3f} % off, < 2 %); d/dT K5b "
        f"{gv[b + 1]:.6g} vs finite difference {fd_T:.6g} ({abs(gv[b + 1] / fd_T - 1) * 100:.2f} "
        f"% off, < 15 %); d/dT over 6 seeds: K5b {mf:.6g} +- {sf:.3g}, eager autograd "
        f"(float64) {mx:.6g} +- {sx:.3g}")
    if abs(gv[b] - fd_E) > 2e-2 * abs(fd_E):
        raise AssertionError("example 08: d/dE disagrees with the finite difference")
    if abs(gv[b + 1] - fd_T) > 0.15 * abs(fd_T):
        raise AssertionError("example 08: d/dT disagrees with the finite difference")
    if not (abs(mf) > 3 * sf and abs(mf - mx) < 6 * math.sqrt(sf**2 + sx**2) + 0.05 * abs(mx)):
        raise AssertionError("example 08: K5b and eager d/dT disagree")


def grad_timing_configs():
    """Example 07's chain at 2^22 rays (tools/bench_fused_grad.py
    ``torus``), its cylindrical twin, and ``plasma_cubic`` at 2^22 expected
    photons, each of 4 iterations."""
    torus = repo_function("tools/bench_fused_grad.py", "_config")("torus")
    torus["general"]["number_of_iter"] = 4
    return {"torus": torus, "cylinder": cylindrical(torus),
            "plasma_cubic": grad_variant("plasma_cubic", 1 << 22, num_iter=4)}


def phase_grad_timings(smi, fg, engine, make_fused_differentiable) -> dict:
    out = {}
    for label, cfg in grad_timing_configs().items():
        forward, vjp, pack, pipe = make_fused_differentiable(cfg, device="cuda")
        pvec = pack(pipe.params).detach()
        n_total = fg.build_fused_diff(pipe)[3]["n_total"]
        step_ms = cuda_ms(lambda: vjp(pvec, 3, forward(pvec, 3)["image"]), 5)
        _, _, _, spec = fg.build_fused_diff(pipe, num_iter=1)
        st, lam, n = spec["static"], spec["lam"], spec["n_total"]
        g = torch.randn(st.img_total, device="cuda")
        f_ms = cuda_ms(lambda: fg.fused_grad_forward_cuda(st, pvec, n, lam, seed=(1, 2)), 20)
        f_plain = cuda_ms(lambda: fg.fused_grad_forward_plain(st, pvec, n, lam, seed=(1, 2),
                                                              chunk=n), 3)
        b_ms = cuda_ms(lambda: fg.fused_grad_vjp_cuda(st, pvec, n, lam, g, seed=(1, 2)), 20)
        b_plain = cuda_ms(lambda: fg.fused_grad_vjp_plain(st, pvec, n, lam, g, seed=(1, 2),
                                                          chunk=n), 3)
        k5_bytes = packed_bytes(st.fp, st.ip, pvec) + st.img_total * 4
        f_bound = bound(k5_bytes, k5_ops(st, False) * n)
        b_bound = bound(k5_bytes + pvec.numel() * 4, k5_ops(st, True) * n)
        log(f"phase 22 {label} on {smi}: forward+vjp step {n_total / step_ms * 1e3:.4g} "
            f"rays/s ({step_ms:.3f} ms for {n_total} rays); per {n} rays K5f {f_ms:.4f} ms "
            f"(twin {f_plain:.3f} ms, bound {f_bound[0]:.4f} ms by {f_bound[1]}), K5b "
            f"{b_ms:.4f} ms (twin {b_plain:.3f} ms, bound {b_bound[0]:.4f} ms by "
            f"{b_bound[1]})")
        out[label] = {"step_ms": step_ms, "f_ms": f_ms, "f_plain": f_plain, "b_ms": b_ms,
                      "b_plain": b_plain, "f_bound": f_bound, "b_bound": b_bound}
    return out


def curved_phases(smi, ft, fg, engine, raytrace, k1a) -> dict:
    """Phases 18-22 (``k1a``: the flagship's packed buffers, timed beside the
    cylinder); returns the K1-cylinder and new K5 rows' results."""
    from xicsrt_tpu_torch.gradients import make_differentiable, make_fused_differentiable

    k1c = phase_k1_cylinder(smi, ft, engine, raytrace, k1a)
    k5f_err, k5b_err = phase_k5_variants(fg, engine)
    fg.fused_grad_forward_cuda.launches = 0
    fg.fused_grad_vjp_cuda.launches = 0
    phase_example07(fg, make_fused_differentiable)
    phase_example08(fg, engine, make_fused_differentiable, make_differentiable)
    launches = (fg.fused_grad_forward_cuda.launches, fg.fused_grad_vjp_cuda.launches)
    log(f"phases 20-21: K5f launches {launches[0]}, K5b {launches[1]}")
    if min(launches) <= 0:
        raise AssertionError("examples 07 and 08 did not launch K5f and K5b")
    timings = phase_grad_timings(smi, fg, engine, make_fused_differentiable)
    return {"k1c": k1c, "k5f_err": k5f_err, "k5b_err": k5b_err,
            "k5f_launches": launches[0], "k5b_launches": launches[1],
            "timings": timings}


# ---------------------------------------------------------------------------
# Phases 23-26: the generic source matrix (K1b, K5e-generic) and the
# trace-only kernel K3.
# ---------------------------------------------------------------------------

SOURCE_VARIANTS = ("box_voigt", "gaussian_uniform_velocity", "focused", "flat",
                   "flat_xy", "gaussian", "isotropic_xy_asym", "sightline")


def source_variant_config(kind, intensity, num_iter=1, **general):
    """The flagship chain with ``tests/test_fused_engine.py``'s widened
    sources (:403-470, :944, :977)."""
    cfg = flagship(intensity, num_iter, **general)
    src = cfg["sources"]["source"]
    if kind == "box_voigt":
        src.update(xsize=0.01, ysize=0.01, zsize=0.005, wavelength_dist="voigt",
                   linewidth=1e12, temperature=500.0, mass_number=40.0)
        cfg["optics"]["crystal"]["rocking_fwhm"] = 200e-6
    elif kind == "gaussian_uniform_velocity":
        src.update(spatial_dist="gaussian", xsize=0.01, ysize=0.01, zsize=0.0,
                   wavelength_dist="uniform", wavelength_range=[3.94, 3.96],
                   velocity=[0.0, 0.0, 1e5])
        cfg["optics"]["crystal"]["rocking_fwhm"] = 200e-6
    elif kind == "focused":
        src.pop("angular_dist")
        src.update(class_name="XicsrtSourceFocused", target=[0.0, 0.0, 0.80374151],
                   xsize=0.02, ysize=0.02, zsize=0.0, spread=math.radians(8.0))
    elif kind == "flat":
        src.update(angular_dist="flat", spread=math.radians(8.0))
    elif kind == "flat_xy":
        src.update(angular_dist="flat_xy", spread=[math.radians(6.0), math.radians(9.0)])
    elif kind == "gaussian":
        src.update(angular_dist="gaussian", spread=math.radians(4.0))
    elif kind == "isotropic_xy_asym":
        src.update(spread=[-math.radians(4.0), math.radians(9.0),
                           -math.radians(5.0), math.radians(8.0)])
    elif kind == "sightline":
        src.update(xsize=0.06, ysize=0.06, zsize=0.0, filters=["sight"])
        cfg["filters"] = {"sight": {"class_name": "XicsrtBundleFilterSightline",
                                    "origin": [0.01, 0.0, 0.0], "zaxis": [0.0, 0.0, 1.0],
                                    "radius": 0.02}}
    else:
        raise ValueError(kind)
    return cfg


def source_matrix_config(intensity, num_iter, engine_kind, **general):
    """Phase 24's source on the flagship crystal and detector: the Ar XVII
    line at 3.9492 A from a 1 keV focused gaussian source with its natural
    width and a 1e5 m/s flow (``tests/test_fused_grad.py``'s
    ``focused_gaussian_voigt``, aimed at the flagship crystal, its flow
    turned onto the sightline so that it shifts the line by lambda v / c)."""
    cfg = flagship(intensity, num_iter, engine=engine_kind, **general)
    cfg["sources"]["source"] = {
        "class_name": "XicsrtSourceFocused", "intensity": intensity,
        "wavelength": 3.9492, "spatial_dist": "gaussian",
        "xsize": 0.004, "ysize": 0.004, "zsize": 0.002,
        "angular_dist": "isotropic", "spread": math.radians(9.0),
        "target": [0.0, 0.0, 0.80374151], "wavelength_dist": "voigt",
        "linewidth": 1e12, "temperature": 1000.0, "mass_number": 40.0,
        "velocity": [0.0, 0.0, 1e5]}
    return cfg


def phase_k1b(smi, ft, engine) -> dict:
    """Phase 23: K1b against its twin on every source variant, 2^20 rays,
    both RNG modes, and on phase 24's source at the 2^22 x 4 rays of its
    launch; then its time there per 2^22 rays."""
    n = 1 << 20
    tol = max(2, int(1e-6 * n))
    worst = 0.0
    for kind in SOURCE_VARIANTS:
        fparams = k1_pack(engine.Pipeline(source_variant_config(kind, n, 1),
                                              device="cuda"))
        if not fparams.full_source:
            raise AssertionError(f"phase 23: {kind} did not take the full sampler")
        gen = torch.Generator(device="cuda").manual_seed(23)
        uniforms = torch.rand((fparams.n_draws, n), generator=gen, device="cuda")
        for label, kwargs in (("input", {"uniforms": uniforms}), ("hw", {"seed": (2323, 5)})):
            ck, ik = ft.fused_run_cuda(fparams, n, n, **kwargs)
            cp, iq = ft.fused_run_plain(fparams, n, n, **kwargs)
            torch.cuda.synchronize()
            dc, di = (ck - cp).abs(), (ik - iq).abs()
            log(f"phase 23 K1b {kind} rng={label}: kernel counts {ck.tolist()}, twin "
                f"{cp.tolist()}; image L1 diff {di.sum().item():.0f} (tolerance {tol} "
                f"rays per element)")
            if dc.max().item() > tol or di.sum().item() > 2 * tol * fparams.n_optics:
                raise AssertionError(f"K1b differs from its twin ({kind}, rng={label})")
            if cp[-1].item() <= 0:
                raise AssertionError(f"phase 23: no detector hits ({kind})")
            worst = max(worst, float(dc.max().item()), float(di.max().item()))
    n = 1 << 22
    fparams = k1_pack(engine.Pipeline(source_matrix_config(n, 1, "fused"),
                                          device="cuda"))
    n_main = 4 * n
    tol = max(2, int(1e-6 * n_main))
    ck, ik = ft.fused_run_cuda(fparams, n_main, n_main, seed=(1, 2))
    cp, iq = ft.fused_run_plain(fparams, n_main, n_main, seed=(1, 2))
    torch.cuda.synchronize()
    dc, di = (ck - cp).abs(), (ik - iq).abs()
    log(f"phase 23 K1b on phase 24's source, {n_main} rays: kernel counts {ck.tolist()}, "
        f"twin {cp.tolist()}; image L1 diff {di.sum().item():.0f} (tolerance {tol} rays "
        f"per element)")
    if dc.max().item() > tol or di.sum().item() > 2 * tol * fparams.n_optics:
        raise AssertionError("K1b differs from its twin on phase 24's source")
    worst = max(worst, float(dc.max().item()), float(di.max().item()))
    ms = cuda_ms(lambda: ft.fused_run_cuda(fparams, n, n, seed=(1, 2)), 20)
    plain_ms = cuda_ms(lambda: ft.fused_run_plain(fparams, n, n, seed=(1, 2)), 3)
    k1b_bound, k1b_flat = k1_bounds(fparams, n)
    log(f"phase 23 timings on {smi}: K1b (focused gaussian box, Voigt line, Doppler) "
        f"{ms:.4f} ms vs twin {plain_ms:.4f} ms (2^22 rays, Philox); bound "
        f"{k1b_bound[0]:.4f} ms ({k1b_bound[1]}, the rays alive into each optic; flat "
        f"{k1b_flat[0]:.4f} ms, {k1_ops(fparams)} operations per ray)")
    return {"err": worst, "ms": ms, "plain_ms": plain_ms, "bound": k1b_bound,
            "bound_flat": k1b_flat}


def ragged_bundles(bundles, seed):
    """A plasma's tables ``bundles`` (cum, table per iteration) cut for K1's
    bundle search: runs of 1-40 zero-photon bundles (about a twentieth of
    them) in every iteration, and each iteration's slots raised to 32 m + 17
    past its count, the first iteration's last bundle filling its slots, so
    that a warp's live lanes span two iterations and the other iterations
    end in dead slots. Returns ((cum, table), the slots of all iterations)."""
    cum, table = bundles
    rng = np.random.default_rng(seed)
    counts = np.diff(cum.cpu().numpy().astype(np.int64), axis=1, prepend=0)
    n_bundles = counts.shape[1]
    for row in counts:
        for _ in range(max(1, n_bundles // 400)):
            a = int(rng.integers(0, n_bundles))
            row[a:a + int(rng.integers(1, 41))] = 0
    n_per_iter = 32 * (int(counts.sum(axis=1).max()) // 32 + 1) + 17
    counts[0, -1] += n_per_iter - counts[0].sum()
    cum = torch.from_numpy(np.cumsum(counts, axis=1).astype(np.int32)).to(table.device)
    return (cum, table), n_per_iter * counts.shape[0]


def k1_source_build_chains(n) -> dict:
    """The K1 builds of each source kind past K1a's and K1b's own, as chains
    of ``n`` rays (a plasma's: ``n`` expected photons): ``plasma_torus``'s
    plasma and phase 24's generic source in weight mode, with bilinear
    images, with both (the ``kStages`` 1 builds), behind ``mosaic15``'s
    mosaic crystal in mc and weight mode (``kStages`` 2) and behind phase
    30's sphere mesh (the Chebyshev builds, its curve widened to 2 mrad)."""
    cls, kw = MESH_CRYSTALS["mesh_sphere"]
    mesh = mesh_config(n, 1, "fused", cls, **dict(kw, rocking_fwhm=2e-3))["optics"]["crystal"]
    mosaic = mosaic15_config(n, 1, "fused")["optics"]["crystal"]
    makers = {"plasma": lambda **g: plasma_config(n, 1, engine="fused", **g),
              "generic": lambda **g: source_matrix_config(n, 1, "fused", **g)}
    chains = {}
    for kind, make in makers.items():
        for mode, general in WEIGHT_MODES.items():
            chains[f"{kind} {mode}"] = make(**general)
        for mode in ("mc", "weight"):
            chains[f"{kind} mosaic {mode}"] = make(interact_mode=mode)
            chains[f"{kind} mosaic {mode}"]["optics"]["crystal"] = copy.deepcopy(mosaic)
        chains[f"{kind} mesh"] = make()
        chains[f"{kind} mesh"]["optics"]["crystal"] = copy.deepcopy(mesh)
    return chains


def k1_build_against_twin(ft, engine, cfg, label, seed, history=None) -> float:
    """K1 on ``cfg``'s rays (a plasma's one iteration of slots and its bundle
    tables) against its twin in both RNG modes, as ``twin_equal`` holds them;
    with a ``history`` spec, K1's marked build and K1e as
    ``k1e_against_twin`` holds them. Returns the largest difference."""
    from xicsrt_tpu_torch.draws import Draws

    pipe = engine.Pipeline(cfg, device="cuda")
    fparams = k1_pack(pipe)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bundles = None
    if fparams.plasma:
        bundles = ft.plasma_bundles(pipe.source, pipe.params["sources"][pipe.source.name],
                                    pipe.params["filters"], Draws(gen), 1)
    n = pipe.num_rays
    uniforms = torch.rand((fparams.n_draws, n), generator=gen, device="cuda")
    err = 0.0
    for rng, kwargs in (("input", {"uniforms": uniforms}), ("hw", {"seed": (seed, 7)})):
        name = f"{label} rng={rng} ({n} rays)"
        if history is not None:
            err = max(err, k1e_against_twin(ft, fparams, n, history, name, bundles,
                                            **kwargs)[0])
            continue
        err = max(err, twin_equal(
            ft.fused_run_cuda(fparams, n, n, bundles=bundles, **kwargs),
            ft.fused_run_plain(fparams, n, n, bundles=bundles, terms=True, **kwargs),
            name, fparams))
    return err


def phase_k1_source_builds(ft, engine, n=1 << 18) -> float:
    """Phase 23's builds: every K1 build of the plasma and of the generic
    sampler past their own (``k1_source_build_chains``), and K1e 'found'
    on each (4 slots of 4096 rays), against their twins in both RNG
    modes. Returns the largest difference."""
    err = 0.0
    for k, (name, cfg) in enumerate(k1_source_build_chains(n).items()):
        err = max(err, k1_build_against_twin(ft, engine, cfg, f"phase 23 K1 {name}", 230 + k))
    for k, name in enumerate(("plasma", "generic")):
        cfg = plasma_config(n, 1, engine="fused") if name == "plasma" else \
            source_matrix_config(n, 1, "fused")
        err = max(err, k1_build_against_twin(ft, engine, cfg, f"phase 23 K1e found {name}",
                                             250 + k, ft.HistorySpec("found", 4, 4096)))
    return err


def image_chi2(a, b) -> tuple:
    """Two-sample chi-square of two count images: pixels with 10 or more
    counts between them, the rest pooled into one bin. Returns (chi2,
    degrees of freedom)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    big = a + b >= 10
    a = np.append(a[big], a[~big].sum())
    b = np.append(b[big], b[~big].sum())
    keep = a + b > 0
    a, b = a[keep], b[keep]
    ka, kb = math.sqrt(b.sum() / a.sum()), math.sqrt(a.sum() / b.sum())
    return float(np.sum((ka * a - kb * b) ** 2 / (a + b))), int(keep.sum()) - 1


def engines_agree(fused, eager, label, budget):
    """Images sum to counts on both engines; the detector efficiencies
    agree within 5 binomial sigma, and each image of one engine is drawn
    from the same distribution as the other's (two-sample chi-square below
    dof + 5 sqrt(2 dof)). Returns both metas."""
    metas = [{k: v["num_out"] for k, v in r["total"]["meta"].items()} for r in (fused, eager)]
    for meta, res in zip(metas, (fused, eager)):
        for name, img in res["total"]["image"].items():
            if not (np.isfinite(img).all() and int(img.sum()) == meta[name]):
                raise AssertionError(f"{label}: image {name} does not sum to its count")
        if meta["detector"] <= 0:
            raise AssertionError(f"{label}: no detector hits")
    p = [m["detector"] / m["source"] for m in metas]
    pooled = sum(m["detector"] for m in metas) / sum(m["source"] for m in metas)
    sigma = math.sqrt(pooled * (1 - pooled) * sum(1 / m["source"] for m in metas))
    log(f"{label}: fused {metas[0]}, eager {metas[1]} (budgets {budget}); efficiency "
        f"{p[0]:.6g} vs {p[1]:.6g}, {abs(p[0] - p[1]) / sigma:.2f} binomial sigma (< 5)")
    if abs(p[0] - p[1]) > 5 * sigma:
        raise AssertionError(f"{label}: the engines disagree")
    for name, img in fused["total"]["image"].items():
        chi2, dof = image_chi2(img, eager["total"]["image"][name])
        if dof < 1:
            continue
        limit = dof + 5 * math.sqrt(2 * dof)
        log(f"{label}: {name} images, chi2 {chi2:.1f} on {dof} dof (< {limit:.1f})")
        if chi2 > limit:
            raise AssertionError(f"{label}: the engines' {name} images differ")
    return metas


def line_quartiles(cfg) -> tuple:
    """The source line's quartiles about its centre: scipy's Voigt profile of
    the Doppler sigma and natural half width, summed on a grid of 1.2e6
    points over +-60 sigma (independent of the port's CDF table)."""
    from scipy.special import voigt_profile

    p = cfg["sources"]["source"]
    w0, c = p["wavelength"], 299792458.0
    sigma = w0 * math.sqrt(p["temperature"] * 1.602176634e-19
                           / (p["mass_number"] * 1.66053906660e-27 * c**2))
    gamma = p["linewidth"] * w0**2 / (4.0 * math.pi * c * 1e10)
    x = np.linspace(-60.0 * sigma, 60.0 * sigma, 1_200_001)
    pdf = voigt_profile(x, sigma, gamma)
    cdf = np.cumsum(pdf) - 0.5 * pdf
    cdf /= cdf[-1] + 0.5 * pdf[-1]
    return tuple(float(np.interp(q, cdf, x)) for q in (0.25, 0.5, 0.75))


def phase_source_matrix(ft, engine, raytrace) -> int:
    """Phase 24: the source matrix through ``raytrace`` on both engines at
    2^22 rays x 4 (K1b counted around the fused runs), their images against
    each other; a sightline-filtered uniform box; the eager engine's
    detected line against the source's. Returns K1b's launches."""
    n, iters = 1 << 22, 4
    ft.fused_run_cuda.launches = 0
    fused = raytrace(source_matrix_config(n, iters, "fused"), device="cuda")
    filt_cfg = source_variant_config("sightline", n, iters, engine="fused")
    fused_filt = raytrace(copy.deepcopy(filt_cfg), device="cuda")
    launches = ft.fused_run_cuda.launches
    if launches <= 0:
        raise AssertionError("phase 24: the source matrix did not launch K1b")
    eager = raytrace(source_matrix_config(n, iters, "xla"), device="cuda")
    # The detector image's dispersion axis holds the line: K1b's exact
    # Gauss + Cauchy and Doppler against the eager engine's tabulated line.
    engines_agree(fused, eager, "phase 24 focused Voigt source", n * iters)
    filt_cfg["general"]["engine"] = "xla"
    eager_filt = raytrace(filt_cfg, device="cuda")
    metas = engines_agree(fused_filt, eager_filt, "phase 24 sightline box", n * iters)
    expect = math.pi * 0.02**2 / 0.06**2
    for meta, label in zip(metas, ("fused", "eager")):
        frac = meta["source"] / (n * iters)
        dev = (frac - expect) / math.sqrt(expect * (1 - expect) / (n * iters))
        log(f"phase 24 sightline ({label}): {meta['source']} of {n * iters} rays kept, "
            f"{frac:.6f} against the geometry's {expect:.6f} ({dev:+.2f} sigma, < 5)")
        if abs(dev) > 5:
            raise AssertionError(f"phase 24: the sightline keeps {frac} on {label}")

    # The detected line: the eager engine's found rays against the source
    # line shifted by the flow, -lambda0 (v . d) / c averaged over their
    # source directions (the quartiles' standard errors from the line's
    # density there).
    cfg = source_matrix_config(1 << 20, 1, "xla", keep_history=True)
    res = raytrace(cfg, device="cuda")
    found = res["found"]["history"]
    src = cfg["sources"]["source"]
    w0 = src["wavelength"]
    w = found["detector"]["wavelength"].astype(np.float64) - w0
    d = found["source"]["direction"].astype(np.float64)
    flow = np.asarray(src["velocity"], np.float64)
    shift = -w0 * float(np.mean(d @ flow)) / 299792458.0
    q = np.quantile(w, [0.25, 0.5, 0.75])
    ref = np.array(line_quartiles(cfg)) + shift
    tol = 5 * 1.5 * (ref[2] - ref[0]) / math.sqrt(len(w))
    log(f"phase 24 detected line ({len(w)} rays): quartiles about {w0} A {q.tolist()} "
        f"against the source's {ref.tolist()} (tolerance {tol:.3g} A): median shift "
        f"{q[1]:.4g} A against the flow's {shift:.4g} A, interquartile range "
        f"{q[2] - q[0]:.4g} A against {ref[2] - ref[0]:.4g} A")
    if not (len(w) > 100 and abs(shift) > 5 * tol and np.all(np.abs(q - ref) < tol)):
        raise AssertionError("phase 24: the detected line is not the source's")
    return launches


def k3_pack(ft, pipe):
    """K3's packed chain (rays from memory) of a pipeline on the card, in its
    run modes (``tools/roofline.k3_pack``; ``ft`` stays in the signature
    ``chip_ab.py`` calls on every tree, the parent's too)."""
    return _k3_pack(pipe)


def eager_rays(pipe, seed):
    """One iteration of the pipeline's source, generated on the card."""
    from xicsrt_tpu_torch.draws import Draws

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return pipe.source.generate(pipe.params["sources"][pipe.source.name], Draws(gen),
                                pipe.params["filters"])


def phase_k3(smi, ft, engine, raytrace) -> dict:
    """Phase 25: K3 against its twin on the flagship's rays and a plasma's
    (per-ray Bragg angles through a torus), both RNG modes; then a
    ``plasma_torus`` of 8e6 bundles, past K1's 2^22, at 2^24 expected
    photons x 2 on ``engine='fused'``: K4 generates, K3 traces (counted
    around the run); then K3 against its twin on one iteration's rays of
    that run's size, and its time there."""
    worst = 0.0
    cases = (("flagship", engine.Pipeline(flagship(1 << 20, 1), device="cuda")),
             ("plasma_torus", engine.Pipeline(plasma_config(1 << 20, 1), device="cuda")))
    for label, pipe in cases:
        fparams = k3_pack(ft, pipe)
        rays = eager_rays(pipe, 25)
        n = rays.mask.shape[0]
        gen = torch.Generator(device="cuda").manual_seed(26)
        uniforms = torch.rand((fparams.n_draws, n), generator=gen, device="cuda")
        for rng, kwargs in (("input", {"uniforms": uniforms}), ("hw", {"seed": (2525, 9)})):
            args = (fparams, rays.origin, rays.direction, rays.wavelength, rays.mask)
            ck, ik = ft.fused_trace_run_cuda(*args, **kwargs)
            cp, iq = ft.fused_trace_run_plain(*args, **kwargs)
            torch.cuda.synchronize()
            log(f"phase 25 K3 {label} rng={rng}: {n} rays, kernel counts {ck.tolist()}, "
                f"twin {cp.tolist()}; image L1 diff {(ik - iq).abs().sum().item():.0f} "
                f"(tolerance 0: the same float32 operations, FMA-free build)")
            if not (torch.equal(ck, cp) and torch.equal(ik, iq)):
                raise AssertionError(f"K3 differs from its twin ({label}, rng={rng})")
            if ck[-1].item() <= 0:
                raise AssertionError(f"phase 25: no detector hits ({label})")
            worst = max(worst, (ik - iq).abs().max().item())

    cfg = plasma_config(1 << 24, 2, bundle_count=8_000_000, engine="fused")
    cfg["sources"]["plasma"]["max_bundles"] = int(1e7)
    ft.fused_trace_run_cuda.launches = 0
    t0 = time.perf_counter()
    res = raytrace(copy.deepcopy(cfg), device="cuda")
    seconds = time.perf_counter() - t0
    launches = ft.fused_trace_run_cuda.launches
    if launches <= 0:
        raise AssertionError("phase 25: the 8e6-bundle plasma did not launch K3")
    meta = check_plasma_result(res, cfg, "phase 25 plasma_torus, 8e6 bundles, fused (K3)")
    log(f"phase 25: {meta['plasma'] / seconds:.4g} photons/s ({seconds:.2f} s for the "
        f"first raytrace, its setup included); K3 launches {launches}")

    pipe = engine.Pipeline(cfg, device="cuda")
    fparams = k3_pack(ft, pipe)
    rays = eager_rays(pipe, 27)
    n = rays.mask.shape[0]
    args = (fparams, rays.origin, rays.direction, rays.wavelength, rays.mask)
    ck, ik = ft.fused_trace_run_cuda(*args, seed=(1, 2))
    cp, iq = ft.fused_trace_run_plain(*args, seed=(1, 2))
    torch.cuda.synchronize()
    log(f"phase 25 K3 on the 8e6-bundle plasma's {n} rays: kernel counts {ck.tolist()}, "
        f"twin {cp.tolist()}; image L1 diff {(ik - iq).abs().sum().item():.0f} (tolerance 0)")
    if not (torch.equal(ck, cp) and torch.equal(ik, iq)):
        raise AssertionError("K3 differs from its twin on the 8e6-bundle plasma's rays")
    if ck[-1].item() <= 0:
        raise AssertionError("phase 25: no detector hits (8e6-bundle plasma)")
    worst = max(worst, (ik - iq).abs().max().item())
    ms = cuda_ms(lambda: ft.fused_trace_run_cuda(*args, seed=(1, 2)), 20)
    plain_ms = cuda_ms(lambda: ft.fused_trace_run_plain(*args, seed=(1, 2)), 3)
    k3_bound = bound(29 * n + packed_bytes(fparams.fp, fparams.ip) + fparams.img_total * 4
                     + 8 * (1 + fparams.n_optics), chain_k1_ops(fparams) * n)
    log(f"phase 25 timings on {smi}: K3 {ms:.4f} ms vs twin {plain_ms:.4f} ms ({n} rays "
        f"of one iteration, {int(rays.mask.sum())} alive, Philox); bound "
        f"{k3_bound[0]:.4f} ms ({k3_bound[1]})")
    census = k3_census("phase 25", plasma_config(1 << 14, 1), n)
    return {"launches": launches, "err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound": k3_bound, "census": census}


def k3_census(label, cfg, n) -> tuple:
    """K3's census per ray of ``cfg``'s chain (``k3_ops_per_ray``: its twin
    on the CPU) and the bytes a ray it reads, for ``n`` timed rays; the
    class-rate bounds follow in phase 45, which measures the rates."""
    counts, per_ray, _ = k3_ops_per_ray(cfg)
    log(f"{label} K3 census a ray (its twin on {min(8192, n)} CPU rays): trans "
        f"{counts['trans']:.1f}, sqrtdiv {counts['sqrtdiv']:.1f}, simple "
        f"{counts['simple']:.1f}; {per_ray} bytes a ray read")
    return counts, per_ray, n


GRAD_SOURCE_VARIANTS = ("plane_crystal_flat", "sphere_mirror_isotropic",
                        "uniform_wavelength", "convex_sphere_flat_xy", "asym_xy_crystal",
                        "focused_gaussian_voigt")


def phase_k5_source_matrix(smi, fg, engine, make_fused_differentiable) -> dict:
    """Phase 26: K5f and K5b with the generic sampler against their float32
    and float64 twins on the six source-matrix variants at 2^20 rays (the
    bounds of phase 19); then ``make_fused_differentiable`` on
    ``focused_gaussian_voigt`` at 2^22 rays x 4 (counted around it), and
    the kernels' times there."""
    worst_f, worst_b = phase_k5_variants(fg, engine, GRAD_SOURCE_VARIANTS, "26")
    cfg = grad_variant("focused_gaussian_voigt", 1 << 22, num_iter=4)
    fg.fused_grad_forward_cuda.launches = 0
    fg.fused_grad_vjp_cuda.launches = 0
    forward, vjp, pack, pipe = make_fused_differentiable(cfg, device="cuda")
    pvec = pack(pipe.params).detach()
    out = forward(pvec, 26)["image"]
    gvec = vjp(pvec, 26, out)
    torch.cuda.synchronize()
    launches = (fg.fused_grad_forward_cuda.launches, fg.fused_grad_vjp_cuda.launches)
    if min(launches) <= 0:
        raise AssertionError("phase 26: the gradient path did not launch K5f and K5b")
    if not (all(torch.isfinite(v).all() and v.sum() > 0 for v in out.values())
            and torch.isfinite(gvec).all() and gvec.abs().max() > 0):
        raise AssertionError("phase 26: bad images or gradient")
    step_ms = cuda_ms(lambda: vjp(pvec, 3, forward(pvec, 3)["image"]), 5)
    _, _, _, spec = fg.build_fused_diff(pipe, num_iter=1)
    st, lam, n = spec["static"], spec["lam"], spec["n_total"]
    g = torch.randn(st.img_total, device="cuda")
    f_ms = cuda_ms(lambda: fg.fused_grad_forward_cuda(st, pvec, n, lam, seed=(1, 2)), 20)
    f_plain = cuda_ms(lambda: fg.fused_grad_forward_plain(st, pvec, n, lam, seed=(1, 2),
                                                          chunk=n), 3)
    b_ms = cuda_ms(lambda: fg.fused_grad_vjp_cuda(st, pvec, n, lam, g, seed=(1, 2)), 20)
    b_plain = cuda_ms(lambda: fg.fused_grad_vjp_plain(st, pvec, n, lam, g, seed=(1, 2),
                                                      chunk=n), 3)
    k5_bytes = packed_bytes(st.fp, st.ip, pvec) + st.img_total * 4
    f_bound = bound(k5_bytes, k5_ops(st, False) * n)
    b_bound = bound(k5_bytes + pvec.numel() * 4, k5_ops(st, True) * n)
    log(f"phase 26 focused_gaussian_voigt on {smi}: forward+vjp step "
        f"{4 * n / step_ms * 1e3:.4g} rays/s ({step_ms:.3f} ms for {4 * n} rays); per "
        f"{n} rays K5f {f_ms:.4f} ms (twin {f_plain:.3f} ms, bound {f_bound[0]:.4f} ms by "
        f"{f_bound[1]}), K5b {b_ms:.4f} ms (twin {b_plain:.3f} ms, bound "
        f"{b_bound[0]:.4f} ms by {b_bound[1]}); launches K5f {launches[0]}, K5b "
        f"{launches[1]}")
    return {"f_launches": launches[0], "b_launches": launches[1], "f_err": worst_f,
            "b_err": worst_b, "f_ms": f_ms, "f_plain": f_plain, "b_ms": b_ms,
            "b_plain": b_plain, "f_bound": f_bound, "b_bound": b_bound}


# ---------------------------------------------------------------------------
# Phases 27-31: mirrors (K1c-mirror), file rocking curves (K1c-file,
# K5c-file) and mesh surrogates (K1c-cheb) in K1, K3 and K5.
# ---------------------------------------------------------------------------

SMOKE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")


def write_xop_file(path, fwhm=48.070e-6, span_urad=300.0):
    """A synthetic XOP diff_pat.dat whose sigma curve is the gaussian
    rocking model of ``fwhm`` and whose pi curve is half of it (a copy of
    ``tests/test_coverage_extra.py``'s writer)."""
    dtheta_urad = np.linspace(-span_urad, span_urad, 1201)
    sigma_fwhm_urad = fwhm * 1e6
    s = np.exp(-0.5 * (dtheta_urad / (sigma_fwhm_urad / 2.3548200450309493)) ** 2)
    p = 0.5 * s
    cols = np.stack([dtheta_urad, dtheta_urad, np.zeros_like(s), np.zeros_like(s),
                     np.zeros_like(s), p, s], axis=-1)
    with open(path, "w") as fh:
        fh.write("#F diff_pat.dat\n#S 1 synthetic rocking curve\n#N 7\n")
        np.savetxt(fh, cols)


def xop_table(fwhm, span_urad=300.0) -> str:
    """The path of a synthetic XOP table, written under build/ (git-ignored)."""
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, f"diff_pat_{fwhm:.6g}_{span_urad:g}.dat")
    write_xop_file(path, fwhm, span_urad)
    return path


def to_file_crystal(crystal, xop, mix):
    crystal.update(rocking_type="file", rocking_fwhm=None, rocking_file=xop,
                   rocking_filetype="xop", rocking_mix=mix)


def file_crystal_config(intensity, num_iter, engine_kind, mix=0.7):
    """The flagship with its crystal's gaussian curve (48.07 urad) as an XOP
    table, sigma and pi mixed by ``mix`` (``tests/test_fused_engine.py:528-550``)."""
    cfg = flagship(intensity, num_iter, engine=engine_kind)
    to_file_crystal(cfg["optics"]["crystal"], xop_table(48.070e-6), mix)
    return cfg


def file_rocking_config():
    """``tests/test_fused_grad.py``'s ``file_rocking`` variant: its
    ``step_rocking`` chain with the crystal's curve a table of 1.5 mrad over
    +-4 mrad (the variant's own table)."""
    cfg = variant_config("step_rocking")
    to_file_crystal(cfg["optics"]["crystal"], xop_table(1.5e-3, 4000.0), 0.5)
    return cfg


def mirror_configs(intensity, num_iter, engine_kind) -> dict:
    """Mirror chains of ``tests/test_fused_engine.py``: the plane fold onto
    a step-rocking flat crystal (:129-165), convex toroidal crystals without
    their Bragg check (:589-608), the convex cylindrical mirror of
    ``tests/test_fused_grad.py``, and the flagship whose crystal skips its
    Bragg check."""
    general = {"number_of_iter": num_iter, "random_seed": 0, "keep_history": False,
               "print_results": False, "engine": engine_kind}
    fold = {
        "general": dict(general),
        "sources": {"source": {"class_name": "XicsrtSourceDirected", "intensity": intensity,
                               "wavelength": 3.9492, "angular_dist": "isotropic",
                               "spread": math.radians(5.0)}},
        "optics": {
            "mirror": {"class_name": "XicsrtOpticPlanarMirror", "origin": [0.0, 0.0, 0.5],
                       "zaxis": [0.0, 0.3826834, -0.9238795], "xsize": 0.5, "ysize": 0.5},
            "crystal": {"class_name": "XicsrtOpticPlanarCrystal",
                        "origin": [0.0, 0.21213203, 0.28786797], "zaxis": [0.0, -1.0, 0.0],
                        "xsize": 0.5, "ysize": 0.5,
                        "crystal_spacing": 3.9492 / (2.0 * math.sin(math.pi / 4)),
                        "rocking_type": "step", "rocking_fwhm": 5e-3}}}
    torus = {
        "general": dict(general),
        "sources": {"source": {"class_name": "XicsrtSourceDirected", "intensity": intensity,
                               "wavelength": 3.9492, "angular_dist": "isotropic",
                               "spread": math.radians(3.0)}},
        "optics": {"crystal": {"class_name": "XicsrtOpticToroidalCrystal",
                               "origin": [0.0, 0.0, 0.5], "zaxis": [0.0, 0.0, -1.0],
                               "xsize": 0.15, "ysize": 0.15, "radius_major": 1.0,
                               "radius_minor": 0.5, "convex": [True, True],
                               "check_bragg": False, "crystal_spacing": 2.45676}}}
    cylinder = variant_config("convex_cylinder_mirror")
    cylinder["general"].update(general, interact_mode="mc", image_mode="nearest")
    cylinder["sources"]["source"]["intensity"] = intensity
    no_check = flagship(intensity, num_iter, engine=engine_kind)
    no_check["optics"]["crystal"]["check_bragg"] = False
    return {"plane_fold": fold, "torus_no_check": torus, "convex_cylinder_mirror": cylinder,
            "flagship_no_check": no_check}


MESH_CRYSTALS = {
    "mesh_sphere": ("XicsrtOpticMeshSphericalCrystal",
                    {"radius": 1.0, "mesh_size": (41, 41), "mesh_coarse_size": (11, 11)}),
    "mesh_cylinder": ("XicsrtOpticMeshCylindricalCrystal",
                      {"radius": 1.0, "mesh_size": (41, 41), "mesh_coarse_size": (11, 11)}),
    "mesh_torus": ("XicsrtOpticMeshToroidalCrystal",
                   {"radius_major": 1.0, "radius_minor": 0.64, "mesh_size": (41, 41),
                    "mesh_coarse_size": (11, 11), "rocking_fwhm": 2e-3}),
}
# The analytic shape each mesh crystal samples, on the same pose and curve.
ANALYTIC_CRYSTALS = {
    "mesh_sphere": ("XicsrtOpticSphericalCrystal", {"radius": 1.0}),
    "mesh_cylinder": ("XicsrtOpticCylindricalCrystal", {"radius": 1.0}),
    "mesh_torus": ("XicsrtOpticToroidalCrystal",
                   {"radius_major": 1.0, "radius_minor": 0.64, "rocking_fwhm": 2e-3}),
}


def mesh_config(intensity, num_iter, engine_kind, cls, **kw):
    """``tests/test_fused_engine.py``'s mesh spectrometer (:772-795): an
    isotropic_xy point source, a crystal of class ``cls`` on the flagship's
    pose (150 urad gaussian curve) and the flagship's detector."""
    crystal = {"class_name": cls, "origin": [0.0, 0.0, 0.80374151],
               "zaxis": [0.0, 0.59497864, -0.80374151], "xsize": 0.2, "ysize": 0.2,
               "crystal_spacing": 2.45676, "rocking_type": "gaussian",
               "rocking_fwhm": 150e-6}
    crystal.update(kw)
    return {
        "general": {"number_of_iter": num_iter, "random_seed": 0, "keep_history": False,
                    "print_results": False, "engine": engine_kind},
        "sources": {"source": {"class_name": "XicsrtSourceDirected", "intensity": intensity,
                               "wavelength": 3.9492, "angular_dist": "isotropic_xy",
                               "spread": math.radians(10.0)}},
        "optics": {"crystal": crystal,
                   "detector": {"class_name": "XicsrtOpticDetector",
                                "origin": [0.0, 0.76871290, 0.56904832],
                                "zaxis": [0.0, -0.95641806, 0.29200084],
                                "xsize": 0.4, "ysize": 0.2}}}


CHEB_DEGREES = (4, 6, 8, 10, 12)


def cheb_degree_config(deg, intensity, num_iter=1, engine_kind="fused"):
    """``mesh_config``'s spectrometer with a 41 x 41 mesh crystal, in its
    local frame, whose Chebyshev fit takes degree ``deg``: the unit sphere
    plus 1e-6 T_deg(u) (u = x / 0.1), which no lower degree reproduces to
    the fit's 1e-6 of the span; vertex normals from the height field's
    gradient."""
    from numpy.polynomial import chebyshev as ncheb

    from xicsrt_tpu_torch.optics.mesh_shapes import grid_faces

    n = 41
    xg, yg = np.meshgrid(np.linspace(-0.1, 0.1, n), np.linspace(-0.1, 0.1, n),
                         indexing="ij")
    coef = np.zeros(deg + 1)
    coef[deg] = 1e-6 if deg > 4 else 0.0
    root = np.sqrt(1.0 - xg**2 - yg**2)
    z = 1.0 - root + ncheb.chebval(xg / 0.1, coef)
    zx = xg / root + ncheb.chebval(xg / 0.1, ncheb.chebder(coef)) / 0.1
    zy = yg / root
    normals = np.stack([-zx, -zy, np.ones_like(zx)], axis=-1)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return mesh_config(intensity, num_iter, engine_kind, "XicsrtOpticMeshCrystal",
                       mesh_points=np.stack([xg, yg, z], axis=-1).reshape(-1, 3),
                       mesh_normals=normals.reshape(-1, 3), mesh_faces=grid_faces(n, n),
                       mesh_interpolate=True, trace_local=True)


def mesh_plasma_config():
    """The mesh crystal behind a cubic plasma (``tests/test_fused_engine.py:
    854-880``, ``test_mesh_with_plasma_hybrid``)."""
    cls, kw = MESH_CRYSTALS["mesh_sphere"]
    cfg = mesh_config(0, 1, "fused", cls, **dict(kw, rocking_fwhm=2e-3))
    cfg["sources"] = {"plasma": {
        "class_name": "XicsrtPlasmaCubic", "origin": [0.0, 0.0, 0.0],
        "xsize": 0.02, "ysize": 0.02, "zsize": 0.02, "target": [0.0, 0.0, 0.80374151],
        "spread": math.radians(10.0), "emissivity": 2e14, "temperature": 500.0,
        "mass_number": 40.0, "wavelength": 3.9492, "time_resolution": 1e-3,
        "bundle_volume": 1e-6, "bundle_count": 100, "use_poisson": True}}
    return cfg


def mesh_golden_config(engine_kind, intensity, num_iter):
    """``tests/test_reference_parity_families.py``'s ``mesh_sphere``
    scenario (its ``_config``), ``intensity`` rays per iteration."""
    crystal = {"class_name": "XicsrtOpticMeshSphericalCrystal", "radius": 1.0,
               "mesh_size": (21, 21), "mesh_coarse_size": (7, 7)}
    cfg = repo_function("tests/test_reference_parity_families.py", "_config")(
        crystal, intensity=intensity, num_iter=num_iter)
    cfg["general"]["engine"] = engine_kind
    return cfg


def twin_equal(kernel, plain, label, fparams=None) -> float:
    """Counts and images of a kernel and its twin, equal to the ray. Returns
    the largest count or pixel difference measured.

    In weight mode or with bilinear images (``fparams`` says) a pixel sums
    float32 terms, equal in kernel and twin, in an order the kernel's
    atomics choose, so each pixel is held to the bound of that order alone.
    The twin (``terms=True``, its third output) gives each pixel's number
    of terms k and the sum S of their magnitudes. A float32 sum of k terms
    in any order lies within g(k - 1) S of the exact sum, g(j) = j u / (1 -
    j u), u = 2^-24, so two orders differ by at most 2 g(k - 1) S. The
    kernels' float ``atomicAdd`` also flushes subnormal inputs and results
    to zero (PTX ``atom.add.f32``), the twin does not: at most k terms and
    k - 1 sums, each moving the pixel by less than 2^-126, so the bound
    adds k 2^-124, twice that, for the rounding of the flushed sums. A
    pixel of one normal term or none is exact. Counts stay exact."""
    (ck, ik), (cp, iq, *tally) = kernel, plain
    torch.cuda.synchronize()
    count_err = (ck.double() - cp.double()).abs().max().item()
    diff = (ik.double() - iq.double()).abs()
    err = max(count_err, diff.max().item())
    summed = fparams is not None and (fparams.weight or fparams.bilinear)
    if summed:
        if not tally:
            raise ValueError(f"{label}: the twin must count its terms (terms=True)")
        k, mag = tally[0]
        j = (k - 1.0).clamp_min(0.0) * 2.0**-24
        bound_pix = 2.0 * j / (1.0 - j) * mag + k * 2.0**-124
        over = int((diff > bound_pix).sum().item())
        ratio = diff / bound_pix.clamp_min(1e-300)
        worst = int(ratio.argmax().item())
        used = ratio[worst].item() if over == 0 else float("inf")
        # The earlier whole-run bound, 2 m 2^-24 |pixel| with m four times
        # the largest element count, printed for comparison only.
        m = 4 * int(cp[1:].max().item())
        used_run = (diff / (2.0 * m * 2.0**-24 * iq.double().abs()).clamp_min(1e-30)).max()
        log(f"{label}: kernel counts {ck.tolist()}, twin {cp.tolist()}; image L1 diff "
            f"{diff.sum().item():.4g}, largest pixel difference {diff.max().item():.4g}, "
            f"{used:.3g} of the per-pixel summation-order bound 2 g(k - 1) S + k 2^-124 "
            f"({over} pixels over it; worst pixel: k = {int(k[worst].item())}, S = "
            f"{mag[worst].item():.6g}, twin {iq[worst].item():.6g}, difference "
            f"{diff[worst].item():.4g}); "
            f"{used_run.item():.3g} of the whole-run bound 2 m 2^-24 |pixel| (m = {m})")
        ok = count_err == 0.0 and torch.equal(ck, cp) and used <= 1.0
    else:
        log(f"{label}: kernel counts {ck.tolist()}, twin {cp.tolist()}; image L1 diff "
            f"{diff.sum().item():.0f}, largest difference {err} (tolerance 0)")
        ok = err == 0.0 and torch.equal(ck, cp) and torch.equal(ik, iq)
    if not ok:
        raise AssertionError(f"{label}: the kernel differs from its twin")
    if cp[-1].item() <= 0:
        raise AssertionError(f"{label}: no rays reach the last element")
    return err


def k1_k3_against_twins(ft, engine, cfg, label, seed, alternate=False) -> float:
    """K1 on ``cfg``'s own rays and K3 on one eager iteration's, each
    against its twin in both RNG modes; ``alternate``: K3's odd rays dead,
    so every warp is half dead. Returns the largest difference."""
    pipe = engine.Pipeline(cfg, device="cuda")
    fparams = k1_pack(pipe)
    n = pipe.num_rays
    gen = torch.Generator(device="cuda").manual_seed(seed)
    uniforms = torch.rand((fparams.n_draws, n), generator=gen, device="cuda")
    err = 0.0
    for rng, kwargs in (("input", {"uniforms": uniforms}), ("hw", {"seed": (seed, 3)})):
        err = max(err, twin_equal(ft.fused_run_cuda(fparams, n, n, **kwargs),
                                  ft.fused_run_plain(fparams, n, n, **kwargs, terms=True),
                                  f"{label} K1 rng={rng} ({n} rays)", fparams))
    k3p = k3_pack(ft, pipe)
    rays = eager_rays(pipe, seed)
    if alternate:
        rays.mask[1::2] = False
    m = rays.mask.shape[0]
    uniforms = torch.rand((k3p.n_draws, m), generator=gen, device="cuda")
    args = (k3p, rays.origin, rays.direction, rays.wavelength, rays.mask)
    weight = {"weight": rays.weight} if k3p.weight else {}
    for rng, kwargs in (("input", {"uniforms": uniforms}), ("hw", {"seed": (seed, 5)})):
        err = max(err, twin_equal(ft.fused_trace_run_cuda(*args, **kwargs, **weight),
                                  ft.fused_trace_run_plain(*args, **kwargs, **weight,
                                                           terms=True),
                                  f"{label} K3 rng={rng} ({m} rays)", k3p))
    return err


def elements_agree(fused, eager, label, names=("fused", "eager")):
    """Every element's fraction of the source within 5 binomial sigma
    between two runs (by default the engines; ``names`` label them), images
    summing to counts. Returns both metas."""
    metas = [{k: v["num_out"] for k, v in r["total"]["meta"].items()} for r in (fused, eager)]
    for meta, res in zip(metas, (fused, eager)):
        for name, img in res["total"]["image"].items():
            if not (np.isfinite(img).all() and int(img.sum()) == meta[name]):
                raise AssertionError(f"{label}: image {name} does not sum to its count")
    source, *elements = list(metas[0])
    for name in elements:
        p = [m[name] / m[source] for m in metas]
        pooled = sum(m[name] for m in metas) / sum(m[source] for m in metas)
        sigma = math.sqrt(max(pooled * (1 - pooled), 1e-30)
                          * sum(1 / m[source] for m in metas))
        log(f"{label}: {name} {names[0]} {metas[0][name]}, {names[1]} {metas[1][name]} of "
            f"{metas[0][source]} and {metas[1][source]}; {abs(p[0] - p[1]) / sigma:.2f} "
            f"binomial sigma (< 5)")
        if abs(p[0] - p[1]) > 5 * sigma or metas[0][name] <= 0:
            raise AssertionError(f"{label}: {names[0]} and {names[1]} disagree on {name}")
    return metas


def k1_timing(ft, fparams, n, smi, label, phase="31", ops=None) -> dict:
    """K1's ms per ``n`` rays (Philox) on the packed chain, its twin's and
    its bound: over ``ops``, the run's float32 operations, where a caller
    counts them (a mosaic's layers), else :func:`k1_bounds` (``bound``
    over the rays alive into each optic, ``bound_flat`` beside it)."""
    ms = cuda_ms(lambda: ft.fused_run_cuda(fparams, n, n, seed=(1, 2)), 20)
    plain_ms = cuda_ms(lambda: ft.fused_run_plain(fparams, n, n, seed=(1, 2)), 2)
    if ops is None:
        b, flat = k1_bounds(fparams, n)
    else:
        b = bound(packed_bytes(fparams.fp, fparams.ip, fparams.aux) + fparams.img_total * 4
                  + 8 * (1 + fparams.n_optics), ops)
        flat = None
    log(f"phase {phase} timings on {smi}: {label} {ms:.4f} ms vs twin {plain_ms:.4f} ms "
        f"({n} rays, Philox); bound {b[0]:.4f} ms ({b[1]}"
        + (f", {ops / n:.1f} operations per ray)" if flat is None else
           f", the rays alive into each optic; flat {flat[0]:.4f} ms)"))
    return {"ms": ms, "plain_ms": plain_ms, "bound": b, "bound_flat": flat}


# The build of K1 each of phase 27's mirror chains takes: a window of its
# images staged (FusedParams.stage_window) where no torus is in the chain,
# the dense build for planes and spheres (FusedParams.dense_images), the
# cylinder's build for a cylinder; the torus chain the general build.
MIRROR_BUILDS = {"plane_fold": "fused_trace_dense_kernel",
                 "torus_no_check": "fused_trace_kernel<point, kStages 0>",
                 "convex_cylinder_mirror": "fused_trace_cylinder_kernel<0>",
                 "flagship_no_check": "fused_trace_dense_kernel"}


def phase_mirrors(ft, engine, raytrace) -> tuple:
    """Phase 27: the build of K1 each of four mirror chains takes
    (``MIRROR_BUILDS``, or the phase fails), and K1 and K3 with mirrors
    against their twins on them at 2^20 rays; then the fold and the
    flagship without its Bragg check through ``raytrace`` on both engines
    at 2^22 x 4 (K1 counted around the fused runs). Returns K1's launches
    and the largest difference from the twins."""
    err = 0.0
    for k, (name, cfg) in enumerate(mirror_configs(1 << 20, 1, "fused").items()):
        build = k1_build_name(k1_pack(engine.Pipeline(cfg, device="cuda")))
        log(f"phase 27 {name}: the launcher picks {build} ({MIRROR_BUILDS[name]} wanted)")
        if build != MIRROR_BUILDS[name]:
            raise AssertionError(f"phase 27: {name} takes {build}")
        err = max(err, k1_k3_against_twins(ft, engine, cfg, f"phase 27 {name}", 270 + k))
    n, iters = 1 << 22, 4
    launches = 0
    for name in ("plane_fold", "flagship_no_check"):
        ft.fused_run_cuda.launches = 0
        fused = raytrace(mirror_configs(n, iters, "fused")[name], device="cuda")
        launches += ft.fused_run_cuda.launches
        eager = raytrace(mirror_configs(n, iters, "xla")[name], device="cuda")
        elements_agree(fused, eager, f"phase 27 {name} through raytrace")
    if launches <= 0:
        raise AssertionError("phase 27: the mirror chains did not launch K1")
    return launches, err


def phase_file(ft, engine, raytrace) -> tuple:
    """Phase 28: K1 and K3 with the flagship's file crystal (mix 0.7)
    against their twins at 2^20 rays; the two engines at 2^22 x 4 (K1
    counted around the fused run); the pure-sigma table against the
    gaussian crystal whose curve it tabulates. Returns K1's launches and the
    largest difference from the twins."""
    err = k1_k3_against_twins(ft, engine, file_crystal_config(1 << 20, 1, "fused"),
                              "phase 28 file crystal", 28)
    n, iters = 1 << 22, 4
    ft.fused_run_cuda.launches = 0
    fused = raytrace(file_crystal_config(n, iters, "fused"), device="cuda")
    launches = ft.fused_run_cuda.launches
    if launches <= 0:
        raise AssertionError("phase 28: the file crystal did not launch K1")
    eager = raytrace(file_crystal_config(n, iters, "xla"), device="cuda")
    engines_agree(fused, eager, "phase 28 file crystal (mix 0.7)", n * iters)
    counts = {}
    for label, cfg in (("gaussian", flagship(n, iters, engine="fused")),
                       ("sigma table", file_crystal_config(n, iters, "fused", mix=1.0))):
        counts[label] = raytrace(cfg, device="cuda")["total"]["meta"]["detector"]["num_out"]
    dev = abs(counts["gaussian"] - counts["sigma table"]) / math.sqrt(counts["gaussian"])
    log(f"phase 28 pure-sigma table against the gaussian crystal, {n * iters} rays each: "
        f"detected {counts}, {dev:.2f} sqrt(N) apart (< 6)")
    if dev > 6:
        raise AssertionError("phase 28: the sigma table detects unlike the gaussian")
    return launches, err


def phase_k5_file(smi, fg, engine, make_fused_differentiable) -> dict:
    """Phase 29: K5f and K5b on ``file_rocking`` at 2^22 rays against their
    float32 and float64 twins (phase 19's bounds); then
    ``make_fused_differentiable`` on it at 2^22 rays (counted around it)
    and the kernels' times there."""
    n = 1 << 22
    worst_f, worst_b = phase_k5_variants(fg, engine, ("file_rocking",), "29", n=n)
    fg.fused_grad_forward_cuda.launches = 0
    fg.fused_grad_vjp_cuda.launches = 0
    forward, vjp, pack, pipe = make_fused_differentiable(grad_variant("file_rocking", n),
                                                         device="cuda")
    pvec = pack(pipe.params).detach()
    out = forward(pvec, 29)["image"]
    gvec = vjp(pvec, 29, out)
    torch.cuda.synchronize()
    launches = (fg.fused_grad_forward_cuda.launches, fg.fused_grad_vjp_cuda.launches)
    if min(launches) <= 0:
        raise AssertionError("phase 29: the gradient path did not launch K5f and K5b")
    if not (all(torch.isfinite(v).all() and v.sum() > 0 for v in out.values())
            and torch.isfinite(gvec).all() and gvec.abs().max() > 0):
        raise AssertionError("phase 29: bad images or gradient")
    _, _, _, spec = fg.build_fused_diff(pipe, num_iter=1)
    st, lam = spec["static"], spec["lam"]
    g = torch.randn(st.img_total, device="cuda")
    f_ms = cuda_ms(lambda: fg.fused_grad_forward_cuda(st, pvec, n, lam, seed=(1, 2)), 20)
    f_plain = cuda_ms(lambda: fg.fused_grad_forward_plain(st, pvec, n, lam, seed=(1, 2),
                                                          chunk=n), 2)
    b_ms = cuda_ms(lambda: fg.fused_grad_vjp_cuda(st, pvec, n, lam, g, seed=(1, 2)), 20)
    b_plain = cuda_ms(lambda: fg.fused_grad_vjp_plain(st, pvec, n, lam, g, seed=(1, 2),
                                                      chunk=n), 2)
    k5_bytes = packed_bytes(st.fp, st.ip, st.aux, pvec) + st.img_total * 4
    f_bound = bound(k5_bytes, k5_ops(st, False) * n)
    b_bound = bound(k5_bytes + pvec.numel() * 4, k5_ops(st, True) * n)
    log(f"phase 31 timings on {smi}: file_rocking per {n} rays K5f {f_ms:.4f} ms (twin "
        f"{f_plain:.3f} ms, bound {f_bound[0]:.4f} ms by {f_bound[1]}), K5b {b_ms:.4f} ms "
        f"(twin {b_plain:.3f} ms, bound {b_bound[0]:.4f} ms by {b_bound[1]}); launches "
        f"K5f {launches[0]}, K5b {launches[1]}")
    return {"f_launches": launches[0], "b_launches": launches[1], "f_err": worst_f,
            "b_err": worst_b, "f_ms": f_ms, "f_plain": f_plain, "b_ms": b_ms,
            "b_plain": b_plain, "f_bound": f_bound, "b_bound": b_bound}


def phase_meshes(ft, engine, raytrace) -> tuple:
    """Phase 30: example 06 as written on both of its engines; the three
    mesh crystals at 2^24 x 4 fused, each against the analytic shape it
    samples, and 2^22 x 2 eager (the sphere's engines held to each other on
    the analytic sphere); the ``mesh_sphere`` golden on both engines;
    K1 and K3 with the Chebyshev stage against their twins at 2^20 rays,
    and K3 behind a plasma. Returns K1's launches on the mesh chains and
    the largest difference from the twins."""
    launches = 0
    cfg = example_config("example_06_fused_engine.py")
    res = {}
    for kind in ("xla", "auto"):
        c = copy.deepcopy(cfg)
        c["general"].update(engine=kind, print_results=False)
        ft.fused_run_cuda.launches = 0
        res[kind] = raytrace(c, device="cuda")
        launches += ft.fused_run_cuda.launches if kind == "auto" else 0
        meta = {k: v["num_out"] for k, v in res[kind]["total"]["meta"].items()}
        log(f"phase 30 example 06 engine={kind}: generated {meta['source']}, detected "
            f"{meta['detector']}")
    if launches <= 0:
        raise AssertionError("phase 30: example 06 on engine='auto' did not launch K1")
    engines_agree(res["auto"], res["xla"], "phase 30 example 06", 2 * int(1e5))

    for name, (cls, kw) in MESH_CRYSTALS.items():
        a_cls, a_kw = ANALYTIC_CRYSTALS[name]
        ft.fused_run_cuda.launches = 0
        fused = raytrace(mesh_config(1 << 24, 4, "fused", cls, **kw), device="cuda")
        launches += ft.fused_run_cuda.launches
        analytic = raytrace(mesh_config(1 << 24, 4, "fused", a_cls, **a_kw), device="cuda")
        elements_agree(fused, analytic, f"phase 30 {name}, fused: the surrogate against "
                       f"{a_cls}", ("mesh", "analytic"))
        eager = raytrace(mesh_config(1 << 22, 2, "xla", cls, **kw), device="cuda")
        if name != "mesh_sphere":
            elements_agree(fused, eager, f"phase 30 {name}")
            continue
        # The sphere's exact triangles interpolate the vertex normals
        # linearly, about 3 urad off the sphere's, and this focusing
        # geometry turns that into a few per cent more crystal hits than
        # the smooth sphere, on JAX's XLA engine as on the port's
        # (tests/test_torch_mesh.py). So the engines are held to each other
        # on the analytic sphere, and the eager mesh to the golden below.
        eager_analytic = raytrace(mesh_config(1 << 22, 2, "xla", a_cls, **a_kw), device="cuda")
        elements_agree(fused, eager_analytic, f"phase 30 {name}: fused mesh against the eager "
                       f"{a_cls}", ("fused mesh", "eager analytic"))
        em, ea = (r["total"]["meta"]["crystal"]["num_out"] for r in (eager, eager_analytic))
        log(f"phase 30 {name}, eager: exact triangles {em} against the analytic sphere's {ea} "
            f"on the same rays, {em / ea - 1:+.4f} (the mesh's faceting)")
    # The golden is the reference's 21 x 21 triangles under a 48 urad curve,
    # whose faceting adds about 15 % to the smooth sphere's crystal hits:
    # the eager engine's triangles are held to all of it, the fused
    # surrogate to its image and, for the fractions, to the analytic
    # sphere on the same rays.
    for kind, n, iters in (("fused", 1 << 22, 4), ("xla", 1 << 20, 4)):
        ft.fused_run_cuda.launches = 0
        result = raytrace(mesh_golden_config(kind, n, iters), device="cuda")
        launches += ft.fused_run_cuda.launches
        golden_check(result, "mesh_sphere",
                     f"phase 30 mesh_sphere golden, engine {kind}, {n * iters} rays",
                     fractions=kind == "xla")
        if kind == "fused":
            cfg = mesh_golden_config(kind, n, iters)
            crystal = cfg["optics"]["crystal"]
            for key in [k for k in crystal if k.startswith("mesh")]:
                del crystal[key]
            crystal["class_name"] = "XicsrtOpticSphericalCrystal"
            elements_agree(result, raytrace(cfg, device="cuda"),
                           "phase 30 mesh_sphere golden's config, fused", ("mesh", "analytic"))
    err = 0.0
    for k, (name, (cls, kw)) in enumerate(MESH_CRYSTALS.items()):
        err = max(err, k1_k3_against_twins(ft, engine,
                                           mesh_config(1 << 20, 1, "fused", cls, **kw),
                                           f"phase 30 {name}", 300 + k))
    pipe = engine.Pipeline(mesh_plasma_config(), device="cuda")
    k3p = k3_pack(ft, pipe)
    for seed in (30, 31):
        rays = eager_rays(pipe, seed)
        args = (k3p, rays.origin, rays.direction, rays.wavelength, rays.mask)
        err = max(err, twin_equal(
            ft.fused_trace_run_cuda(*args, seed=(seed, 1)),
            ft.fused_trace_run_plain(*args, seed=(seed, 1)),
            f"phase 30 K3 mesh behind a plasma ({rays.mask.shape[0]} rays)"))
    return launches, err


# ---------------------------------------------------------------------------
# Phases 32-38: mosaic crystals (K1c-mosaic, K5d), weight mode and bilinear
# images (K1d) in K1, K3 and K5.
# ---------------------------------------------------------------------------

def mosaic15_config(intensity, num_iter, engine_kind, **general):
    """``mosaic15`` of the scenario configs: the Directed point source
    (isotropic_xy, 10 deg), a spherical mosaic crystal (R = 1 m, 0.05 deg
    crystallite spread, depth 15, 150 urad gaussian curve) and the
    flagship's detector."""
    crystal = BS._crystal(
        class_name="XicsrtOpticSphericalMosaicCrystal", radius=1.0,
        mosaic_spread=np.radians(0.05), mosaic_depth=15, rocking_fwhm=150e-6)
    return BS._config(crystal, intensity, num_iter, engine=engine_kind, **general)


def mosaic_case_config(depth, cutoff, mode, intensity, engine_kind="fused"):
    """``mosaic15`` at another depth, with or without a cutoff (1e-4), in mc
    or weight mode, behind an aperture that keeps the rays of x >= 0 (about
    half of them), so a warp enters the layers with lanes dead at random."""
    cfg = mosaic15_config(intensity, 1, engine_kind, interact_mode=mode)
    cfg["optics"]["crystal"]["mosaic_depth"] = depth
    if cutoff:
        cfg["optics"]["crystal"]["mosaic_cutoff"] = 1e-4
    half = {"class_name": "XicsrtOpticAperture", "origin": [0.0, 0.0, 0.4],
            "zaxis": [0.0, 0.0, -1.0],
            "aperture": [{"shape": "rectangle", "size": [0.1, 0.2], "origin": [0.05, 0.0],
                          "logic": "and"}]}
    cfg["optics"] = {"aperture": half, **cfg["optics"]}
    return cfg


def mesh_mosaic_config(intensity, num_iter, engine_kind, **general):
    """A mesh mosaic crystal: the 41 x 41 sphere mesh of phase 30 as explicit
    local points, faces and normals, under ``mosaic15``'s mosaic."""
    from xicsrt_tpu_torch import engine

    cls, kw = MESH_CRYSTALS["mesh_sphere"]
    sphere = engine.Pipeline(mesh_config(16, 1, engine_kind, cls, **kw),
                             device="cpu").optics[0].param
    cfg = mosaic15_config(intensity, num_iter, engine_kind, **general)
    crystal = cfg["optics"]["crystal"]
    del crystal["radius"]
    crystal.update(class_name="XicsrtOpticMeshMosaicCrystal",
                   mesh_points=np.asarray(sphere["mesh_points"]),
                   mesh_faces=np.asarray(sphere["mesh_faces"]),
                   mesh_normals=np.asarray(sphere["mesh_normals"]),
                   mesh_interpolate=True, trace_local=sphere["trace_local"])
    return cfg


def mosaic_golden_config(engine_kind, intensity, num_iter):
    """``tests/test_reference_parity_families.py``'s ``mosaic`` scenario (its
    ``_config``), ``intensity`` rays per iteration."""
    crystal = {"class_name": "XicsrtOpticSphericalMosaicCrystal", "radius": 1.0,
               "mosaic_spread": np.radians(0.05), "mosaic_depth": 15,
               "rocking_fwhm": 150e-6}
    cfg = repo_function("tests/test_reference_parity_families.py", "_config")(
        crystal, intensity=intensity, num_iter=num_iter)
    cfg["general"]["engine"] = engine_kind
    return cfg


def timed_raytrace(raytrace, cfg, counter):
    """One ``raytrace`` on the card with ``counter``'s launches set to 0
    just before it: (result, seconds, launches)."""
    counter.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = raytrace(copy.deepcopy(cfg), device="cuda")
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, counter.launches


def metas_of(res):
    return {k: v["num_out"] for k, v in res["total"]["meta"].items()}


def weighted_agree(a, b, label, name="detector"):
    """Two weighted image sums per generated ray within 5 sigma, each sum's
    variance taken as the sum itself (the weights are at most 1): the
    criterion 5 sqrt(sf + sx) of ``tests/test_fused_engine.py:1005-1017``
    for two budgets. ``a``, ``b``: (weighted sum, rays generated). Returns
    the distance in sigma."""
    (sa, na), (sb, nb) = a, b
    dev = abs(sa / na - sb / nb) / math.sqrt(sa / na**2 + sb / nb**2)
    log(f"{label}: {name} {sa / na:.6g} against {sb / nb:.6g} per ray ({sa:.6g} of {na}, "
        f"{sb:.6g} of {nb}); {dev:.2f} sigma (< 5)")
    if not (dev < 5.0 and sa > 0 and sb > 0):
        raise AssertionError(f"{label}: the {name} sums disagree")
    return dev


def phase_mosaic15(ft, raytrace) -> dict:
    """Phases 32-33: ``mosaic15`` through ``raytrace(config,
    device='cuda')`` on ``engine='fused'`` at 2^26 x 4 rays and on the eager
    engine at 2^22 x 4, in mc and in weight mode. Each run is made twice:
    the first builds and warms, the second is checked, timed for its rays/s
    and counted (K1 once on the fused engine, all four iterations in one
    launch, and never on the eager one)."""
    out = {}
    budgets = {"fused": (1 << 26) * 4, "xla": (1 << 22) * 4}
    for mode in ("mc", "weight"):
        phase = 32 if mode == "mc" else 33
        res = {}
        for kind, (n, iters) in (("fused", (1 << 26, 4)), ("xla", (1 << 22, 4))):
            cfg = mosaic15_config(n, iters, kind, interact_mode=mode)
            timed_raytrace(raytrace, cfg, ft.fused_run_cuda)
            r, seconds, launches = timed_raytrace(raytrace, cfg, ft.fused_run_cuda)
            if launches != int(kind == "fused"):
                raise AssertionError(f"phase {phase}: mosaic15 {mode} on {kind} launched K1 "
                                     f"{launches} times, not {int(kind == 'fused')}")
            meta = metas_of(r)
            if meta["source"] != budgets[kind]:
                raise AssertionError(f"phase {phase}: {meta['source']} rays, budget "
                                     f"{budgets[kind]}")
            for name, img in r["total"]["image"].items():
                # The source overfills the crystal, so a few of its hits lie
                # within one float32 rounding of the image's edge, and the
                # pixel coordinate fma(x, 1/ps, (n - 1) / 2) rounds them
                # onto the next pixel, off the grid (as in the JAX package):
                # an image of nearest hits sums to its count but for at most
                # 1e-6 of it.
                missing = meta[name] - float(img.astype(np.float64).sum())
                if not np.isfinite(img).all():
                    raise AssertionError(f"phase {phase}: image {name} is not finite")
                if mode == "mc" and not 0 <= missing <= 1e-6 * meta[name]:
                    raise AssertionError(f"phase {phase}: image {name} sums to "
                                         f"{meta[name] - missing} for {meta[name]} rays")
                if mode == "mc" and missing:
                    log(f"phase {phase} mosaic15 mc engine={kind}: {missing:.0f} of the "
                        f"{name}'s {meta[name]} rays rounded off the image's edge")
            log(f"phase {phase} mosaic15 {mode} engine={kind}: {meta}; "
                f"{budgets[kind] / seconds:.4g} rays/s ({seconds * 1e3:.1f} ms for "
                f"{budgets[kind]} rays); K1 launches {launches}")
            res[kind] = (r, meta, launches, budgets[kind] / seconds)
        metas = [res[k][1] for k in ("fused", "xla")]
        # In weight mode the crystal keeps every ray its bounds keep, and
        # the detector's count depends on which rays' picks underflow.
        for name in ("crystal", "detector") if mode == "mc" else ("crystal",):
            p = [m[name] / m["source"] for m in metas]
            pooled = sum(m[name] for m in metas) / sum(m["source"] for m in metas)
            sigma = math.sqrt(pooled * (1 - pooled) * sum(1 / m["source"] for m in metas))
            log(f"phase {phase} mosaic15 {mode}: {name} keeps {p[0]:.6g} fused against "
                f"{p[1]:.6g} eager, {abs(p[0] - p[1]) / sigma:.2f} binomial sigma (< 5)")
            if abs(p[0] - p[1]) > 5 * sigma or metas[0][name] <= 0:
                raise AssertionError(f"phase {phase}: the engines disagree on {name}")
        if mode == "weight":
            sums = {k: (float(res[k][0]["total"]["image"]["detector"].astype(np.float64).sum()),
                        budgets[k]) for k in ("fused", "xla")}
            weighted_agree(sums["fused"], sums["xla"], "phase 33 mosaic15 weight, fused "
                           "against eager")
            mc = out["mc"]["fused"]
            weighted_agree(sums["fused"], (float(mc[1]["detector"]), budgets["fused"]),
                           "phase 33 mosaic15, weight mode's flux against mc mode's count")
        out[mode] = res
    return out


def modes_agree(fused, eager, label, weight, bilinear, budgets):
    """``tests/test_fused_engine.py:897-942`` between the engines: the rays
    each element keeps within 5 binomial sigma (in weight mode the crystal
    keeps every ray its bounds keep), the weighted detector sums within 5
    sigma (``weighted_agree``), each image a two-sample chi-square apart
    (weights and tents are at most 1, so a pixel's variance is at most its
    sum, which the chi-square takes: it errs towards agreement), and the
    mc-mode bilinear detector image, whose spot lies inside the grid,
    summing to its count but for float32 rounding (1e-5). Returns the
    metas and the detector images' sums of both engines."""
    metas = [metas_of(r) for r in (fused, eager)]
    for name in ("aperture", "crystal", "detector"):
        p = [m[name] / m["source"] for m in metas]
        pooled = sum(m[name] for m in metas) / sum(m["source"] for m in metas)
        sigma = math.sqrt(max(pooled * (1 - pooled), 1e-30) * sum(1 / b for b in budgets))
        if abs(p[0] - p[1]) > 5 * sigma or metas[0][name] <= 0:
            raise AssertionError(f"{label}: the engines disagree on {name}")
    sums = [float(r["total"]["image"]["detector"].astype(np.float64).sum())
            for r in (fused, eager)]
    weighted_agree((sums[0], budgets[0]), (sums[1], budgets[1]), label)
    for name, img in fused["total"]["image"].items():
        chi2, dof = image_chi2(img, eager["total"]["image"][name])
        limit = dof + 5 * math.sqrt(2 * dof)
        log(f"{label}: {name} images, chi2 {chi2:.1f} on {dof} dof (< {limit:.1f})")
        if dof >= 1 and chi2 > limit:
            raise AssertionError(f"{label}: the engines' {name} images differ")
        if bilinear and not weight and name == "detector":
            total = float(img.astype(np.float64).sum())
            if abs(total - metas[0][name]) > 1e-5 * metas[0][name]:
                raise AssertionError(f"{label}: the bilinear {name} image sums "
                                     f"{total} for {metas[0][name]} rays")
    return metas, sums


WEIGHT_MODES = {"weight": {"interact_mode": "weight"},
                "bilinear": {"image_mode": "bilinear"},
                "both": {"interact_mode": "weight", "image_mode": "bilinear"}}


def phase_weight_images(ft, raytrace, mc_meta) -> dict:
    """Phase 34: the flagship in weight mode, with bilinear images, and with
    both, through ``raytrace`` on ``engine='fused'`` at 2^26 x 4 and on the
    eager engine at 2^22 x 4; weight mode's flux against phase 5's mc count.
    The fused run is made twice: the first warms, the second is checked,
    timed and counted (K1 once). Then the fused detector images' sums
    against what they must sum to, within 1e-5: the bilinear mc image's
    its count (its spot lies inside the grid); the weight mode's and
    'both''s, which weigh the same rays (no draw at the crystal) into a
    nearest and a bilinear image, each other's. Returns K1's launches per
    mode."""
    out, fused_sums = {}, {}
    budgets = ((1 << 26) * 4, (1 << 22) * 4)
    for mode, general in WEIGHT_MODES.items():
        cfg = flagship(1 << 26, 4, engine="fused", **general)
        timed_raytrace(raytrace, cfg, ft.fused_run_cuda)
        fused, seconds, launches = timed_raytrace(raytrace, cfg, ft.fused_run_cuda)
        if launches != 1:
            raise AssertionError(f"phase 34: the flagship ({mode}) launched K1 {launches} "
                                 "times, not once")
        eager = raytrace(flagship(1 << 22, 4, engine="xla", **general), device="cuda")
        metas, sums = modes_agree(fused, eager, f"phase 34 flagship {mode}",
                                  "interact_mode" in general, "image_mode" in general,
                                  budgets)
        log(f"phase 34 flagship {mode}: fused {metas[0]}, {budgets[0] / seconds:.4g} rays/s "
            f"({seconds * 1e3:.1f} ms for {budgets[0]} rays); K1 launches {launches}")
        if "interact_mode" in general:
            weighted_agree((sums[0], budgets[0]), (float(mc_meta["detector"]), budgets[0]),
                           f"phase 34 flagship {mode}: weight mode's flux against mc mode's "
                           "count")
        out[mode] = launches
        fused_sums[mode] = (sums[0], metas[0]["detector"])
    expected = {"bilinear": fused_sums["bilinear"][1], "weight": fused_sums["both"][0],
                "both": fused_sums["weight"][0]}
    rel = {mode: abs(fused_sums[mode][0] - expected[mode]) / expected[mode]
           for mode in WEIGHT_MODES}
    log("phase 34 fused detector image sums against what they must sum to (the bilinear "
        "mc image its count, weight and both each other's): " + ", ".join(
            f"{mode} {fused_sums[mode][0]!r} against {expected[mode]!r}, relative error "
            f"{rel[mode]:.3g}" for mode in WEIGHT_MODES)
        + f"; largest {max(rel.values()):.3g} (limit 1e-5)")
    if max(rel.values()) > 1e-5:
        raise AssertionError("phase 34: a detector image does not sum to what it must")
    return out


def golden_check(result, name, label, fractions=True):
    """``tests/test_reference_parity_families.py:123-187`` on the golden
    ``name`` (``mesh_sphere`` or ``mosaic``): acceptance and efficiency
    within 5 sigma (unless ``fractions`` is False: then they are only
    printed), superpixel chi2/ndof < 3, centroid within 0.75 px, the width
    within its WIDTH_RTOL (8 %, 15 %), or unresolved where the golden's
    is."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                        f"{name}_reference_image.npz")
    golden = dict(np.load(path))
    meta = metas_of(result)
    n_gen, n_ref = meta["source"], float(golden["n_generated"])
    for elem in ("crystal", "detector"):
        k, k_ref = meta[elem], float(golden[f"meta_{elem}"])
        p = (k + k_ref) / (n_gen + n_ref)
        dev = abs(k / n_gen - k_ref / n_ref) / math.sqrt(p / n_gen + p / n_ref)
        log(f"{label}: {elem} {k / n_gen:.6g} against the golden's {k_ref / n_ref:.6g} "
            f"({dev:.2f} sigma{', < 5' if fractions else ''})")
        if fractions and dev > 5:
            raise AssertionError(f"{label}: {elem} fraction off the golden")
    ref = golden["image"].astype(np.float64)
    img = result["total"]["image"]["detector"].astype(np.float64)
    R = ref.reshape(10, 10, 5, 10).sum(axis=(1, 3))
    O = img.reshape(10, 10, 5, 10).sum(axis=(1, 3))
    scale = R.sum() / O.sum()
    O = O * scale
    keep = (R + O) > 50
    chi2 = float(((O[keep] - R[keep]) ** 2 / (R[keep] + scale * O[keep])).sum() / keep.sum())
    ys = np.arange(ref.shape[1])

    def moments(prof):
        prof = prof / prof.sum()
        mu = (prof * ys).sum()
        return mu, math.sqrt((prof * (ys - mu) ** 2).sum())

    (mu_r, sd_r), (mu_o, sd_o) = moments(ref.sum(0)), moments(img.sum(0))
    rtol = {"mesh_sphere": 0.08, "mosaic": 0.15}[name]
    log(f"{label}: superpixel chi2/ndof {chi2:.3f} on {int(keep.sum())} (< 3), centroid "
        f"{mu_o:.3f} against {mu_r:.3f} px (< 0.75), width {sd_o:.3f} against {sd_r:.3f} px "
        f"(within {rtol:.0%})")
    width_ok = sd_o < 1.0 if sd_r < 1.0 else abs(sd_o - sd_r) < rtol * sd_r
    if not (keep.sum() > 0 and chi2 < 3.0 and abs(mu_o - mu_r) < 0.75 and width_ok):
        raise AssertionError(f"{label}: the image is off the golden")


def k1d_mosaic_chains(n) -> dict:
    """Phase 36's chains of ``n`` rays: ``mosaic15`` in mc and weight mode,
    with a cutoff, with a file rocking curve (mixed 0.6, the 150 urad curve
    tabulated), at depth 33 with a cutoff behind an aperture that kills
    about half the rays (``mosaic_case_config``), on a mesh; the flagship
    in weight mode, with bilinear images, with both."""
    chains = {"mosaic15 mc": mosaic15_config(n, 1, "fused"),
              "mosaic15 weight": mosaic15_config(n, 1, "fused", interact_mode="weight"),
              "mosaic15 weight bilinear": mosaic15_config(n, 1, "fused", interact_mode="weight",
                                                          image_mode="bilinear")}
    for mode in ("mc", "weight"):
        cut = mosaic15_config(n, 1, "fused", interact_mode=mode)
        cut["optics"]["crystal"]["mosaic_cutoff"] = 1e-4
        chains[f"mosaic15 cutoff {mode}"] = cut
        fc = mosaic15_config(n, 1, "fused", interact_mode=mode)
        to_file_crystal(fc["optics"]["crystal"], xop_table(150e-6), 0.6)
        chains[f"mosaic15 file {mode}"] = fc
    for mode in ("mc", "weight"):
        chains[f"mosaic depth 33 half dead cutoff {mode}"] = mosaic_case_config(33, True, mode, n)
    chains["mesh mosaic mc"] = mesh_mosaic_config(n, 1, "fused")
    chains["mesh mosaic weight"] = mesh_mosaic_config(n, 1, "fused", interact_mode="weight")
    for mode, general in WEIGHT_MODES.items():
        chains[f"flagship {mode}"] = flagship(n, 1, engine="fused", **general)
    return chains


def k1d_image_adds(general, n=1 << 17) -> list:
    """The image terms K1 adds on the flagship in the run modes ``general``
    at ``n`` rays (Philox seed (1, 2)), by its twin on the card
    (``tools/roofline.image_adds``), and how many are exactly zero, which K1
    does not issue (phase 38, beside the K1d rows)."""
    from xicsrt_tpu_torch import engine
    from xicsrt_tpu_torch.tools.roofline import image_adds

    adds = image_adds(k1_pack(engine.Pipeline(
        flagship(n, 1, engine="fused", **general), device="cuda")), n, seed=(1, 2))
    log(f"phase 38 image terms of the flagship {general}, {n} rays (the twin): "
        + "; ".join(f"optic {a['optic']}: {a['adds']} adds, {a['zero']} of them exactly "
                    f"zero (not issued), {a['subnormal']} subnormal" for a in adds))
    return adds


def phase_k1d_mosaic_twins(ft, engine) -> dict:
    """Phase 36: K1 on each chain's own rays and K3 on one eager iteration's,
    against their twins in both RNG modes at 2^20 rays: counts equal, images
    within the summation-order bound (``twin_equal``). Returns the largest
    difference per stage."""
    err = {"weight": 0.0, "bilinear": 0.0, "mosaic mc": 0.0, "mosaic weight": 0.0,
           "k3 weight": 0.0}
    for k, (name, cfg) in enumerate(k1d_mosaic_chains(1 << 20).items()):
        e = k1_k3_against_twins(ft, engine, cfg, f"phase 36 {name}", 360 + k,
                                alternate="half dead" in name)
        weight = "weight" in name or "both" in name
        if "mosaic" in name:
            err["mosaic weight" if weight else "mosaic mc"] = max(
                err["mosaic weight" if weight else "mosaic mc"], e)
        if weight:
            err["weight"] = max(err["weight"], e)
            err["k3 weight"] = max(err["k3 weight"], e)
        if "bilinear" in name or "both" in name:
            err["bilinear"] = max(err["bilinear"], e)
    return err


def phase_k5d(smi, fg, ft, engine, make_fused_differentiable) -> dict:
    """Phase 37: K5f and K5b with the mosaic stage (K5d) on
    ``tests/test_fused_grad.py``'s ``mosaic_sphere`` at 2^22 rays against
    their float32 (rtol 1e-3, atol 1e-5) and float64 (rtol 2e-2, atol
    5e-3) twins, both RNG modes; then ``make_fused_differentiable`` on it at
    2^22 rays (counted around it) and the kernels' times there."""
    n = 1 << 22
    worst_f, worst_b = phase_k5_variants(fg, engine, ("mosaic_sphere",), "37", n=n)
    cfg = grad_variant("mosaic_sphere", n)
    fg.fused_grad_forward_cuda.launches = 0
    fg.fused_grad_vjp_cuda.launches = 0
    forward, vjp, pack, pipe = make_fused_differentiable(cfg, device="cuda")
    pvec = pack(pipe.params).detach()
    out = forward(pvec, 37)["image"]
    gvec = vjp(pvec, 37, out)
    torch.cuda.synchronize()
    launches = (fg.fused_grad_forward_cuda.launches, fg.fused_grad_vjp_cuda.launches)
    if min(launches) <= 0:
        raise AssertionError("phase 37: the gradient path did not launch K5f and K5b")
    if not (all(torch.isfinite(v).all() and v.sum() > 0 for v in out.values())
            and torch.isfinite(gvec).all() and gvec.abs().max() > 0):
        raise AssertionError("phase 37: bad images or gradient")
    crystal = [o.name for o in pipe.optics].index("crystal") * fg.SLOTS_PER_OPTIC
    log(f"phase 37 mosaic_sphere gradient: d/d(crystal_spacing) {gvec[crystal + 13]:.6g}, "
        f"d/d(rocking_fwhm) {gvec[crystal + 14]:.6g}, d/d(origin) "
        f"{gvec[crystal:crystal + 3].tolist()}")
    _, _, _, spec = fg.build_fused_diff(pipe, num_iter=1)
    st, lam = spec["static"], spec["lam"]
    g = torch.randn(st.img_total, device="cuda")
    f_ms = cuda_ms(lambda: fg.fused_grad_forward_cuda(st, pvec, n, lam, seed=(1, 2)), 20)
    f_plain = cuda_ms(lambda: fg.fused_grad_forward_plain(st, pvec, n, lam, seed=(1, 2),
                                                          chunk=n), 2)
    b_ms = cuda_ms(lambda: fg.fused_grad_vjp_cuda(st, pvec, n, lam, g, seed=(1, 2)), 20)
    b_plain = cuda_ms(lambda: fg.fused_grad_vjp_plain(st, pvec, n, lam, g, seed=(1, 2),
                                                      chunk=n), 2)
    # The rays the mosaic's layers run for: K1 in weight mode on the same
    # rays (the same sampler and Philox stream), past the cutoff.
    work = mosaic_work(k1_pack(pipe), n, True)
    m = OPS_PER_RAY["mosaic_k5"]
    k5_bytes = packed_bytes(st.fp, st.ip, st.aux, pvec) + st.img_total * 4
    forward = (work["kept"] * (m["setup"] + (m["cutoff"] if work["cut"] else 0))
               + work["layers"] * m["layer"] + work["reflected"] * m["reflect"])
    f_ops = k5_ops(st, False) * n + forward
    b_ops = (k5_ops(st, True) * n + forward + work["layers"] * m["adjoint_layer"]
             + work["entering"] * m["adjoint"])
    f_bound = bound(k5_bytes, f_ops)
    b_bound = bound(k5_bytes + pvec.numel() * 4, b_ops)
    log(f"phase 38 timings on {smi}: mosaic_sphere per {n} rays K5f {f_ms:.4f} ms (twin "
        f"{f_plain:.3f} ms, bound {f_bound[0]:.4f} ms by {f_bound[1]}), K5b {b_ms:.4f} ms "
        f"(twin {b_plain:.3f} ms, bound {b_bound[0]:.4f} ms by {b_bound[1]}); "
        f"{work['entering']} rays through {work['depth']} layers; launches K5f "
        f"{launches[0]}, K5b {launches[1]}")
    return {"f_launches": launches[0], "b_launches": launches[1], "f_err": worst_f,
            "b_err": worst_b, "f_ms": f_ms, "f_plain": f_plain, "b_ms": b_ms,
            "b_plain": b_plain, "f_bound": f_bound, "b_bound": b_bound}


def mosaic_slots(work, n, weight) -> None:
    """Phase 38's lane-layer slots of the mosaic stage for the run ``work``
    counted: the rays' needed layers drawn from its distribution
    (``mosaic_needed``), scheduled a ray a lane (the parent's stage) and by
    ``xrt_mosaic``'s warp-wide rounds at groups of 4 and 8 layers
    (``mosaic_schedule``)."""
    needed = mosaic_needed(work, n)
    slots = {(g, c): mosaic_schedule(needed, work["depth"], g, weight, c)
             for g, c in ((4, 4), (2, 4), (2, 8))}
    first = slots[(4, 4)]
    log(f"phase 38 mosaic15 {'weight' if weight else 'mc'} lane-layer slots of {n} rays "
        f"(the run's distribution of needed layers): {first['layers']} layers needed; "
        f"a ray a lane {first['serial']} ({first['layers'] / first['serial']:.3f} used); "
        f"spread over the warp " + ", ".join(
            f"groups of {g} lanes, chunks of {c} layers {v['cooperative']} "
            f"({v['layers'] / v['cooperative']:.3f} used)" for (g, c), v in slots.items()))


def phase_k3_weight(smi, ft, engine, raytrace) -> dict:
    """K3 in weight mode on its own route: ``plasma_torus`` with 8e6
    bundles (past K1's 2^22) at 2^22 expected photons, in mc and in weight
    mode on ``engine='fused'`` (K3 counted around the weight run): the
    photons within 5 sigma of the expectation, weight mode's detected flux
    against mc mode's count (5 sigma); then K3 with the rays' weights on
    the flagship's 2^22 eager rays in weight mode, its time."""
    res = {}
    for mode in ("mc", "weight"):
        cfg = plasma_config(1 << 22, 1, bundle_count=8_000_000, engine="fused",
                            interact_mode=mode)
        cfg["sources"]["plasma"]["max_bundles"] = int(1e7)
        r, seconds, launches = timed_raytrace(raytrace, cfg, ft.fused_trace_run_cuda)
        meta = metas_of(r)
        expected = expected_photons(cfg)
        if abs(meta["plasma"] - expected) > 5 * math.sqrt(expected) or launches <= 0:
            raise AssertionError(f"phase 38 K3 {mode}: {meta['plasma']} photons, expected "
                                 f"{expected:.6g}; K3 launches {launches}")
        res[mode] = (r, meta, launches)
        log(f"phase 38 plasma_torus, 8e6 bundles, {mode} on K3: {meta}; K3 launches "
            f"{launches}")
    weighted_agree((float(res["weight"][0]["total"]["image"]["detector"].astype(np.float64).sum()),
                    res["weight"][1]["plasma"]),
                   (float(res["mc"][1]["detector"]), res["mc"][1]["plasma"]),
                   "phase 38 plasma_torus on K3, weight mode's flux against mc mode's count")
    n = 1 << 22
    pipe = engine.Pipeline(flagship(n, 1, engine="fused", interact_mode="weight"),
                           device="cuda")
    k3p = k3_pack(ft, pipe)
    rays = eager_rays(pipe, 38)
    args = (k3p, rays.origin, rays.direction, rays.wavelength, rays.mask)
    kw = {"seed": (1, 2), "weight": rays.weight}
    ms = cuda_ms(lambda: ft.fused_trace_run_cuda(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: ft.fused_trace_run_plain(*args, **kw), 3)
    b = bound(33 * n + packed_bytes(k3p.fp, k3p.ip) + k3p.img_total * 4
              + 8 * (1 + k3p.n_optics), chain_k1_ops(k3p) * n)
    log(f"phase 38 timings on {smi}: K3 weight mode {ms:.4f} ms vs twin {plain_ms:.4f} ms "
        f"(the flagship's {n} eager rays and their weights, Philox); bound {b[0]:.4f} ms "
        f"({b[1]})")
    census = k3_census("phase 38", flagship(1 << 14, 1, engine="fused",
                                            interact_mode="weight"), n)
    behind = {}
    for mode in ("mc", "weight"):  # K3 behind a mosaic: mosaic15's eager rays
        pipe = engine.Pipeline(mosaic15_config(n, 1, "fused", interact_mode=mode),
                               device="cuda")
        k3m = k3_pack(ft, pipe)
        rays = eager_rays(pipe, 381)
        args = (k3m, rays.origin, rays.direction, rays.wavelength, rays.mask)
        kw = {"seed": (1, 2), **({"weight": rays.weight} if k3m.weight else {})}
        behind[mode] = cuda_ms(lambda: ft.fused_trace_run_cuda(*args, **kw), 20)
    log(f"phase 38 timings on {smi}: K3 behind a mosaic (mosaic15's {n} eager rays, "
        f"Philox) mc {behind['mc']:.4f} ms, weight {behind['weight']:.4f} ms")
    return {"launches": res["weight"][2], "ms": ms, "plain_ms": plain_ms, "bound": b,
            "census": census}


# ---------------------------------------------------------------------------
# Phases 39-42: the history reservoir K1e, and the file entry point.
# ---------------------------------------------------------------------------

# The flagship's detector narrowed until about one chunk of 8192 rays in
# three keeps a ray (the spot's edge lies 14 mm off the detector's centre).
SPARSE_DETECTOR_XSIZE = 0.0288


def history_equal(kernel, plain, n_fields: int, label) -> float:
    """K1e's reservoir against its twin's: the same kept chunks and used
    count, and every recorded field equal to the bit (NaN where the other
    is NaN: a ray that misses a sphere may carry one), so the masks (field
    7 of ``n_fields``) are equal and no ray is apart. Returns the largest
    finite difference."""
    torch.cuda.synchronize()
    used = int(kernel.used)
    if not (torch.equal(kernel.chunks, plain.chunks) and used == int(plain.used)):
        raise AssertionError(f"{label}: kept chunks {kernel.chunks[:used].tolist()} "
                             f"against the twin's {plain.chunks[:int(plain.used)].tolist()}")
    a, b = kernel.slots, plain.slots
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    finite = torch.isfinite(a) & torch.isfinite(b)
    err = (a - b)[finite].abs().max().item() if bool(finite.any()) else 0.0
    masks = a[:, 7::n_fields] != b[:, 7::n_fields]
    log(f"{label}: kept chunks {kernel.chunks[:used].tolist()} ({used} of "
        f"{a.shape[0]} slots), {int((~same).sum())} of {a.numel()} recorded values "
        f"apart, {int(masks.any(dim=1).sum())} rays with a mask apart, largest "
        f"finite difference {err} (tolerance 0)")
    if not bool(same.all()):
        raise AssertionError(f"{label}: K1e differs from its twin")
    return err


def k1_direct(ft, fparams, n: int, seed, bundles=None, marks=None, chunk: int = 8192,
              pair: bool = False):
    """K1 on ``n`` rays (Philox ``seed``) into zeroed counts and images, as
    ``fused_run_cuda`` launches it, with no probe or record: the build that
    marks the chunks of ``chunk`` rays into ``marks`` (ceil(n / chunk) + 1
    int32, the last K1e's flag) where they are given
    (``xrt_fused_trace_marked``), with ``pair`` also the build without
    marks that runs where the flag is set (``xrt_fused_trace_flagged``: a
    probed 'found' run's main step); else ``xrt_fused_trace``. Returns the
    counts."""
    from xicsrt_tpu_torch.ops import native

    dev = fparams.fp.device
    cum, table, n_bundles, n_per_iter = ft._check_bundles(fparams, n, bundles, dev)
    counts = torch.zeros(1 + fparams.n_optics, dtype=torch.int64, device=dev)
    sums = torch.zeros(fparams.img_total, device=dev,
                       dtype=torch.float64 if fparams.stages >= 1 else torch.float32)
    fp, ip, aux = ft._buffers(fparams, "k1_direct")
    args = (fp.data_ptr(), fp.numel(), ip.data_ptr(), ip.numel(), aux.data_ptr(),
            aux.numel(), n, n, None, int(seed[0]), int(seed[1]),
            None if cum is None else cum.data_ptr(),
            None if table is None else table.data_ptr(), n_bundles, n_per_iter,
            counts.data_ptr(), sums.data_ptr(), fparams.img_total,
            int(fparams.full_source), int(fparams.cheb), fparams.stages, fparams.shapes,
            int(fparams.dense_images), *fparams.stage_window)
    stream = torch.cuda.current_stream().cuda_stream
    lib = native.library()
    if marks is None:
        err = lib.xrt_fused_trace(*args, stream)
    else:
        err = lib.xrt_fused_trace_marked(*args, marks.data_ptr(), chunk, stream)
        if err == 0 and pair:
            err = lib.xrt_fused_trace_flagged(*args, marks.data_ptr(), chunk, stream)
    native.check(err, "k1_direct")
    return counts


class probe_from:
    """``ft.PROBE_MIN_RAYS``, the least 'found' run that probes, set to
    ``rays`` inside a ``with`` block: 0 probes every run, ``1 << 62`` none
    (K1 marks every chunk)."""

    def __init__(self, ft, rays: int):
        self.ft, self.rays = ft, rays

    def __enter__(self):
        self.old, self.ft.PROBE_MIN_RAYS = self.ft.PROBE_MIN_RAYS, self.rays

    def __exit__(self, *exc):
        self.ft.PROBE_MIN_RAYS = self.old


def probe_against_marked(ft, fparams, n, spec, label, bundles=None, twin=True, **kwargs):
    """K1e's probe (``history_probe_cuda``) against its twin's: the same
    marks, flag, used count and windows. Then the 'found' call of
    ``fused_run_cuda`` that probes (``probe_from(ft, 0)``: the probe, then
    K1's two builds, of which the flag runs one) against the one whose K1
    marks every chunk (``probe_from(ft, 1 << 62)``): two K1 launches in the
    first, one in the second; counts equal; the same kept chunks and every
    recorded value equal (``history_equal``). With ``twin``, both calls'
    counts and images are held to the twin's (``twin_equal``) and the
    probe path's reservoir to the twin's; without it (a full-width run of
    nearest mc images, whose pixels sum whole numbers exactly), the
    images of the two calls are held equal, and the twin probes only where
    the kernel's flag is set (one window of S chunks). Returns (the probe,
    whether K1 marked: the fallback, the largest count or pixel difference
    of the probe path from the twin, or from the marked path without
    ``twin``)."""
    probe = ft.history_probe_cuda(fparams, n, n, spec, bundles=bundles, **kwargs)
    n_chunks = spec.n_chunks(n)
    flag = int(probe.marks[-1])
    fallback = probe.chunks < n_chunks and not flag
    if twin or flag:
        plain = ft.history_probe_plain(fparams, n, n, spec, bundles=bundles, **kwargs)
        if not (torch.equal(probe.marks, plain.marks) and int(probe.used) == int(plain.used)
                and probe.chunks == plain.chunks):
            raise AssertionError(f"{label}: the probe's marks differ from its twin's")
    before = ft.fused_run_cuda.launches
    with probe_from(ft, 0):
        ck, ik, hk = ft.fused_run_cuda(fparams, n, n, bundles=bundles, history=spec, **kwargs)
    launches = ft.fused_run_cuda.launches - before
    with probe_from(ft, 1 << 62):
        cm, im, hm = ft.fused_run_cuda(fparams, n, n, bundles=bundles, history=spec, **kwargs)
    launches = (launches, ft.fused_run_cuda.launches - before - launches)
    if launches != (2, 1):
        raise AssertionError(f"{label}: K1 launches of the probe path and the marked "
                             f"path {launches}, not (2, 1)")
    n_fields = 9 if fparams.weight else 8
    history_equal(hk, hm, n_fields, f"{label}, the probe path against the marked build")
    if not torch.equal(ck, cm):
        raise AssertionError(f"{label}: the probe path's counts {ck.tolist()} against the "
                             f"marked build's {cm.tolist()}")
    if twin:
        cp, iq, tally, hp = ft.fused_run_plain(fparams, n, n, bundles=bundles, terms=True,
                                               history=spec, **kwargs)
        err = twin_equal((ck, ik), (cp, iq, tally),
                         f"{label}, the probe path's counts and images", fparams)
        twin_equal((cm, im), (cp, iq, tally), f"{label}, the marked path's counts and images",
                   fparams)
        history_equal(hk, hp, n_fields, f"{label}, the probe path against the twin")
    else:
        if fparams.weight or fparams.bilinear:
            raise ValueError(f"{label}: summed images need the twin's bound")
        err = (ik.double() - im.double()).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"{label}: the probe path's image differs from the marked "
                                 f"build's by {err}")
    log(f"{label}: the probe's {len(ft.probe_windows(spec, n))} windows cover "
        f"{probe.chunks} of {n_chunks} chunks, {int((probe.marks[:-1] != 0).sum())} marked, "
        f"used {int(probe.used)} of {spec.slots}, flag {flag}: "
        f"{'K1 marks (the fallback)' if fallback else 'K1 makes no mark'}"
        f"{'' if twin or flag else '; twin not run at this width'}; K1 launches (probe "
        f"path, marked path) {launches}; the probe path's counts and images "
        f"{'against the twin' if twin else 'against the marked path'}: largest difference "
        f"{err}")
    return probe, fallback, err


def k1e_against_twin(ft, fparams, n, spec, label, bundles=None, **kwargs):
    """K1 with the reservoir ``spec`` (the marked build, then K1e) and its
    twin on the same rays: counts and images as ``twin_equal`` holds them,
    the reservoirs as ``history_equal`` does. Returns (the reservoirs'
    largest difference, the kernel's reservoir)."""
    ck, ik, hk = ft.fused_run_cuda(fparams, n, n, bundles=bundles, history=spec, **kwargs)
    cp, iq, tally, hp = ft.fused_run_plain(fparams, n, n, bundles=bundles, terms=True,
                                           history=spec, **kwargs)
    twin_equal((ck, ik), (cp, iq, tally), f"{label} counts and images", fparams)
    n_fields = 9 if fparams.weight else 8
    return history_equal(hk, hp, n_fields, f"{label} reservoir"), hk


def phase_k1e_twins(ft, engine) -> tuple:
    """Phase 39: K1e against its twin on the flagship at 2^20 rays, chunk
    8192: 'found' (8 slots) and 'sampled' (history_max_lost 10000: 2 slots)
    in mc and weight mode, both RNG modes; 'found' on ``mosaic15`` in mc and
    weight mode, both RNG modes; then 'found' on the flagship
    with its detector narrowed until about a third of the chunks keep a
    ray, so the selection skips chunks. Each 'found' run also holds the
    probe path to the marked build (``probe_against_marked``): the
    flagship's and ``mosaic15``'s first 8 chunks all keep a ray, so the
    probe finds them and K1 makes no mark; the narrowed detector's first 8
    do not, and K1 marks them (the fallback). Returns (the reservoirs'
    largest difference from the twin's, the probe path's counts' and
    images' largest difference from the twin's)."""
    n = 1 << 20
    gen = torch.Generator(device="cuda").manual_seed(39)
    err = probe_err = 0.0
    for interact in ("mc", "weight"):
        pipe = engine.Pipeline(flagship(n, 1, engine="fused", interact_mode=interact),
                               device="cuda")
        fparams = k1_pack(pipe)
        uniforms = torch.rand((fparams.n_draws, n), generator=gen, device="cuda")
        for mode, slots in (("found", 8), ("sampled", None)):
            spec = ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, slots, mode)
            for rng, kw in (("input", {"uniforms": uniforms}), ("hw", {"seed": (39, 7)})):
                e, hist = k1e_against_twin(ft, fparams, n, spec,
                                           f"phase 39 K1e {mode} {interact} rng={rng}", **kw)
                err = max(err, e)
                if hist.chunks.tolist() != list(range(spec.slots)):
                    raise AssertionError("phase 39: every chunk of the flagship keeps a "
                                         "ray, so the first chunks are kept")
                if mode == "found":
                    _, fallback, e = probe_against_marked(
                        ft, fparams, n, spec, f"phase 39 K1e probe {interact} rng={rng}", **kw)
                    probe_err = max(probe_err, e)
                    if fallback:
                        raise AssertionError("phase 39: the flagship's probe fell back")
    for interact in ("mc", "weight"):  # the mosaic's layers in K1e's record launch
        pipe = engine.Pipeline(mosaic15_config(n, 1, "fused", interact_mode=interact),
                               device="cuda")
        fparams = k1_pack(pipe)
        uniforms = torch.rand((fparams.n_draws, n), generator=gen, device="cuda")
        spec = ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, 8, "found")
        for rng, kw in (("input", {"uniforms": uniforms}), ("hw", {"seed": (39, 9)})):
            e, _ = k1e_against_twin(ft, fparams, n, spec,
                                    f"phase 39 K1e found mosaic15 {interact} rng={rng}", **kw)
            err = max(err, e)
            _, fallback, e = probe_against_marked(
                ft, fparams, n, spec, f"phase 39 K1e probe mosaic15 {interact} rng={rng}", **kw)
            probe_err = max(probe_err, e)
            if fallback:
                raise AssertionError("phase 39: mosaic15's probe fell back")
    cfg = flagship(n, 1, engine="fused")
    cfg["optics"]["detector"]["xsize"] = SPARSE_DETECTOR_XSIZE
    pipe = engine.Pipeline(cfg, device="cuda")
    fparams = k1_pack(pipe)
    uniforms = torch.rand((fparams.n_draws, n), generator=gen, device="cuda")
    for rng, kw in (("input", {"uniforms": uniforms}), ("hw", {"seed": (39, 8)})):
        e, hist = k1e_against_twin(ft, fparams, n, ft.HistorySpec("found", 8, 8192),
                                   f"phase 39 K1e found, sparse detector, rng={rng}", **kw)
        err = max(err, e)
        _, fallback, e = probe_against_marked(
            ft, fparams, n, ft.HistorySpec("found", 8, 8192),
            f"phase 39 K1e probe, sparse detector, rng={rng}", **kw)
        probe_err = max(probe_err, e)
        if not fallback:
            raise AssertionError("phase 39: the sparse detector's probe did not fall back")
        every = ft.fused_run_cuda(fparams, n, n, history=ft.HistorySpec("found", 128, 8192),
                                  **kw)[2]
        marked = every.chunks[:int(every.used)]
        kept = hist.chunks[:int(hist.used)]
        log(f"phase 39 sparse detector rng={rng}: {marked.numel()} of 128 chunks keep a "
            f"ray; 'found' kept {kept.tolist()}")
        if not (0 < marked.numel() < 64 and torch.equal(kept, marked[:8])
                and int(kept[-1]) > kept.numel() - 1):
            raise AssertionError("phase 39: the selection did not skip chunks as it should")
    return err, probe_err


def detector_local(pipe, name, origin):
    """Global points (numpy (n, 3)) in the optic ``name``'s local frame."""
    frame = pipe.params["optics"][name]["frame"]
    pts = torch.as_tensor(origin, dtype=torch.float64)
    return ((pts - frame.origin.double().cpu()) @ frame.basis.double().cpu().T).numpy()


def check_found(res, pipe, spec, label):
    """A found history's invariants: at most ``spec.slots * spec.chunk`` rays,
    alive at every element, the last element's points inside its bounds.
    Returns the number of found rays."""
    found = res["found"]["history"]
    names = list(found)
    n_found = found[names[-1]]["origin"].shape[0]
    if not 0 < n_found <= spec.slots * spec.chunk:
        raise AssertionError(f"{label}: {n_found} found rays, bound "
                             f"{spec.slots * spec.chunk}")
    for name in names:
        if not (found[name]["mask"].all() and found[name]["origin"].shape == (n_found, 3)):
            raise AssertionError(f"{label}: a found ray is dead at {name}")
    local = detector_local(pipe, names[-1], found[names[-1]]["origin"])
    p = pipe.config["optics"][names[-1]]
    inside = (np.abs(local[:, 0]) <= p["xsize"] / 2 + 1e-6) & (
        np.abs(local[:, 1]) <= p["ysize"] / 2 + 1e-6) & (np.abs(local[:, 2]) < 1e-5)
    if not inside.all():
        raise AssertionError(f"{label}: {int((~inside).sum())} found rays off the "
                             f"{names[-1]}")
    return n_found


def kept_chunks_twin(ft, fparams, n, spec, label, bundles=None, **kwargs):
    """K1 with 'found' at full width, then the twin's record pass over the
    kernel's kept chunks (marks set at them alone): the two reservoirs equal
    (``history_equal``), so the found count is the twin's count of
    final-alive rays in those chunks. Returns (kernel reservoir, its found
    count)."""
    hist = ft.fused_run_cuda(fparams, n, n, bundles=bundles, history=spec, **kwargs)[2]
    marks = torch.zeros(spec.n_chunks(n), dtype=torch.int32, device="cuda")
    marks[hist.chunks[:int(hist.used)].long()] = 1
    plain = ft.history_record_plain(fparams, n, n, spec, marks, bundles=bundles, **kwargs)
    n_fields = 9 if fparams.weight else 8
    history_equal(hist, plain, n_fields, label)
    return hist, found_in(plain, fparams)


def found_in(hist, fparams) -> int:
    """The rays of a reservoir alive at the last element."""
    n_fields = 9 if fparams.weight else 8
    return int((hist.slots[:, fparams.n_optics * n_fields + 7] != 0).sum())


def sort_history_numpy(history_dev, names, max_lost, rng):
    """The found/lost split in plain numpy, as JAX's ``_sort_history`` does
    it and the port's once did: the masks and every field copied to
    the host, found where the last element keeps a ray, lost candidates
    alive at the first element and dead at the last, truncated by
    ``rng.choice(w_lost, size=max_lost, replace=False)``."""
    final_mask = history_dev[names[-1]].mask.cpu().numpy()
    born_mask = history_dev[names[0]].mask.cpu().numpy()
    w_found = np.flatnonzero(final_mask)
    w_lost = np.flatnonzero(born_mask & ~final_mask)
    if len(w_lost) > max_lost:
        w_lost = rng.choice(w_lost, size=max_lost, replace=False)
    found, lost = {}, {}
    for name in names:
        arrays = {k: v.cpu().numpy() for k, v in history_dev[name].to_dict().items()}
        found[name] = {k: v[w_found] for k, v in arrays.items()}
        lost[name] = {k: v[w_lost] for k, v in arrays.items()}
    return found, lost


def splits_equal(got, want, label) -> None:
    """Two (found, lost) splits alike: the same elements and keys in order,
    dtypes, shapes and every value (NaN where the other is NaN)."""
    for section_got, section_want in zip(got, want):
        if list(section_got) != list(section_want):
            raise AssertionError(f"{label}: elements {list(section_got)}")
        for name, arrays in section_want.items():
            if list(section_got[name]) != list(arrays):
                raise AssertionError(f"{label}: {name}'s keys {list(section_got[name])}")
            for key, a in arrays.items():
                b = section_got[name][key]
                if not (b.dtype == a.dtype and b.shape == a.shape
                        and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")):
                    raise AssertionError(f"{label}: {name}.{key} differs")


def totals_equal(got, want, label) -> float:
    """Two ``raytrace`` results' totals alike: every element's meta and
    every image equal to the bit. Returns the largest difference (0)."""
    err = 0.0
    for section in ("meta", "image"):
        a, b = got["total"][section], want["total"][section]
        if list(a) != list(b):
            raise AssertionError(f"{label}: {section} names {list(a)} against {list(b)}")
        for name in b:
            for key, x, y in (((k, a[name][k], b[name][k]) for k in b[name])
                              if section == "meta" else ((None, a[name], b[name]),)):
                x, y = np.asarray(x), np.asarray(y)
                if x.shape != y.shape or not np.array_equal(x, y):
                    raise AssertionError(f"{label}: {section} {name} {key or ''} differs")
                if x.dtype.kind in "fiu" and x.size:
                    err = max(err, float(np.abs(x.astype(np.float64)
                                                - y.astype(np.float64)).max()))
    log(f"{label}: meta and images equal (largest difference {err})")
    return err


def phase_k1e_flagship(smi, ft, engine, raytrace) -> dict:
    """Phase 40: the flagship at 2^26 x 4 through ``raytrace(config,
    device='cuda')`` with ``keep_history`` False, 'found' and 'sampled'
    (history_max_lost 10000): rays/s of each, its K1, record and probe
    launches (counted around the call: the 'found' run is the main path of
    this slice: the probe's windows and both builds of K1) and the
    ``raytrace_run`` and ``sort_history`` spans (``utils/profiler``); the
    'found' and 'sampled' calls' meta and images equal to the call's
    without history on the same seed, the found history's invariants, the
    sampled found share against the run's efficiency; the probe path
    against the marked build at full width; then K1e's times: the 'found' call of
    ``fused_run_cuda`` against K1's (interleaved), the split held to the
    numpy split (``sort_history_numpy``) on a 'found' run's history, its
    main step (both
    builds with the probe's flag set, ``k1_direct`` with ``pair``) beside
    K1's at 2^28 and 2^22 rays, the probe and the selection with the record launch
    on the card alone, their twins, ``torch.nonzero`` of the marks (the
    selection's yardstick) and the found/lost split alone."""
    from xicsrt_tpu_torch.utils.profiler import profiler

    N, iters = 1 << 26, 4
    pipe = engine.Pipeline(flagship(N, iters, engine="fused"), device="cuda")
    budget = pipe.num_rays * iters
    src = ft._source_spec(pipe.source)
    spec = ft._history_spec(pipe, src, 8192, 8, "found")
    n_windows = len(ft.probe_windows(spec, budget))
    out = {}
    for kh in (False, "found", "sampled"):
        cfg = flagship(N, iters, engine="fused", keep_history=kh, history_max_lost=10000)
        ft.fused_run_cuda.launches = 0
        ft.history_record_cuda.launches = 0
        ft.history_probe_cuda.launches = 0
        profiler.reset()
        profiler.enable()
        try:
            res = raytrace(copy.deepcopy(cfg), device="cuda")
            torch.cuda.synchronize()
        finally:
            profiler.disable()
        spans = {k: v[0] * 1e3 for k, v in profiler.totals().items()}
        launches = (ft.fused_run_cuda.launches, ft.history_record_cuda.launches,
                    ft.history_probe_cuda.launches)
        if launches != ((2, 1, n_windows) if kh == "found" else (1, int(bool(kh)), 0)):
            raise AssertionError(f"phase 40 keep_history={kh!r}: K1, record, probe "
                                 f"launches {launches}")
        ms = cuda_ms(lambda: raytrace(copy.deepcopy(cfg), device="cuda"), 3)
        out[kh] = {"res": res, "ms": ms, "launches": launches, "spans": spans}
        meta = metas_of(res)
        log(f"phase 40 flagship keep_history={kh!r}: {budget / ms * 1e3:.4g} rays/s "
            f"({ms:.2f} ms for {budget} rays on {smi}); meta {meta}; K1, record, probe "
            f"launches {launches}; spans of the counted call: raytrace_run "
            f"{spans.get('raytrace_run', float('nan')):.3f} ms, sort_history "
            f"{spans.get('sort_history', float('nan')):.3f} ms")
    main_err = max(totals_equal(out[kh]["res"], out[False]["res"],
                                f"phase 40 keep_history={kh!r} against False")
                   for kh in ("found", "sampled"))
    res = out["found"]["res"]
    n_found = check_found(res, pipe, spec, "phase 40 found")
    log(f"phase 40 found: {n_found} found rays of at most {spec.slots * spec.chunk}, alive "
        f"at every element, on the detector; lost sample "
        f"{res['lost']['history']['detector']['origin'].shape[0]}")

    sampled = out["sampled"]["res"]
    s_spec = ft._history_spec(pipe, src, 8192, None, "sampled")
    n_sample = min(s_spec.slots * s_spec.chunk, budget)
    meta = metas_of(sampled)
    eff = meta["detector"] / meta["source"]
    n_found_s = check_found(sampled, pipe, s_spec, "phase 40 sampled")
    n_lost = sampled["lost"]["history"]["detector"]["origin"].shape[0]
    dev = abs(n_found_s - eff * n_sample) / math.sqrt(n_sample * eff * (1 - eff))
    log(f"phase 40 sampled: {n_found_s} found of a {n_sample}-ray sample against the "
        f"run's {eff:.6f}: {dev:.2f} binomial sigma (< 5); lost {n_lost} (history_max_lost "
        f"10000)")
    if dev >= 5 or n_lost != 10000 or not sampled["lost"]["history"]["source"]["mask"].all():
        raise AssertionError("phase 40: the sampled history is biased or not truncated")

    n = budget
    fparams = k1_pack(pipe)
    _, fallback, e = probe_against_marked(ft, fparams, n, spec, "phase 40 full width",
                                          twin=False, seed=(40, 9))
    main_err = max(main_err, e)
    if fallback:
        raise AssertionError("phase 40: the flagship's probe fell back")
    hist, n_twin = kept_chunks_twin(ft, fparams, n, spec, "phase 40 full width, kept chunks",
                                    seed=(40, 9))
    n_kernel = found_in(hist, fparams)
    if n_kernel != n_twin or n_kernel > spec.slots * spec.chunk:
        raise AssertionError(f"phase 40: {n_kernel} found rays against the twin's {n_twin}")
    marks = torch.zeros(spec.n_chunks(n), dtype=torch.int32, device="cuda")
    marks[:spec.slots] = 1

    def flagged(m):  # marks of m rays with the probe's flag set: the main launch
        f = torch.zeros(spec.n_chunks(m) + 1, dtype=torch.int32, device="cuda")
        f[-1] = 1
        return f

    m = 1 << 22
    flag_n, flag_m = flagged(n), flagged(m)
    runs = {"k1": lambda: k1_direct(ft, fparams, n, (40, 9)),
            "main": lambda: k1_direct(ft, fparams, n, (40, 9), marks=flag_n,
                                      chunk=spec.chunk, pair=True),
            "found": lambda: ft.fused_run_cuda(fparams, n, n, seed=(40, 9), history=spec)}
    times = {k: [] for k in runs}
    for which in ("k1", "main", "found", "found", "main", "k1"):
        times[which].append(cuda_ms(runs[which], 5))
    t_k1, t_main, t_found = (min(times[k]) for k in ("k1", "main", "found"))
    runs22 = {"k1": lambda: k1_direct(ft, fparams, m, (1, 2)),
              "main": lambda: k1_direct(ft, fparams, m, (1, 2), marks=flag_m,
                                        chunk=spec.chunk, pair=True)}
    times22 = {k: [] for k in runs22}
    for which in ("k1", "main", "main", "k1"):
        times22[which].append(cuda_ms(runs22[which], 20))
    t_k1_22, t_main_22 = min(times22["k1"]), min(times22["main"])
    probe_ms = device_ms(lambda: ft.history_probe_cuda(fparams, n, n, spec, seed=(40, 9)), 20)
    record_ms = device_ms(lambda: ft.history_record_cuda(fparams, n, n, spec, marks,
                                                         seed=(40, 9)), 20)
    probe_plain_ms = cuda_ms(lambda: ft.history_probe_plain(fparams, n, n, spec,
                                                            seed=(40, 9)), 2)
    record_plain_ms = cuda_ms(lambda: ft.history_record_plain(fparams, n, n, spec, marks,
                                                              seed=(40, 9)), 2)
    select_library = kernel_ms(lambda: torch.nonzero(marks)[:spec.slots], 20)
    select_library_host = cuda_ms(lambda: torch.nonzero(marks)[:spec.slots], 20)
    runner, run_pipe = engine.build_runner(
        flagship(N, iters, engine="fused", keep_history="found", history_max_lost=10000),
        device="cuda")
    found_out = runner(run_pipe.params,
                       engine._run_generator(run_pipe.general, 0, run_pipe.device))
    split_ms = cuda_ms(lambda: engine._sort_history(found_out["history"],
                                                    run_pipe.element_names, 10000,
                                                    np.random.default_rng(0)), 5)
    splits_equal(engine._sort_history(found_out["history"], run_pipe.element_names, 10000,
                                      np.random.default_rng(40)),
                 sort_history_numpy(found_out["history"], run_pipe.element_names, 10000,
                                    np.random.default_rng(40)),
                 "phase 40 the split on the card against the numpy split")
    n_rows = hist.slots.shape[1]
    packed = packed_bytes(fparams.fp, fparams.ip, fparams.aux)
    b_record = bound(spec.slots * n_rows * spec.chunk * 4 + 8 * spec.n_chunks(n) + packed,
                     k1_ops(fparams) * spec.slots * spec.chunk)
    # The probe's work on this run: its first window (S chunks), which
    # finds the kept chunks; the later windows leave at once.
    b_probe = bound(packed + 4 * (spec.slots + 1), k1_ops(fparams) * spec.slots * spec.chunk)
    k1e_ms = t_found - t_k1
    library_txt = ("not measured (the profiler recorded no device time)"
                   if select_library is None else f"{select_library:.4f} ms")
    log(f"phase 40 timings on {smi}: K1 {t_k1:.4f} ms, its 'found' main step (the probe's "
        f"flag set: the marked build leaves at once, the build without marks runs) "
        f"{t_main:.4f} ms, K1 with 'found' (probe, main step, "
        f"selection and record) {t_found:.4f} ms per {n} rays (least of 2 means of 5, "
        f"interleaved), so K1e {k1e_ms:.4f} ms; per 2^22 rays K1 {t_k1_22:.4f} ms, the main "
        f"step {t_main_22:.4f} ms (least of 2 means of 20); on the card alone the probe's "
        f"{n_windows} launches {probe_ms:.4f} ms (twin {probe_plain_ms:.4f} ms, bound "
        f"{b_probe[0]:.4f} ms, {b_probe[1]}), the selection and record {record_ms:.4f} ms "
        f"(twin {record_plain_ms:.4f} ms, bound {b_record[0]:.4f} ms, {b_record[1]}: "
        f"{spec.slots} x {spec.chunk} rays traced again, {n_rows} rows written); "
        f"torch.nonzero(marks)[:{spec.slots}] {library_txt} on the card (profiler), "
        f"{select_library_host:.4f} ms with the host; the found/lost split alone "
        f"{split_ms:.4f} ms, equal to the numpy split's on its history; found {n_kernel} rays, the twin's count in the kept chunks "
        f"{n_twin}")
    return {"launches": out["found"]["launches"], "main_err": main_err, "ms": k1e_ms,
            "main_ms": t_main_22,
            "k1_ms": t_k1_22, "main_ms_2_28": t_main, "k1_ms_2_28": t_k1,
            "found_ms_2_28": t_found, "probe_ms": probe_ms, "probe_plain_ms": probe_plain_ms,
            "probe_bound": b_probe, "record_ms": record_ms, "record_plain_ms": record_plain_ms,
            "record_bound": b_record, "select_library_ms": select_library,
            "split_ms": split_ms, "spans": out["found"]["spans"],
            "rays_per_s": {str(k): budget / v["ms"] * 1e3 for k, v in out.items()}}


def phase_k1e_plasma(ft, engine, raytrace) -> None:
    """Phase 41: ``plasma_torus`` with ``keep_history='found'`` at 2^22
    photons x 4 on ``engine='fused'``: the found history's invariants (chunk
    capped at 4096 for a plasma), and K1e at that width against the twin's
    record pass over its kept chunks."""
    cfg = plasma_config(1 << 22, 4, engine="fused", keep_history="found")
    ft.history_record_cuda.launches = 0
    ft.history_probe_cuda.launches = 0
    res = raytrace(copy.deepcopy(cfg), device="cuda")
    launches = (ft.history_record_cuda.launches, ft.history_probe_cuda.launches)
    pipe, fparams, bundles, n = plasma_k1_setup(ft, engine, 1 << 22, 4)
    spec = ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, 8, "found")
    n_found = check_found(res, pipe, spec, "phase 41 plasma_torus found")
    probe_against_marked(ft, fparams, n, spec, "phase 41 plasma_torus", bundles=bundles,
                         twin=False, seed=(41, 3))
    hist, n_twin = kept_chunks_twin(ft, fparams, n, spec, "phase 41 plasma_torus, kept chunks",
                                    bundles=bundles, seed=(41, 3))
    n_kernel = found_in(hist, fparams)
    log(f"phase 41 plasma_torus found: {n_found} found rays of at most "
        f"{spec.slots} x {spec.chunk}; record, probe launches {launches}; "
        f"direct call {n_kernel} found, the twin's {n_twin}; meta {metas_of(res)}")
    if (spec.chunk != 4096 or n_kernel != n_twin or launches[0] != 1
            or launches[1] != (len(ft.probe_windows(spec, n))
                               if n >= ft.PROBE_MIN_RAYS else 0)):
        raise AssertionError("phase 41: the plasma's reservoir is wrong")


def phase_cli(raytrace, n=1 << 22) -> None:
    """Phase 42: ``python -m xicsrt_tpu_torch`` on the card. The flagship's
    config (fused, keep_history 'found', pickle results) is written to a
    directory under ``build/chip_smoke``; the CLI runs it with ``--save
    --numiter 2 --seed 3`` in a process of its own; its results file holds
    the meta of an in-process run of the same config and seed, and the
    found history."""
    import shutil
    import tempfile

    from xicsrt_tpu_torch import io as xio

    os.makedirs(SMOKE_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=SMOKE_DIR)
    try:
        out = os.path.join(work, "out")
        cfg = flagship(n, 1, engine="fused", keep_history="found",
                       results_ext=".pickle", save_results=True, save_config=True,
                       make_directories=True, output_path=out)
        path = os.path.join(work, "config.json")
        xio.save_config(cfg, path)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "xicsrt_tpu_torch", path, "--save",
                               "--numiter", "2", "--seed", "3"],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"phase 42: the CLI exited {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        saved = xio.load_results(os.path.join(out, "xicsrt_results.pickle"))
        ref_cfg = copy.deepcopy(cfg)
        ref_cfg["general"].update(number_of_iter=2, random_seed=3, save_results=False,
                                  save_config=False)
        ref = raytrace(ref_cfg, device="cuda")
        found = saved["found"]["history"]["detector"]["origin"].shape[0]
        log(f"phase 42 CLI: exit 0 in {seconds:.1f} s; files {sorted(os.listdir(out))}; "
            f"meta {metas_of(saved)} against the in-process run's {metas_of(ref)}; "
            f"{found} found rays saved")
        if metas_of(saved) != metas_of(ref) or not 0 < found <= 8 * 8192:
            raise AssertionError("phase 42: the CLI's results differ from the in-process run")
        if found != ref["found"]["history"]["detector"]["origin"].shape[0]:
            raise AssertionError("phase 42: the CLI's found history differs")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phases 46-48: ray-sharded runs (``xicsrt_tpu_torch/parallel``).
# ---------------------------------------------------------------------------

RANK_RAYS, RANK_ITERS = 1 << 26, 2  # phase 47's flagship: 2^26 rays x 2 over two ranks


def least_call_ms(fn, reps: int = 5, barrier=None) -> float:
    """The least wall-clock ms of ``reps`` calls of ``fn``, each between
    ``torch.cuda.synchronize()`` (and ``barrier()``, where given), after a
    warm-up call: the host's work in a call included."""
    fn()
    times = []
    for _ in range(reps):
        if barrier is not None:
            barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if barrier is not None:
            barrier()
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3


def shards_apart(engine, pipe, mesh, result, name, label) -> None:
    """Each shard of a sharded ``raytrace_single`` result run alone with its
    own generator (``parallel.mesh.shard_generators`` of the run's): the
    shards' ``name`` images differ (other rays), and their sum is the
    result's image to the bit."""
    from xicsrt_tpu_torch.parallel import mesh as pm

    gens = pm.shard_generators(engine._run_generator(pipe.general, 0, pipe.device), mesh)
    local, kind = engine.local_runner(pipe)
    images = [local(pipe.params, g)["image"][name] for g in gens]
    if torch.equal(images[0], images[1]):
        raise AssertionError(f"{label}: the shards traced the same rays")
    if not np.array_equal((images[0] + images[1]).cpu().numpy(),
                          result["total"]["image"][name]):
        raise AssertionError(f"{label}: the result's {name} image is not its shards' sum")
    log(f"{label}: the 2 shards ({kind} runner) run alone give different {name} images "
        f"({int(images[0].sum())}, {int(images[1].sum())} counts) summing to the result's")


def phase_sharded(ft, bg, engine, raytrace, fused_meta, example03_meta) -> dict:
    """Phase 46: ray-sharded runs in one process. The flagship fused over a
    mesh of one CUDA device is ``raytrace`` to the bit (JAX shards no
    single device), and so is ``raytrace_mp`` on one card; the flagship
    fused at 2^26 x 2 and example 03 as written (eager, K4) over 2 shards
    on ``cuda:0``, counters read around each run: the generated total of
    the flagship exact, every image summing to its count, the efficiency
    within 5 binomial sigma of the unsharded run (phases 5 and 15), the
    shards' rays different (``shards_apart``). Returns the launches."""
    from xicsrt_tpu_torch.parallel import make_sharded_run, ray_mesh

    cfg = flagship(1 << 22, 2, engine="fused")
    runner, pipe, mesh = make_sharded_run(cfg, mesh=ray_mesh(1))
    want = raytrace(copy.deepcopy(cfg), device="cuda")
    totals_equal(engine.raytrace_single(cfg, _pipeline=pipe, _runner=runner), want,
                 f"phase 46 the flagship fused over a mesh of {mesh.devices}")
    totals_equal(engine.raytrace_mp(copy.deepcopy(cfg), device="cuda"), want,
                 "phase 46 raytrace_mp on one card")

    mesh = ray_mesh(2, "cuda:0")
    cfg = flagship(RANK_RAYS, RANK_ITERS, engine="fused")
    runner, pipe, _ = make_sharded_run(cfg, mesh=mesh)
    ft.fused_run_cuda.launches = 0
    t0 = time.perf_counter()
    result = engine.raytrace_single(cfg, _pipeline=pipe, _runner=runner)
    seconds = time.perf_counter() - t0
    k1_launches = ft.fused_run_cuda.launches
    if k1_launches != 2:
        raise AssertionError(f"phase 46: the 2-shard flagship launched K1 {k1_launches} "
                             f"times, not once a shard")
    label = "phase 46 the flagship fused, 2 shards on cuda:0"
    meta = check_main_path(result, RANK_RAYS * RANK_ITERS, label)
    pooled = ((meta["detector"] + fused_meta["detector"])
              / (meta["source"] + fused_meta["source"]))
    sigma = math.sqrt(pooled * (1 - pooled) * (1 / meta["source"] + 1 / fused_meta["source"]))
    nsig = abs(meta["detector"] / meta["source"]
               - fused_meta["detector"] / fused_meta["source"]) / sigma
    log(f"{label}: {seconds * 1e3:.1f} ms with the first call's set-up; K1 launches "
        f"{k1_launches}; efficiency {nsig:.2f} binomial sigma from phase 5's unsharded run")
    if nsig >= 5:
        raise AssertionError(f"{label}: the efficiency disagrees with the unsharded run")
    shards_apart(engine, pipe, mesh, result, "detector", label)
    flagship_result = result
    local, local_pipe = engine.build_runner(cfg, device="cuda")
    t_sharded = t_one = float("inf")
    for which in ("one", "sharded", "sharded", "one"):
        if which == "one":
            t_one = min(t_one, least_call_ms(lambda: engine.raytrace_single(
                cfg, _pipeline=local_pipe, _runner=local)))
        else:
            t_sharded = min(t_sharded, least_call_ms(lambda: engine.raytrace_single(
                cfg, _pipeline=pipe, _runner=runner)))
    log(f"{label}: a call (raytrace_single, runners built) {t_sharded:.2f} ms against "
        f"{t_one:.2f} ms unsharded ({t_sharded / t_one:.3f}x; least of 5 calls, in turns)")

    cfg = example_config("example_03_plasma_spectrometer.py")
    runner, pipe, _ = make_sharded_run(cfg, mesh=mesh)
    bg.interval_gather_cuda.launches = 0
    ft.fused_run_cuda.launches = 0
    result = engine.raytrace_single(cfg, _pipeline=pipe, _runner=runner)
    k4_launches = bg.interval_gather_cuda.launches
    label = "phase 46 example 03 eager, 2 shards on cuda:0"
    if k4_launches <= 0 or ft.fused_run_cuda.launches:
        raise AssertionError(f"{label}: K4 launched {k4_launches} times, K1 "
                             f"{ft.fused_run_cuda.launches}")
    meta = check_plasma_result(result, cfg, label)
    p1, p2, nsig = binomial_sigmas(meta, example03_meta)
    log(f"{label}: K4 launches {k4_launches}; efficiency {p1:.6g} against the unsharded "
        f"run's {p2:.6g}, {nsig:.2f} binomial sigma (< 5)")
    if nsig >= 5:
        raise AssertionError(f"{label}: the efficiency disagrees with the unsharded run")
    shards_apart(engine, pipe, mesh, result, "detector", label)
    return {"k1": k1_launches, "k4": k4_launches, "flagship": flagship_result,
            "ms_one": t_one, "ms_sharded": t_sharded}


def rank_worker(rank: int, port: int, out: str) -> int:
    """One of phase 47's two ranks (``python3 chip_smoke.py --rank RANK
    PORT OUT``): joins the gloo group on localhost, runs the flagship fused
    at ``RANK_RAYS`` x ``RANK_ITERS`` sharded over the two ranks
    (``shard_rays``, ``devices`` 2: one shard a rank, both on the one
    card), then times 5 calls between barriers (``least_call_ms``); writes
    its meta, images, K1 launches and least call time to ``OUT``."""
    import torch.distributed as dist

    from xicsrt_tpu_torch import engine
    from xicsrt_tpu_torch.ops import fused_trace as ft
    from xicsrt_tpu_torch.parallel import init_multihost

    info = init_multihost(f"localhost:{port}", 2, rank)
    backend = dist.get_backend()
    cfg = flagship(RANK_RAYS, RANK_ITERS, engine="fused", shard_rays=True, devices=2)
    runner, pipe = engine.build_runner(cfg, device="cuda")
    ft.fused_run_cuda.launches = 0
    result = engine.raytrace_single(cfg, _pipeline=pipe, _runner=runner)
    launches = ft.fused_run_cuda.launches
    ms = least_call_ms(lambda: engine.raytrace_single(cfg, _pipeline=pipe, _runner=runner),
                       barrier=dist.barrier)
    meta = result["total"]["meta"]
    np.savez(out, names=np.array(list(meta)), counts=np.array([meta[k]["num_out"] for k in meta]),
             image_names=np.array(list(result["total"]["image"])),
             **{f"image_{k}": v for k, v in result["total"]["image"].items()},
             launches=launches, ms=ms, backend=backend,
             process_count=info["process_count"])
    dist.destroy_process_group()
    return 0


def phase_ranks(smi, engine, two_shards) -> dict:
    """Phase 47: two ranks on the one card through ``torch.distributed``
    (gloo, ``rank_worker`` in two processes): meta and images equal on
    both ranks and to the bit those of phase 46's flagship over 2 shards in
    one process (``two_shards``: the same config, seed and mesh positions),
    the generated total exact, images summing to counts, K1 launched once a
    call on each rank; rays/s of the two ranks against one
    process's unsharded call of the same rays, by ``scaling_efficiency``:
    one card shared by two ranks, not a scaling result."""
    import socket

    from xicsrt_tpu_torch.parallel import scaling_efficiency

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.makedirs(SMOKE_DIR, exist_ok=True)
    outs = [os.path.join(SMOKE_DIR, f"rank{r}.npz") for r in (0, 1)]
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, here, "--rank", str(r), str(port), out],
                              cwd=os.path.dirname(here), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r, out in zip((0, 1), outs)]
    try:
        logs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, text) in enumerate(zip(procs, logs)):
        if proc.returncode:
            raise AssertionError(f"phase 47: rank {r} exited {proc.returncode}:\n{text[-3000:]}")
    ranks = [dict(np.load(out)) for out in outs]
    label = "phase 47 the flagship fused over 2 gloo ranks on one card"
    for r in ranks:
        if str(r["backend"]) != "gloo" or int(r["process_count"]) != 2 or int(r["launches"]) != 1:
            raise AssertionError(f"{label}: backend {r['backend']}, {r['process_count']} "
                                 f"processes, K1 launches {r['launches']}")
        for key in r:
            if key.startswith(("counts", "image_")) and not np.array_equal(r[key], ranks[0][key]):
                raise AssertionError(f"{label}: {key} differs between the ranks")
    result = {"total": {"meta": {str(n): {"num_out": int(c)} for n, c in
                                 zip(ranks[0]["names"], ranks[0]["counts"])},
                        "image": {str(n): ranks[0][f"image_{n}"]
                                  for n in ranks[0]["image_names"]}}}
    check_main_path(result, RANK_RAYS * RANK_ITERS, label)
    totals_equal(result, two_shards, f"{label}, against phase 46's 2 shards in one process")
    runner, pipe = engine.build_runner(flagship(RANK_RAYS, RANK_ITERS, engine="fused"),
                                       device="cuda")
    one_ms = least_call_ms(lambda: engine.raytrace_single(pipe.config, _pipeline=pipe,
                                                          _runner=runner))
    two_ms = float(ranks[0]["ms"])
    rays = RANK_RAYS * RANK_ITERS
    rates = {1: rays / one_ms * 1e3, 2: rays / two_ms * 1e3}
    eff = scaling_efficiency(rates)
    log(f"{label} on {smi}: meta and images equal on both ranks; {rays} rays a call: one "
        f"process unsharded {one_ms:.2f} ms ({rates[1]:.4g} rays/s), two ranks "
        f"{two_ms:.2f} ms ({rates[2]:.4g} rays/s; each the least of 5 calls of "
        f"raytrace_single with its runner built, the ranks' between barriers); "
        f"scaling_efficiency {eff[2]:.3f}: one card shared by two ranks, not a scaling "
        f"result")
    return {"ms_1": one_ms, "ms_2": two_ms, "efficiency": eff[2]}


def phase_sharded_gradients(fg) -> dict:
    """Phase 48: the gradient paths over 2 shards on ``cuda:0``.
    ``make_fused_differentiable`` on the flagship at 2^24 rays: the forward
    images equal the sum of the shards' own forwards (``shard_seed``),
    within float32 summation order (K5f's atomics), and the vjp vector the
    sum of the shards' vjps; ``make_differentiable`` at 2^20 rays: the
    autograd gradient of a weighted image sum with respect to the crystal
    spacing equals the sum of the shards' own, within float32 summation
    order. Returns the launches and the largest relative differences."""
    from xicsrt_tpu_torch.engine import _run_generator
    from xicsrt_tpu_torch.gradients import make_differentiable, make_fused_differentiable
    from xicsrt_tpu_torch.parallel import mesh as pm

    mesh = pm.ray_mesh(2, "cuda:0")
    cfg = grad_flagship(1 << 24, 1)
    fg.fused_grad_forward_cuda.launches = 0
    fg.fused_grad_vjp_cuda.launches = 0
    forward, vjp, pack, pipe = make_fused_differentiable(cfg, mesh=mesh)
    pvec = pack(pipe.params).detach()
    images = forward(pvec, 7)["image"]
    gen = torch.Generator(device="cuda").manual_seed(48)
    g = {k: torch.randn(v.shape, generator=gen, device="cuda") for k, v in images.items()}
    gvec = vjp(pvec, 7, g)
    launches = (fg.fused_grad_forward_cuda.launches, fg.fused_grad_vjp_cuda.launches)
    if launches != (2, 2):
        raise AssertionError(f"phase 48: K5f, K5b launched {launches} times, not once a shard")
    f1, v1, _, _ = make_fused_differentiable(pm._shard_intensity(cfg, 2), device="cuda:0")
    seeds = [pm.shard_seed(7, i) for i in mesh.positions]
    shard_images = [f1(pvec, s)["image"] for s in seeds]
    err_image = 0.0
    for name, image in images.items():
        want = shard_images[0][name] + shard_images[1][name]
        err = float((image - want).abs().max() / want.abs().max())
        err_image = max(err_image, err)
        if err > 1e-4 or torch.equal(shard_images[0][name], shard_images[1][name]):
            raise AssertionError(f"phase 48: the {name} image is not its shards' sum ({err})")
    want = v1(pvec, seeds[0], g) + v1(pvec, seeds[1], g)
    err_vjp = float((gvec - want).abs().max() / want.abs().max())
    if err_vjp > 1e-5:
        raise AssertionError(f"phase 48: the vjp is not its shards' sum ({err_vjp})")

    cfg = grad_flagship(1 << 20, 1)
    image_fn, pipe = make_differentiable(cfg, mesh=mesh)
    weights = torch.randn(pipe.image_specs()["detector"][0], generator=gen, device="cuda")

    def spacing_grad(image_fn, pipeline, gens):
        d = pipeline.params["optics"]["crystal"]["crystal_spacing"].detach().clone()
        d.requires_grad_(True)
        params = dict(pipeline.params)
        params["optics"] = {**params["optics"],
                            "crystal": {**params["optics"]["crystal"], "crystal_spacing": d}}
        loss = sum((image_fn(params, gen)["detector"] * weights).sum() for gen in gens)
        loss.backward()
        return float(loss.detach()), float(d.grad)

    value, grad = spacing_grad(image_fn, pipe, [_run_generator({"random_seed": 4}, 0,
                                                               pipe.device)])
    image_fn1, pipe1 = make_differentiable(pm._shard_intensity(cfg, 2), device="cuda:0")
    gens = pm.shard_generators(_run_generator({"random_seed": 4}, 0, pipe.device), mesh)
    value1, grad1 = spacing_grad(image_fn1, pipe1, gens)
    err_eager = abs(grad - grad1) / abs(grad1)
    if grad1 == 0.0 or err_eager > 1e-4 or abs(value - value1) > 1e-4 * abs(value1):
        raise AssertionError(f"phase 48: the eager gradient {grad} is not its shards' "
                             f"{grad1} (loss {value} against {value1})")
    log(f"phase 48 sharded gradients, 2 shards on cuda:0: the fused forward's images within "
        f"{err_image:.3g} of their shards' sum (relative to the largest pixel), the vjp "
        f"within {err_vjp:.3g}, K5f and K5b launched {launches}; the eager gradient "
        f"d/d(spacing) {grad:.6g} against the shards' {grad1:.6g} ({err_eager:.3g})")
    return {"launches": launches, "err_image": err_image, "err_vjp": err_vjp}


U32 = 2.0 ** -24  # float32's unit roundoff


def gamma(d: int, u: float = U32) -> float:
    """The float32 bound of a sum whose terms each pass through at most
    ``d`` additions: |computed - exact| <= gamma(d) * sum |terms|."""
    return d * u / (1.0 - d * u)


def r1_bound(n_chunks: int, sub: int) -> float:
    """R1's bound on |kernel - reference| relative to each output element,
    the reference being R1's plain float32 chains (``elem_chains_plain``)
    summed in float64. Both add a chain's streams in the same order; the
    kernel then sums 256 lanes by a 10-level tree, the finish launch its
    row's n_chunks sub / 256 partials in 256 strided sums and a 10-level
    tree, in float32; the reference makes at most n_chunks sub float64 adds
    a term. Every term is positive (each body keeps positive values
    positive, and every start is), so the sum of the terms' magnitudes is
    the output. Each chain's final value may differ by 4 ulp (2^-21), where
    the kernel's expf, sqrtf or division and torch's round apart: those maps
    contract (|f'| < 0.6), so a step's ulp does not grow; the simple body's
    multiplies and adds round alike in both."""
    items = n_chunks * (sub // 256)
    return (gamma(10 + -(-items // 256) + 10) + gamma(n_chunks * sub, 2.0 ** -53)
            + 2.0 ** -21)


def r1_reference(rp, seed, body: str, n_chunks: int, K: int) -> torch.Tensor:
    """R1's (8, 128) output in float64: the plain float32 chains at ``K``
    steps, summed in float64."""
    rows = rp.elem_chains_plain(seed, body, n_chunks=n_chunks, K=K).double().sum(dim=(0, 2))
    return rows[:, None].expand(8, 128)


def r1_check(rp, seed, body: str, n_chunks: int, K: int, label: str) -> tuple:
    """R1's kernel at ``K`` steps held to its reference within ``r1_bound``:
    (max |kernel - reference|, the reference)."""
    kernel = rp.elem_rate_cuda(seed, body, n_chunks=n_chunks, K=K)
    if not bool((kernel == kernel[:, :1]).all()):
        raise AssertionError(f"{label}: a row's columns differ")
    ref = r1_reference(rp, seed, body, n_chunks, K)
    return held_to(kernel.double(), ref, r1_bound(n_chunks, rp.SUB), label), ref


def r1_step_check(rp, seed, body: str, n_chunks: int = 16, steps: int = 4) -> float:
    """R1 at K = 1 .. ``steps`` against its reference, each held to
    ``r1_bound``, and each K's reference at least 10 bounds from K - 1's,
    so a kernel that runs a step fewer or more than it is asked fails. At
    the tool's K = 128 this cannot show: the trans and sqrtdiv bodies
    contract to their fixed points within about 25 and 11 steps. Returns
    the largest |kernel - reference|."""
    rel = r1_bound(n_chunks, rp.SUB)
    prev = r1_reference(rp, seed, body, n_chunks, 0)
    worst = 0.0
    for K in range(1, steps + 1):
        err, ref = r1_check(rp, seed, body, n_chunks, K, f"R1-{body} at K = {K}")
        gap = float(((ref - prev).abs() / ref.abs()).min())
        if not gap >= 10 * rel:
            raise AssertionError(f"R1-{body}: K = {K} moves the output {gap:.3g} of its "
                                 f"value, not 10 x the bound {rel:.3g}: the check cannot "
                                 "tell the steps apart")
        prev, worst = ref, max(worst, err)
    return worst


def r2_bound(n_mm: int, K_mm: int, sub: int, blocks: int) -> float:
    """R2's bound on |kernel - plain| relative to each output element. The
    products of bf16 values are exact in float32 and non-negative, so the
    sum of the terms' magnitudes is the output. The kernel's terms pass the
    mma's 16 products of a k slice, its accumulator over sub / 16 slices
    and K_mm products, the block's steps and the finish launch's sum over
    the blocks, each add allowed 2^-23 (the tensor cores may truncate); the
    plain version's the matmul's sub - 1 adds in cuBLAS's or the CPU's
    order, the K_mm products and the n_mm steps."""
    d_kernel = 16 + (sub // 16) * K_mm + -(-n_mm // blocks) + blocks
    return gamma(d_kernel, 2.0 ** -23) + gamma(sub - 1 + K_mm + n_mm)


def held_to(kernel, plain, rel: float, label: str) -> float:
    """max |kernel - plain|, raising where an element passes rel |plain|."""
    err = (kernel - plain).abs()
    if not bool(torch.isfinite(kernel).all()) or bool((err > rel * plain.abs()).any()):
        raise AssertionError(f"{label}: the kernel is {float(err.max()):.6g} from its plain "
                             f"version, beyond the bound {rel:.3g} of its value")
    return float(err.max())


def phase_r1(smi) -> dict:
    """Phase 43: R1 against its reference for each body at K = 1 .. 4
    (``r1_step_check``, 16 grid steps) and at the TPU tool's sizes, each
    held to ``r1_bound``; the time its K steps add, t(K) - t(0), at K = 128
    over K = 64 within 5 % of 2 (the median of five rounds' ratios, each
    round timing K = 0, 64, 128 back to back on the card alone with
    ``device_ms``), so the loop runs every step it counts; t(0), the
    blocks' start values and sums, is the part of R1's time that is not
    its steps. Then the plain version's time. R1's own time and rate are
    phase 45's."""
    from xicsrt_tpu_torch.ops import roofline_probes as rp
    from xicsrt_tpu_torch.tools import roofline

    seed = torch.tensor([0.5625], dtype=torch.float32, device="cuda")
    seeds = torch.tensor([0.5 + 0.125 * (k % 5) for k in range(BS.LAUNCHES)],
                         dtype=torch.float32, device="cuda")
    out = {}
    for body in rp.BODIES:
        n_chunks = rp.ELEM_SIZES[body][0]
        step_err = r1_step_check(rp, seed, body)
        err, ref = r1_check(rp, seed, body, n_chunks, rp.K_STEPS,
                            f"phase 43 R1-{body} at the tool's size")
        log(f"phase 43 R1-{body}: K = 1 .. 4 at 16 grid steps within {step_err:.4g} of the "
            f"float64 sums, each K at least 10 bounds from the last; the tool's size "
            f"{float(ref[0, 0]):.9g}, |diff| {err:.4g} within "
            f"{r1_bound(n_chunks, rp.SUB):.3g} of the value")
        # On the card alone (device_ms): at K = 0 a call is shorter than the
        # host's time to issue it, which calls back to back would time in
        # t(0). Each round times K = 0, 64 and 128 back to back and takes its
        # own ratio, so the three share the card's clock; the median of 5.
        calls = iter(range(1 << 30))

        def launch(K):
            k = next(calls) % len(seeds)
            rp.elem_rate_cuda(seeds[k:k + 1], body, K=K)

        rounds = []
        for _ in range(5):
            t = {K: device_ms(lambda K=K: launch(K), 20) for K in (0, 64, 128)}
            rounds.append(((t[128] - t[0]) / (t[64] - t[0]), t))
        scaling, ms = sorted(rounds, key=lambda r: r[0])[len(rounds) // 2]
        if not abs(scaling / 2.0 - 1.0) <= 0.05:
            raise AssertionError(f"phase 43: R1-{body}'s steps take {ms[128] - ms[0]:.4f} ms "
                                 f"at K = 128 and {ms[64] - ms[0]:.4f} ms at K = 64, not "
                                 "twice: the loop is not what it counts")
        plain_ms = cuda_ms(lambda: rp.elem_rate_plain(seed, body), 2)
        per_step = roofline.body_ops(body)
        b = bound(0, rp.elem_steps(body) * sum(per_step.values()))
        log(f"phase 43 timings on {smi}: R1-{body} {ms[128]:.4f} ms at K = 128, "
            f"{ms[64]:.4f} at K = 64, {ms[0]:.4f} at K = 0 (the steps' time at 128 over 64: "
            f"{scaling:.4f}); plain {plain_ms:.4f} ms; bound "
            f"{b[0]:.4f} ms ({b[1]}, {sum(per_step.values()):g} operations a step)")
        out[body] = {"err": max(err, step_err), "plain_ms": plain_ms, "bound": b}
    return out


def phase_r2(smi) -> dict:
    """Phase 44: R2 against its plain version at a checking size (264 grid
    steps) and at the TPU tool's size, held to ``r2_bound`` with the blocks
    the kernel launches; then R2's time at the tool's size beside
    ``torch.matmul`` on bf16 operands of the same MACs (the yardstick), in
    turns (matmul, R2, R2, matmul), and the plain version's time."""
    from xicsrt_tpu_torch.ops import native
    from xicsrt_tpu_torch.ops import roofline_probes as rp

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 44 needs float32 matmuls in the plain version")
    seed = torch.tensor([0.011], dtype=torch.float32, device="cuda")
    blocks = native.library().xrt_mma_rate_blocks(rp.N_MM)
    for n_mm in (264, rp.N_MM):
        kernel = rp.mma_rate_cuda(seed, n_mm=n_mm)
        plain = rp.mma_rate_plain(seed, n_mm=n_mm)
        rel = r2_bound(n_mm, rp.K_MM, rp.SUB, min(blocks, n_mm))
        err = held_to(kernel, plain, rel, f"phase 44 R2, {n_mm} steps")
        log(f"phase 44 R2, {n_mm} grid steps: largest {float(kernel.max()):.9g} against the "
            f"plain {float(plain.max()):.9g}, max |diff| {err:.4g} within {rel:.3g} of each "
            "value")
    plain_ms = cuda_ms(lambda: rp.mma_rate_plain(seed), 1)
    macs = rp.mma_macs()
    side = 16384
    a = torch.rand((side, macs // side // side), device="cuda").to(torch.bfloat16)
    bt = torch.rand((macs // side // side, side), device="cuda").to(torch.bfloat16)
    library_ms = ms = float("inf")
    for which in ("matmul", "r2", "r2", "matmul"):
        if which == "matmul":
            library_ms = min(library_ms, cuda_ms(lambda: torch.matmul(a, bt), 5))
        else:
            ms = min(ms, cuda_ms(lambda: rp.mma_rate_cuda(seed), 5))
    del a, bt
    b = (2 * macs / 989e12 * 1e3, "operations")
    log(f"phase 44 timings on {smi}: R2 {ms:.4f} ms ({macs} MACs in {blocks} blocks, "
        f"{macs / (ms * 1e-3):.4g} MAC/s, {macs / (ms * 1e-3) / 494.5e12:.3f} of 494.5e12); "
        f"torch.matmul of {side} x {macs // side // side} by {macs // side // side} x {side} "
        f"bf16 {library_ms:.4f} ms (R2 / matmul {ms / library_ms:.3f}); R2's plain version "
        f"{plain_ms:.4f} ms; bound {b[0]:.4f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": b, "library_ms": library_ms}


def phase_roofline(smi) -> dict:
    """Phase 45: ``tools.roofline.main`` on its four scenarios and
    ``mesh41`` (K1c-cheb), the probes' and K1's launches counted around it;
    its class rates (R1's and R2's times) beside the card's peaks; every
    row finite and positive, R1, R2 and K1 launched."""
    from xicsrt_tpu_torch.ops import fused_trace as ft
    from xicsrt_tpu_torch.ops import roofline_probes as rp
    from xicsrt_tpu_torch.tools import roofline

    log("phase 45 before the roofline, SM clock and clock limits: "
        + roofline.nvidia_smi("clocks.sm,clocks_event_reasons.active"))
    rp.elem_rate_cuda.launches = 0
    rp.elem_rate_cuda.body_launches = dict.fromkeys(rp.BODIES, 0)
    rp.mma_rate_cuda.launches = 0
    ft.fused_run_cuda.launches = 0
    out = roofline.main([*roofline.SCENARIO_NAMES, "mesh41", "--out",
                         os.path.join("build", "chip_smoke", "roofline.json")])
    launches = {**{f"R1-{b}": n for b, n in rp.elem_rate_cuda.body_launches.items()},
                "R2": rp.mma_rate_cuda.launches, "K1": ft.fused_run_cuda.launches}
    for name, row in out["scenarios"].items():
        numbers = [row[k] for k in ("predicted_serial_rays_per_s", "predicted_overlap_rays_per_s",
                                    "measured_rays_per_s", "measured_vs_serial_bound",
                                    "measured_vs_overlap_bound", "raytrace_rays_per_s")]
        if not all(math.isfinite(x) and x > 0 for x in numbers) or row["k1"]["launches"] <= 0:
            raise AssertionError(f"phase 45: the {name} row is not finite and positive, or "
                                 f"K1 did not launch: {row}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"phase 45: a probe did not launch: {launches}")
    log(f"phase 45 rates on {smi}: " + ", ".join(
        f"{cls} {out['rates'][f'{cls}_per_s']:.4g}/s ({out['rates'][f'{cls}_per_s'] / peak:.3f} "
        f"of {peak:.4g})" for cls, peak in roofline.PEAK_PER_S.items())
        + f"; probe ms {out['rate_ms']}; launches {launches}")
    return {"launches": launches, "roofline": out}


# K1's builds past fused_trace_kernel's 18 in the launcher's table
# (xrt_fused_trace_build, csrc/fused_run.cuh): each kernel and its
# template argument.
# The optics of each K1 build's long chain (``long_chain_builds``): one
# past the 16 the kernels' static buffers held.
LONG_CHAIN_OPTICS = 17


def long_chain_builds(n) -> dict:
    """Each K1 build's chain behind as many baffle plates as make it
    ``LONG_CHAIN_OPTICS`` optics long (``tools/bench_scenarios.
    with_baffles``), ``n`` rays (a plasma's: ``n``
    expected photons): {label: (config, the build the launcher takes)}. The
    flagship in mc, weight and bilinear mode; the mirror flagship (a window
    of its images staged); the cylinder crystal in mc and weight mode;
    convex toroidal crystals without their Bragg check (the build with
    every shape); phase 24's generic source; ``plasma_torus``; phase 30's
    sphere mesh (its curve widened to 2 mrad); ``mosaic15``."""
    cls, kw = MESH_CRYSTALS["mesh_sphere"]
    mirrors = mirror_configs(n, 1, "fused")
    chains = {
        "flat": (flagship(n, 1, engine="fused"), "fused_trace_flat_kernel<0>"),
        "flat weight": (flagship(n, 1, engine="fused", interact_mode="weight"),
                        "fused_trace_flat_kernel<1>"),
        "flat bilinear": (flagship(n, 1, engine="fused", image_mode="bilinear"),
                          "fused_trace_flat_kernel<1>"),
        "dense window": (mirrors["flagship_no_check"], "fused_trace_dense_kernel"),
        "cylinder": (cylinder_config(n, 1, "fused"), "fused_trace_cylinder_kernel<0>"),
        "cylinder weight": (cylinder_mode_config("weight", n),
                            "fused_trace_cylinder_kernel<1>"),
        "torus": (mirrors["torus_no_check"], "fused_trace_kernel<point, kStages 0>"),
        "generic": (source_matrix_config(n, 1, "fused"),
                    "fused_trace_kernel<generic, kStages 0>"),
        "plasma": (plasma_config(n, 1, engine="fused"), "fused_trace_kernel<plasma, kStages 0>"),
        "chebyshev": (mesh_config(n, 1, "fused", cls, **dict(kw, rocking_fwhm=2e-3)),
                      "fused_trace_kernel<point, Chebyshev, kStages 0>"),
        "mosaic": (mosaic15_config(n, 1, "fused"), "fused_trace_kernel<point, kStages 2>"),
    }
    return {label: (BS.with_baffles(cfg, LONG_CHAIN_OPTICS - len(cfg["optics"])), build)
            for label, (cfg, build) in chains.items()}


def long_chain_against_twins(ft, engine, cfg, label, seed) -> float:
    """K1 (in the build its chain takes) on ``cfg``'s rays, K1e 'found' and
    K3 on one eager iteration's rays, each against its twin in both RNG
    modes as ``twin_equal`` and ``history_equal`` hold them: 0 rays and 0
    pixels apart in mc mode. Returns the largest difference."""
    pipe = engine.Pipeline(cfg, device="cuda")
    spec = ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, 8, "found")
    err = k1_build_against_twin(ft, engine, cfg, f"{label} K1", seed)
    err = max(err, k1_build_against_twin(ft, engine, cfg, f"{label} K1e 'found'", seed,
                                         history=spec))
    k3p = k3_pack(ft, pipe)
    rays = eager_rays(pipe, seed)
    m = rays.mask.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    uniforms = torch.rand((k3p.n_draws, m), generator=gen, device="cuda")
    args = (k3p, rays.origin, rays.direction, rays.wavelength, rays.mask)
    weight = {"weight": rays.weight} if k3p.weight else {}
    for rng, kwargs in (("input", {"uniforms": uniforms}), ("hw", {"seed": (seed, 5)})):
        err = max(err, twin_equal(ft.fused_trace_run_cuda(*args, **kwargs, **weight),
                                  ft.fused_trace_run_plain(*args, **kwargs, **weight,
                                                           terms=True),
                                  f"{label} K3 rng={rng} ({m} rays)", k3p))
    return err


def k5_against_twins(fg, static, pvec, n, lam, g, label, **kwargs) -> tuple:
    """K5f's images and K5b's vjp against the float32 twins: the images
    within 1e-4 of the twin's total and 1e-3 of its largest pixel, the vjp
    within rtol 1e-3, atol 1e-5 of its largest slot. Returns (the images'
    largest difference over the largest pixel, the vjp's over the largest
    slot, the vjp)."""
    image = fg.fused_grad_forward_cuda(static, pvec, n, lam, **kwargs)
    twin = fg.fused_grad_forward_plain(static, pvec, n, lam, **kwargs)
    top = twin.abs().max().item()
    img_err = (image - twin).abs().max().item() / top
    if not (twin.sum().item() > 0 and img_err <= 1e-3
            and abs(image.sum().item() - twin.sum().item()) <= 1e-4 * twin.sum().item()):
        raise AssertionError(f"{label}: K5f differs from its twin ({img_err:.3g} of the "
                             f"largest pixel)")
    grad = fg.fused_grad_vjp_cuda(static, pvec, n, lam, g, **kwargs)
    grad_twin = fg.fused_grad_vjp_plain(static, pvec, n, lam, g, **kwargs)
    scale = grad_twin.abs().max().item()
    torch.testing.assert_close(grad, grad_twin, rtol=1e-3, atol=1e-5 * scale,
                               msg=lambda m: f"{label}: K5b differs from its twin: {m}")
    grad_err = (grad - grad_twin).abs().max().item() / scale
    log(f"{label}: K5f {img_err:.3g} of the largest pixel from its twin, K5b "
        f"{grad_err:.3g} of the largest slot")
    return img_err, grad_err, grad


K1_POINT_BUILDS = {18: "fused_trace_flat_kernel<0>", 19: "fused_trace_flat_kernel<1>",
                   20: "fused_trace_cylinder_kernel<0>", 21: "fused_trace_cylinder_kernel<1>",
                   22: "fused_trace_dense_kernel"}


def k1_build_name(fparams) -> str:
    """The build of K1 the launcher takes for the packed chain, as the
    library says (``xrt_fused_trace_build``): ``fused_trace_kernel<source,
    Chebyshev, stages>`` or one of ``K1_POINT_BUILDS``."""
    from xicsrt_tpu_torch.ops import native

    src = 2 if fparams.plasma else int(fparams.full_source)
    build = native.library().xrt_fused_trace_build(src, int(fparams.cheb), fparams.stages,
                                                   fparams.shapes, int(fparams.dense_images))
    if build in K1_POINT_BUILDS:
        return K1_POINT_BUILDS[build]
    return (f"fused_trace_kernel<{K1_SOURCES[build // 6]}, "
            f"{'Chebyshev, ' * (build % 6 >= 3)}kStages {build % 3}>")


def ptxas_registers(pattern: str) -> str:
    """ptxas's register line of the kernel whose mangled name matches the
    regular expression ``pattern`` (K1a's build:
    ``fused_trace_flat_kernelILi0ELb0E``, the point source with no
    Chebyshev, weight, bilinear or mosaic stage, no torus or cylinder and no
    chunk marks; K1d's: ``fused_trace_flat_kernelILi1ELb0E``)."""
    from xicsrt_tpu_torch.ops import native

    lines = native.ptxas_report().splitlines()
    for i, line in enumerate(lines):
        if re.search(pattern, line):
            for nxt in lines[i + 1:i + 4]:
                if "registers" in nxt:
                    return f"{pattern}: {nxt.strip()}"
    raise AssertionError(f"no ptxas line for {pattern}")


def phase_k5_census(smi, rates: dict, timed: dict) -> None:
    """Phase 45's K5 lines: each K5 chain's census per ray by class
    (``k5_ops_per_ray``, the twins on 8192 rays on the CPU), its class-rate
    serial bound at 2^22 rays from phase 45's rates, and K5f's and K5b's
    times of their phases (``timed``: chain -> (K5f ms, K5b ms)) over it."""
    chains = {"flagship": grad_flagship(1 << 22, 1), **grad_timing_configs(),
              "focused_gaussian_voigt": grad_variant("focused_gaussian_voigt", 1 << 22),
              "file_rocking": grad_variant("file_rocking", 1 << 22),
              "mosaic_sphere": grad_variant("mosaic_sphere", 1 << 22)}
    for name, cfg in chains.items():
        parts = []
        for backward, ms in zip((False, True), timed[name]):
            counts, _ = k5_ops_per_ray(copy.deepcopy(cfg), backward)
            serial = serial_ms(counts, rates, 1 << 22)
            parts.append(f"{'K5b' if backward else 'K5f'} census "
                         + "/".join(f"{counts[c]:.1f}" for c in ("trans", "sqrtdiv", "simple"))
                         + f" (trans/sqrtdiv/simple a ray), serial bound {serial:.4f} ms, "
                         f"measured {ms:.4f} ms ({serial / ms:.3f} of it)")
        log(f"phase 45 K5 {name} on {smi}, 2^22 rays: " + "; ".join(parts))


def phase_k3_mosaic_bounds(smi, rates: dict, timed: dict) -> None:
    """Phase 45's lines for K3 and K1c-mosaic: each timed call's census a
    ray (``timed``: label -> ((census, bytes a ray, rays), measured ms)), its
    class-rate serial bound (the classes' times and the bytes' summed) and
    overlap bound (the largest of them) at phase 45's rates, and the
    measured time over each."""
    for label, ((counts, per_ray, n), ms) in timed.items():
        serial = serial_ms(counts, rates, n, per_ray * n)
        overlap = overlap_ms(counts, rates, n, per_ray * n)
        log(f"phase 45 {label} on {smi}, {n} rays: census "
            + "/".join(f"{counts[c]:.1f}" for c in ("trans", "sqrtdiv", "simple"))
            + f" (trans/sqrtdiv/simple a ray), {per_ray} bytes a ray; serial bound "
            f"{serial:.4f} ms, overlap bound {overlap:.4f} ms; measured {ms:.4f} ms "
            f"({serial / ms:.3f} of serial, {overlap / ms:.3f} of overlap)")


def phase_k1_source_bounds(smi, rates: dict, timed: dict) -> dict:
    """Phase 45's lines for K1b, K1c-mirror, K1c-cylinder and K1
    plasma+torus: each timed
    call's census a ray or ray slot (``chain_ops_per_ray`` of its config,
    the twin on 8192 rays on the CPU; explicit uniforms, so no Philox work
    is counted: K1b's source takes two Philox calls a ray and K1a's one, a
    plasma's slot two),
    its class-rate serial bound at phase 45's rates, and the measured time
    over it (``timed``: key -> (label, config, rays, measured ms)). Returns
    key -> serial ms."""
    out = {}
    for key, (label, cfg, n, ms) in timed.items():
        counts, _ = chain_ops_per_ray(cfg)
        out[key] = serial_ms(counts, rates, n)
        log(f"phase 45 {label} on {smi}, {n} rays: census "
            + "/".join(f"{counts.get(c, 0.0):.1f}" for c in ("trans", "sqrtdiv", "simple"))
            + f" (trans/sqrtdiv/simple a ray); serial bound {out[key]:.4f} ms; "
            f"measured {ms:.4f} ms ({out[key] / ms:.3f} of serial)")
    return out


def phase_long_chains(smi, ft, fg, engine, raytrace) -> dict:
    """Phase 49: the long optic chains (``tools/bench_scenarios.
    baffle_config``). K1 on ``baffle127`` (127 optics) in mc and weight
    mode and with bilinear images, K1e 'found' and K3 on it, against their
    twins at 2^18 rays in both RNG modes; ``baffle127`` at 2^26 x 4 through
    ``raytrace(config, device='cuda')`` on the fused engine (K1 counted
    around the run) against the eager engine at 2^22 x 4, and with 'found'
    history; K1's ms per 2^22 rays beside its bound over the rays alive
    into each optic; K3 through ``build_fused_trace_run`` at 2^22 rays
    (counted around the run) and its time on those rays; K5f and K5b on
    ``baffle42`` (42 optics: K5b's replay build) against their
    twins at 2^18 rays, one forward and vjp step of
    ``make_fused_differentiable`` at 2^22 x 4 (counted around it), and
    their times per 2^22 rays, with K5b's layout and optic forwards a ray;
    K5b on the flagship in its recomputing and its replay build, in
    turns."""
    from xicsrt_tpu_torch.gradients import make_fused_differentiable
    from xicsrt_tpu_torch.ops import native
    from xicsrt_tpu_torch.tools.roofline import optic_k1_ops

    n = 1 << 18
    k1_err = k3_err = 0.0
    for mode in ("mc", "weight", "bilinear"):
        cfg = BS.baffle_config(124, n, 1, engine="fused", **WEIGHT_MODES.get(mode, {}))
        if mode == "mc":  # K1, K1e 'found' and K3
            k1_err = long_chain_against_twins(ft, engine, cfg, "phase 49 baffle127", 49)
        else:
            k1_err = max(k1_err, k1_build_against_twin(
                ft, engine, cfg, f"phase 49 baffle127 K1 {mode}", 49))

    # The main path at full width, counters read around each call.
    budget = 2**26 * 4
    big = BS.baffle_config(124, 2**26, 4, engine="fused")
    ft.fused_run_cuda.launches = 0
    fused = raytrace(copy.deepcopy(big), device="cuda")
    k1_launches = ft.fused_run_cuda.launches
    if k1_launches <= 0:
        raise AssertionError("phase 49: baffle127's fused run did not launch K1")
    meta = {k: v["num_out"] for k, v in fused["total"]["meta"].items()}
    if meta["source"] != budget or len(meta) != 128:
        raise AssertionError(f"phase 49: baffle127's source {meta['source']} of {budget}, "
                             f"{len(meta)} elements")
    counts = list(meta.values())
    if any(b > a for a, b in zip(counts, counts[1:])):
        raise AssertionError("phase 49: an element of baffle127 counts more than the last")
    eager = raytrace(BS.baffle_config(124, 2**22, 4, engine="xla", keep_history=False),
                     device="cuda")
    engines_agree(fused, eager, "phase 49 baffle127 fused at 2^26 x 4 and eager at 2^22 x 4",
                  (budget, 2**24))
    fused_ms = cuda_ms(lambda: raytrace(copy.deepcopy(big), device="cuda"), 3)
    found_cfg = BS.baffle_config(124, 2**26, 4, engine="fused", keep_history="found")
    pipe = engine.Pipeline(found_cfg, device="cuda")
    spec = ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, 8, "found")
    ft.fused_run_cuda.launches = 0
    found = raytrace(copy.deepcopy(found_cfg), device="cuda")
    found_launches = ft.fused_run_cuda.launches
    n_found = check_found(found, pipe, spec, "phase 49 baffle127 'found'")
    totals_equal(found, fused, "phase 49 baffle127 'found' against the call without history")
    found_ms = cuda_ms(lambda: raytrace(copy.deepcopy(found_cfg), device="cuda"), 3)
    log(f"phase 49 baffle127 at 2^26 x 4 on {smi}: fused {budget / fused_ms * 1e3:.4g} rays/s "
        f"({fused_ms:.2f} ms a call), K1 launches {k1_launches}; 'found' "
        f"{budget / found_ms * 1e3:.4g} rays/s ({found_ms:.2f} ms), K1 launches "
        f"{found_launches}, {n_found} found rays; detector {meta['detector']} "
        f"({meta['detector'] / budget:.6f} of the rays), the first plate kept "
        f"{meta['baffle000']}")

    n = 1 << 22
    fparams = k1_pack(engine.Pipeline(BS.baffle_config(124, n, 1, engine="fused"),
                                      device="cuda"))
    k1 = k1_timing(ft, fparams, n, smi, "K1 on baffle127 (127 optics)", "49")
    # K1's cost a plate: baffle127 less the flagship it puts behind 124
    # plates, both in the flat build, at the same rays.
    fl_fparams = k1_pack(engine.Pipeline(flagship(n, 1, engine="fused"), device="cuda"))
    k1a_ms = cuda_ms(lambda: ft.fused_run_cuda(fl_fparams, n, n, seed=(1, 2)), 20)
    k1["ms_a_plate"] = (k1["ms"] - k1a_ms) / 124
    log(f"phase 49 K1 a plate on {smi}: (baffle127 {k1['ms']:.4f} ms - the flagship "
        f"{k1a_ms:.4f} ms) / 124 = {k1['ms_a_plate']:.5f} ms a plate per {n} rays")
    head = native.library().xrt_head_floats_of(fparams.fp.numel(), fparams.ip.numel())
    log(f"phase 49 baffle127's build {k1_build_name(fparams)}, head {4 * head} bytes "
        f"({fparams.fp.numel()} floats, {fparams.ip.numel()} ints)")

    # K3 behind the eager source, counted around one run of its runner.
    k3_cfg = BS.baffle_config(124, n, 1, engine="fused")
    k3_pipe = engine.Pipeline(k3_cfg, device="cuda")
    run = ft.build_fused_trace_run(k3_pipe)
    ft.fused_trace_run_cuda.launches = 0
    out = run(k3_pipe.params, torch.Generator(device="cuda").manual_seed(49))
    k3_launches = ft.fused_trace_run_cuda.launches
    k3_meta = [int(v) for v in out["meta"].values()]
    if k3_launches <= 0 or k3_meta[0] != n or k3_meta[-1] <= 0:
        raise AssertionError(f"phase 49: K3's run on baffle127: launches {k3_launches}, "
                             f"meta {k3_meta[:2]} ... {k3_meta[-2:]}")
    k3p = k3_pack(ft, k3_pipe)
    rays = eager_rays(k3_pipe, 50)
    args = (k3p, rays.origin, rays.direction, rays.wavelength, rays.mask)
    ck, ik = ft.fused_trace_run_cuda(*args, seed=(1, 2))
    cp, iq = ft.fused_trace_run_plain(*args, seed=(1, 2))
    k3_err = twin_equal((ck, ik), (cp, iq), "phase 49 K3 on baffle127's 2^22 eager rays")
    k3_ms = cuda_ms(lambda: ft.fused_trace_run_cuda(*args, seed=(1, 2)), 20)
    k3_plain_ms = cuda_ms(lambda: ft.fused_trace_run_plain(*args, seed=(1, 2)), 2)
    alive_into = ck[:k3p.n_optics].tolist()
    k3_bytes = (29 * n + packed_bytes(k3p.fp, k3p.ip) + k3p.img_total * 4
                + 8 * (1 + k3p.n_optics))
    k3_bound = bound(k3_bytes, sum(o * r for o, r in zip(optic_k1_ops(k3p), alive_into)))
    k3_bound_flat = bound(k3_bytes, chain_k1_ops(k3p) * n)
    log(f"phase 49 timings on {smi}: K3 on baffle127 {k3_ms:.4f} ms vs twin "
        f"{k3_plain_ms:.4f} ms ({n} rays, Philox); bound {k3_bound[0]:.4f} ms "
        f"({k3_bound[1]}, the rays alive into each optic; flat {k3_bound_flat[0]:.4f} ms)")

    # K5f and K5b on baffle42.
    n = 1 << 18
    pipe = engine.Pipeline(BS.baffle_config(39, n, 1, interact_mode="weight",
                                            image_mode="bilinear"), device="cuda")
    _, _, pack, spec = fg.build_fused_diff(pipe)
    static, lam = spec["static"], spec["lam"]
    pvec = pack(pipe.params).detach()
    gen = torch.Generator(device="cuda").manual_seed(42)
    uniforms = torch.rand((static.n_draws, n), generator=gen, device="cuda")
    g = torch.randn(static.img_total, device="cuda", generator=gen)
    k5_err = [0.0, 0.0]
    for kwargs in ({"seed": (8, 9)}, {"uniforms": uniforms}):
        e_f, e_b, _ = k5_against_twins(fg, static, pvec, n, lam, g,
                                       f"phase 49 baffle42 {list(kwargs)[0]}", **kwargs)
        k5_err = [max(k5_err[0], e_f), max(k5_err[1], e_b)]
    layout = fg.k5b_layout(static, pvec.numel(), 1 << 22)
    fg.fused_grad_forward_cuda.launches = 0
    fg.fused_grad_vjp_cuda.launches = 0
    forward, vjp, pack, gpipe = make_fused_differentiable(
        BS.baffle_config(39, 2**22, 4, interact_mode="weight", image_mode="bilinear"),
        device="cuda")
    pvec0 = pack(gpipe.params).detach()
    images = forward(pvec0, 42)["image"]
    gvec = vjp(pvec0, 42, {k: torch.ones_like(v) for k, v in images.items()})
    torch.cuda.synchronize()
    k5_launches = (fg.fused_grad_forward_cuda.launches, fg.fused_grad_vjp_cuda.launches)
    if k5_launches != (1, 1):
        raise AssertionError(f"phase 49: baffle42's step launched K5f, K5b {k5_launches}")
    if not (all(torch.isfinite(v).all() and v.sum() > 0 for v in images.values())
            and torch.isfinite(gvec).all() and gvec.abs().max() > 0):
        raise AssertionError("phase 49: baffle42's step gave bad images or gradients")
    step_ms = cuda_ms(lambda: vjp(pvec0, 3, forward(pvec0, 3)["image"]), 3)
    n = 1 << 22
    _, _, pack22, spec22 = fg.build_fused_diff(engine.Pipeline(
        BS.baffle_config(39, n, 1, interact_mode="weight", image_mode="bilinear"),
        device="cuda"))
    st22, lam22 = spec22["static"], spec22["lam"]
    pv22 = pack22(gpipe.params).detach()
    g22 = torch.randn(st22.img_total, device="cuda", generator=gen)
    k5f_ms = cuda_ms(lambda: fg.fused_grad_forward_cuda(st22, pv22, n, lam22, seed=(1, 2)), 10)
    k5b_ms = cuda_ms(lambda: fg.fused_grad_vjp_cuda(st22, pv22, n, lam22, g22, seed=(1, 2)), 5)
    k5f_plain_ms = cuda_ms(lambda: fg.fused_grad_forward_plain(
        st22, pv22, n, lam22, seed=(1, 2), chunk=1 << 20), 1)
    k5b_plain_ms = cuda_ms(lambda: fg.fused_grad_vjp_plain(
        st22, pv22, n, lam22, g22, seed=(1, 2), chunk=1 << 20), 1)
    k5_bytes = packed_bytes(st22.fp, st22.ip, pv22) + st22.img_total * 4
    k5f_bound = bound(k5_bytes, k5_ops(st22, False) * n)
    k5b_bound = bound(k5_bytes + pv22.numel() * 4, k5_ops(st22, True) * n)
    states_bytes = 4 * layout["blocks"] * layout["device_floats"]
    forwards = fg.k5b_forwards(st22.n_optics, layout["build"])
    # K5b on the flagship's 2^22 rays in the recomputing build (the
    # launcher's for short chains) and the replay build, in turns.
    fl_pipe = engine.Pipeline(grad_flagship(n, 1), device="cuda")
    _, _, fl_pack, fl_spec = fg.build_fused_diff(fl_pipe)
    fl_st, fl_lam = fl_spec["static"], fl_spec["lam"]
    fl_pv = fl_pack(fl_pipe.params).detach()
    fl_g = torch.randn(fl_st.img_total, device="cuda", generator=gen)
    fl_ms = {"recompute": [], "replay": []}
    for fl_build in ("recompute", "replay", "replay", "recompute"):
        fl_ms[fl_build].append(cuda_ms(lambda: fg.fused_grad_vjp_cuda(
            fl_st, fl_pv, n, fl_lam, fl_g, seed=(1, 2), _build=fl_build), 20))
    log(f"phase 49 K5b on the flagship's 2^22 rays on {smi}: the recomputing build "
        f"{fl_ms['recompute'][0]:.4f}, {fl_ms['recompute'][1]:.4f} ms; the replay build "
        f"{fl_ms['replay'][0]:.4f}, {fl_ms['replay'][1]:.4f} ms (in turns)")
    log(f"phase 49 timings on {smi}: K5f on baffle42 {k5f_ms:.4f} ms vs twin "
        f"{k5f_plain_ms:.4f} ms, bound {k5f_bound[0]:.4f} ms ({k5f_bound[1]}); K5b "
        f"{k5b_ms:.4f} ms vs twin {k5b_plain_ms:.4f} ms, bound {k5b_bound[0]:.4f} ms "
        f"({k5b_bound[1]}; one forward and one adjoint a ray); K5b as built: the "
        f"{layout['build']} build (saved states in {layout['states']} memory), {forwards} "
        f"optic forwards and "
        f"{st22.n_optics} adjoints a ray (the recomputing build: "
        f"{fg.k5b_forwards(st22.n_optics, 'recompute')}), {layout['blocks']} blocks of "
        f"{layout['threads']} threads, saved states in device memory {states_bytes} bytes, "
        f"{layout['smem']} bytes of dynamic shared memory; forward+vjp step "
        f"{2**24 / step_ms * 1e3:.4g} rays/s ({step_ms:.2f} ms for 2^24 rays); launches K5f "
        f"{k5_launches[0]}, K5b {k5_launches[1]}")
    return {"k1": dict(k1, launches=k1_launches, err=k1_err, rays_per_s=budget / fused_ms * 1e3,
                       found_rays_per_s=budget / found_ms * 1e3, found_launches=found_launches),
            "k3": {"launches": k3_launches, "err": k3_err, "ms": k3_ms,
                   "plain_ms": k3_plain_ms, "bound": k3_bound, "bound_flat": k3_bound_flat},
            "k5f": {"launches": k5_launches[0], "err": k5_err[0], "ms": k5f_ms,
                    "plain_ms": k5f_plain_ms, "bound": k5f_bound},
            "k5b": {"launches": k5_launches[1], "err": k5_err[1], "ms": k5b_ms,
                    "plain_ms": k5b_plain_ms, "bound": k5b_bound, "build": layout["build"],
                    "states": layout["states"],
                    "forwards_a_ray": forwards, "states_bytes": states_bytes,
                    "step_ms_2_24": step_ms, "flagship_ms_recompute": min(fl_ms["recompute"]),
                    "flagship_ms_replay": min(fl_ms["replay"])}}


def ptxas_entries(report: str, pattern: str) -> list:
    """(name, registers, spill store bytes, spill load bytes, stack frame
    bytes) of each kernel in ptxas's report whose mangled name matches the
    regular expression ``pattern``; its first group is the name."""
    out, name, spills = [], None, (0, 0, 0)
    for line in report.splitlines():
        if "Compiling entry" in line:
            m = re.search(pattern, line)
            name, spills = (m.group(1) if m else None), (0, 0, 0)
            continue
        s = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if name and s:
            spills = (int(s.group(2)), int(s.group(3)), int(s.group(1)))
        r = re.search(r"Used (\d+) registers", line)
        if name and r:
            out.append((name, int(r.group(1)), *spills))
            name = None
    return out


def resident_warps(registers: int, threads: int) -> int:
    """Warps of ``threads``-thread blocks a multiprocessor holds at this
    register count (65536 registers, allocated per warp in units of 256, at
    most 64 warps), by registers alone."""
    per_warp = -(-registers * 32 // 256) * 256
    blocks = min(65536 // (per_warp * (threads // 32)), 64 // (threads // 32))
    return blocks * (threads // 32)


K5B_SOURCES = ("point", "plasma", "generic")
# K1's source builds (kSrc, csrc/fused_run.cuh).
K1_SOURCES = ("point", "generic", "plasma")
# K5f's images: example 07's chain (1200 floats) and example 08's (20100).
K5F_IMAGES = (1200, 20100)
# The flagship's images: K1's 15000 floats (100 x 100 and 100 x 50), and
# the largest of K2's one launch for both (100 x 100), or the detector's
# alone (100 x 50).
FLAGSHIP_IMG_FLOATS = 15000
K2_IMAGES = (10000, 5000)


def k1_ptxas_builds(report: str) -> list:
    """(kernel, (src, cheb, stages, mark, shapes, dense), registers, spill
    stores, spill loads, stack frame) of every build of K1 in ptxas's
    report: the launcher's arguments that take it (``xrt_fused_pick``)."""
    out = []
    for kernel in ("fused_trace_kernel", "fused_trace_flat_kernel",
                   "fused_trace_cylinder_kernel", "fused_trace_dense_kernel"):
        for args, *rest in ptxas_entries(report, kernel + r"(I\w+?E)E"):
            t = [int(x) for x in re.findall(r"L[bi](\d+)E", args)]
            if kernel == "fused_trace_kernel":  # <src, cheb, stages, mark>: every shape
                build = (*t, 3, 0)
            elif kernel == "fused_trace_dense_kernel":  # <mark>
                build = (0, 0, 0, t[0], 0, 1)
            else:  # <stages, mark>
                build = (0, 0, t[0], t[1], 2 if "cylinder" in kernel else 0, 0)
            out.append((kernel, build, *rest))
    return out


def k5_variants(report: str, kernel: str) -> list:
    """(variant, name, registers, spill stores, spill loads, stack frame) of
    every build of the K5 ``kernel`` (a regular expression) in ptxas's
    report."""
    out = []
    for args, regs, stores, loads, frame in ptxas_entries(report, kernel + r"(I\w+?E)E"):
        torus, cylinder, source, mosaic = (
            int(x) for x in re.findall(r"L[bi](\d+)E", args))
        variant = (torus | (cylinder << 1) | (source << 2)) + 12 * mosaic
        name = (K5B_SOURCES[source] + " +torus" * torus + " +cylinder" * cylinder
                + " +mosaic" * mosaic)
        out.append((variant, name, regs, stores, loads, frame))
    return sorted(out)


def phase_registers(native) -> None:
    """Phase 2's summary from ptxas's report: registers, spills, stack frame
    and block size of every K5f and K5b variant, with the warps their
    registers leave resident, of every build of K1, K2 and K3 and of R2; for
    K1 and K2 also the warps their launch's shared memory leaves resident
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor as the launcher calls
    it: K1 at the flagship's images, K2 at a launch whose largest image is
    100 x 100 or 100 x 50) and the smaller of the two; a K5f, K5b, K1 or K3
    build that spills fails."""
    from xicsrt_tpu_torch import engine

    report = native.ptxas_report()
    lib = native.library()
    spilled = []
    # The flagship's packed buffers: the head of every launch below.
    fl = k1_pack(engine.Pipeline(flagship(1 << 10, 1, engine="fused"), device="cuda"))
    n_fp, n_ip = fl.fp.numel(), fl.ip.numel()
    for variant, name, regs, stores, loads, frame in k5_variants(
            report, r"fused_grad_fwd_kernel(?:_64)?"):
        threads = [lib.xrt_fused_grad_fwd_threads(variant, img, n_fp, n_ip)
                   for img in K5F_IMAGES]
        log(f"phase 2 K5f variant {variant:2d} ({name}): {regs} registers, {stores} / {loads} "
            f"bytes spilled (stores / loads), {frame} bytes stack frame, "
            f"{threads[0]} / {threads[1]} threads a block for images of "
            f"{K5F_IMAGES[0]} / {K5F_IMAGES[1]} floats behind the flagship's head, "
            f"{resident_warps(regs, threads[0])} warps a multiprocessor by registers")
        if stores or loads:
            spilled.append(f"K5f {name}")
    for kernel, build in (("fused_grad_bwd_kernel", "recomputing"),
                          ("fused_grad_replay_kernel", "replay")):
        for variant, name, regs, stores, loads, frame in k5_variants(report, kernel):
            threads = lib.xrt_fused_grad_bwd_threads(variant)
            log(f"phase 2 K5b variant {variant:2d} ({name}, {build} build): {regs} registers, "
                f"{stores} / {loads} bytes spilled (stores / loads), {frame} bytes stack "
                f"frame, {threads} threads a block, {resident_warps(regs, threads)} warps a "
                f"multiprocessor by registers")
            if stores or loads:
                spilled.append(f"K5b {name} ({build})")
    for kernel, args, regs, stores, loads, frame in k1_ptxas_builds(report):
        src, cheb, stages, mark, shapes, dense = args
        what = {"fused_trace_flat_kernel": ", no torus or cylinder",
                "fused_trace_cylinder_kernel": ", cylinder, no torus",
                "fused_trace_dense_kernel": ", no torus or cylinder, dense images"}
        name = (f"({K1_SOURCES[src]} source, {'Chebyshev, ' * cheb}kStages "
                f"{stages}{what.get(kernel, '')}{', marks' * mark}: {kernel})")
        occupancy = (lib.xrt_fused_trace_marked_occupancy if mark
                     else lib.xrt_fused_trace_occupancy)
        dyn = ctypes.c_int(0)
        blocks = occupancy(src, cheb, stages, shapes, dense, 0, 0, FLAGSHIP_IMG_FLOATS,
                           n_fp, n_ip, ctypes.byref(dyn))
        threads = lib.xrt_fused_trace_threads(src, cheb, stages)
        by_regs, at_launch = resident_warps(regs, threads), blocks * threads // 32
        log(f"phase 2 K1 build {name}: {regs} registers, {stores} / {loads} bytes "
            f"spilled, {frame} bytes stack frame, {threads} threads a block, "
            f"{by_regs} warps a multiprocessor by registers, {at_launch} at the "
            f"flagship's launch ({FLAGSHIP_IMG_FLOATS} image floats, {dyn.value} bytes of "
            f"dynamic shared memory): {min(by_regs, at_launch)} resident")
        if stores or loads:
            spilled.append(f"K1 {name}")
        if blocks <= 0:
            raise AssertionError(f"phase 2: K1 {name}: no block resident at its launch")
    for args, regs, stores, loads, frame in ptxas_entries(report,
                                                          r"bin_images_kernel(I\w+?E)E"):
        unit = int(re.findall(r"Lb(\d+)E", args)[0])
        by_regs = resident_warps(regs, 256)
        warps = {pix: 8 * lib.xrt_bin_images_occupancy(pix, unit) for pix in K2_IMAGES}
        log(f"phase 2 K2 build ({'unit' if unit else 'float'} weights): {regs} registers, "
            f"{stores} / {loads} bytes spilled, {frame} bytes stack frame, 256 threads a "
            f"block, {by_regs} warps a multiprocessor by registers, "
            + ", ".join(f"{w} at a launch whose largest image is {pix} pixels"
                        for pix, w in warps.items())
            + f": {min(by_regs, *warps.values())} resident")
    for args, regs, stores, loads, frame in ptxas_entries(report,
                                                          r"trace_only_kernel(I\w+?E)E"):
        cheb, stages = (int(x) for x in re.findall(r"L[bi](\d+)E", args))
        name = f"({'Chebyshev, ' * cheb}kStages {stages})"
        log(f"phase 2 K3 build {name}: {regs} registers, {stores} / {loads} bytes "
            f"spilled, {frame} bytes stack frame, 256 threads a block, "
            f"{resident_warps(regs, 256)} warps a multiprocessor by registers")
        if stores or loads:
            spilled.append(f"K3 {name}")
    for name, regs, stores, loads, frame in ptxas_entries(report, r"(mma_rate_kernel)"):
        log(f"phase 2 R2 {name}: {regs} registers, {stores} / {loads} bytes spilled, "
            f"{resident_warps(regs, 256)} warps a multiprocessor by registers")
    serial = [line.strip() for line in report.splitlines() if "wgmma" in line]
    log("phase 2 ptxas on wgmma: " + ("; ".join(serial) if serial else "no serialisation noted"))
    if spilled:
        raise AssertionError(f"phase 2: registers spill in {spilled}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = tool_version(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"])
    log(smi)
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc {tool_version(['nvcc', '--version'])}, "
        f"Triton {triton_version}")

    import xicsrt_tpu_torch
    from xicsrt_tpu_torch import engine
    from xicsrt_tpu_torch.ops import bundle_gather as bg
    from xicsrt_tpu_torch.ops import fused_grad as fg
    from xicsrt_tpu_torch.ops import fused_trace as ft
    from xicsrt_tpu_torch.ops import native
    from xicsrt_tpu_torch.ops.pallas_binning import (bin_image_plain, bin_images_cuda,
                                                     bin_images_plain)

    t0 = time.perf_counter()
    lib_path = native.build()
    native.library()
    log(f"phase 2 build: {lib_path} in {time.perf_counter() - t0:.1f} s\n"
        f"{native.ptxas_report()}")
    phase_registers(native)

    k2_err = phase_k2(bin_image_plain)
    k1_err, fparams = phase_k1a(ft, engine)

    # Phase 5: the main path, fused engine, counters read around this run.
    fused_cfg = flagship(2**26, 4, engine="fused")
    budget = 2**26 * 4
    ft.fused_run_cuda.launches = 0
    bin_images_cuda.launches = 0
    fused_res = xicsrt_tpu_torch.raytrace(fused_cfg, device="cuda")
    k1_launches = ft.fused_run_cuda.launches
    if k1_launches <= 0:
        raise AssertionError("the fused main path did not launch K1a")
    fused_meta = check_main_path(fused_res, budget, "phase 5 fused")

    # Phase 6: the eager engine binning with K2.
    eager_cfg = flagship(2**22, 4, engine="xla", binning="pallas")
    ft.fused_run_cuda.launches = 0
    bin_images_cuda.launches = 0
    eager_res = xicsrt_tpu_torch.raytrace(eager_cfg, device="cuda")
    k2_launches = bin_images_cuda.launches
    if k2_launches != 4:
        raise AssertionError(f"the eager main path launched K2 {k2_launches} times, "
                             f"not once for each of its 4 iterations' two images")
    eager_meta = check_main_path(eager_res, 2**24, "phase 6 eager+K2")
    p1 = fused_meta["detector"] / fused_meta["source"]
    p2 = eager_meta["detector"] / eager_meta["source"]
    pooled = (fused_meta["detector"] + eager_meta["detector"]) / (
        fused_meta["source"] + eager_meta["source"])
    sigma = math.sqrt(pooled * (1 - pooled) * (1 / fused_meta["source"]
                                               + 1 / eager_meta["source"]))
    if abs(p1 - p2) > 5 * sigma:
        raise AssertionError(f"engines disagree: {p1} vs {p2} (sigma {sigma})")
    log(f"phase 6 engines agree: {p1:.6f} vs {p2:.6f}, {abs(p1 - p2) / sigma:.2f} sigma")

    # Phase 7: timings, CUDA events after a warm-up.
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = 1 << 22
    nx, ny, ps = FLAGSHIP_IMAGES[0]
    xl, mask, _ = hits(n, nx, ny, ps, gen)
    dense = [(xl, mask, torch.ones(n, device="cuda"), nx, ny, ps)]
    # K2 as every row is timed (CUDA events around calls issued back to
    # back: a call shorter than its issue times the host), on the card
    # alone (device_ms) and torch.bincount's kernels alone (kernel_ms: its
    # range check waits on the host, which device_ms would time).
    # Dense hits, one 100x100 image: the row's input before the main path's.
    k2_dense_ms = cuda_ms(lambda: bin_images_cuda(dense), 20)
    k2_dense_plain_ms = cuda_ms(lambda: bin_images_plain(dense), 20)
    (index, weights, pixels), = bincount_inputs(dense)
    k2_dense_library_ms = cuda_ms(lambda: torch.bincount(index, weights, minlength=pixels), 20)
    k2_dense_bound = bound(n * (12 + 1 + 4) + nx * ny * 4, 10 * n)
    del dense, index, weights
    # The main path's own input: one eager iteration's two images, one
    # launch, unit weights, beside torch.bincount of the same set rays.
    items = eager_image_items(n)
    k2_main_ms = cuda_ms(lambda: bin_images_cuda(items, unit_weights=True), 20)
    k2_main_card_ms = device_ms(lambda: bin_images_cuda(items, unit_weights=True), 20)
    k2_main_plain_ms = cuda_ms(lambda: bin_images_plain(items, unit_weights=True), 20)
    counted = bincount_inputs(items)

    def library():
        return [torch.bincount(i, w, minlength=p) for i, w, p in counted]

    k2_main_library_ms = cuda_ms(library, 20)
    k2_main_library_card_ms = kernel_ms(library, 20)
    k2_main_bound = k2_bound(items)
    n_set = sum(int(m.sum()) for _, m, *_ in items)
    del items, counted
    k1_bound, k1_bound_flat = k1_bounds(fparams, n)
    k1_ms = cuda_ms(lambda: ft.fused_run_cuda(fparams, n, n, seed=(1, 2)), 20)
    k1_plain_ms = cuda_ms(lambda: ft.fused_run_plain(fparams, n, n, seed=(1, 2)), 5)
    fused_ms = cuda_ms(lambda: xicsrt_tpu_torch.raytrace(fused_cfg, device="cuda"), 3)
    eager_ms = cuda_ms(lambda: xicsrt_tpu_torch.raytrace(eager_cfg, device="cuda"), 3)
    library_card = ("not measured (the profiler recorded no device time)"
                    if k2_main_library_card_ms is None else f"{k2_main_library_card_ms:.4f} ms")
    log(f"phase 7 timings on {smi}: K2 {k2_dense_ms:.4f} ms vs twin {k2_dense_plain_ms:.4f} "
        f"ms and torch.bincount on precomputed indices {k2_dense_library_ms:.4f} ms "
        f"(2^22 rays, 90 % set, 100x100; bound {k2_dense_bound[0]:.4f} ms; calls back to "
        f"back); K2 on the main path's input (one eager iteration's two images, {n_set} of "
        f"2 x {n} rays set, one launch) {k2_main_ms:.4f} ms vs twin {k2_main_plain_ms:.4f} "
        f"ms and torch.bincount {k2_main_library_ms:.4f} ms (calls back to back, the host "
        f"in them), on the card alone K2 {k2_main_card_ms:.4f} ms (queued behind a spin "
        f"kernel) and torch.bincount's kernels {library_card} (profiler), bound "
        f"{k2_main_bound[0]:.4f} ms ({k2_main_bound[1]}); K1a {k1_ms:.4f} ms vs twin "
        f"{k1_plain_ms:.4f} ms (2^22 flagship rays, Philox), bound {k1_bound[0]:.4f} ms "
        f"({k1_bound[1]}, the rays alive into each optic; flat {k1_bound_flat[0]:.4f} ms); "
        f"raytrace fused {budget / fused_ms * 1e3:.4g} "
        f"rays/s ({fused_ms:.2f} ms for {budget} rays); raytrace eager+K2 "
        f"{2**24 / eager_ms * 1e3:.4g} rays/s ({eager_ms:.2f} ms for {2**24} rays)")

    grad = gradient_phases(smi, fg, engine)
    plasma = plasma_phases(smi, ft, bg, engine, xicsrt_tpu_torch.raytrace)
    curved = curved_phases(smi, ft, fg, engine, xicsrt_tpu_torch.raytrace, fparams)
    torus = curved["timings"]["torus"]
    k1b = phase_k1b(smi, ft, engine)
    k1b["err"] = max(k1b["err"], phase_k1_source_builds(ft, engine))
    k1b_launches = phase_source_matrix(ft, engine, xicsrt_tpu_torch.raytrace)
    k3 = phase_k3(smi, ft, engine, xicsrt_tpu_torch.raytrace)
    from xicsrt_tpu_torch.gradients import make_fused_differentiable

    k5s = phase_k5_source_matrix(smi, fg, engine, make_fused_differentiable)
    mirror_launches, mirror_err = phase_mirrors(ft, engine, xicsrt_tpu_torch.raytrace)
    file_launches, file_err = phase_file(ft, engine, xicsrt_tpu_torch.raytrace)
    k5file = phase_k5_file(smi, fg, engine, make_fused_differentiable)
    mesh_launches, mesh_err = phase_meshes(ft, engine, xicsrt_tpu_torch.raytrace)
    mosaic15 = phase_mosaic15(ft, xicsrt_tpu_torch.raytrace)
    k1d_launches = phase_weight_images(ft, xicsrt_tpu_torch.raytrace, fused_meta)
    for kind, n_g, iters in (("fused", 1 << 22, 4), ("xla", 1 << 20, 4)):
        result, _, launches = timed_raytrace(xicsrt_tpu_torch.raytrace,
                                             mosaic_golden_config(kind, n_g, iters),
                                             ft.fused_run_cuda)
        if launches != int(kind == "fused"):
            raise AssertionError(f"phase 35: the mosaic golden's config on {kind} launched "
                                 f"K1 {launches} times")
        golden_check(result, "mosaic", f"phase 35 mosaic golden, engine {kind}, "
                     f"{n_g * iters} rays; K1 launches {launches}")
    k1d_err = phase_k1d_mosaic_twins(ft, engine)
    k5d = phase_k5d(smi, fg, ft, engine, make_fused_differentiable)
    k3w = phase_k3_weight(smi, ft, engine, xicsrt_tpu_torch.raytrace)

    # Phase 31: the new stages' times per 2^22 rays, and K1a's beside them.
    n = 1 << 22

    def packed(cfg):
        return k1_pack(engine.Pipeline(cfg, device="cuda"))

    fp_mirror = packed(mirror_configs(n, 1, "fused")["flagship_no_check"])
    fp_file = packed(file_crystal_config(n, 1, "fused"))
    picks = {}
    for label, fp_, want in (("K1a", fparams, "fused_trace_flat_kernel<0>"),
                             ("K1c-mirror", fp_mirror, "fused_trace_dense_kernel"),
                             ("K1c-file", fp_file, "fused_trace_flat_kernel<0>")):
        picks[label] = k1_build_name(fp_)
        log(f"phase 31 {label}'s chain: Chebyshev {fp_.cheb}, stages {fp_.stages}, shapes "
            f"{fp_.shapes}, dense images {fp_.dense_images}: the launcher picks "
            f"{picks[label]} ({want} wanted)")
        if picks[label] != want:
            raise AssertionError(f"phase 31: {label}'s chain takes {picks[label]}")
    t_mirror = k1_timing(ft, fp_mirror, n, smi, "K1c-mirror (the flagship, its crystal unchecked)")
    t_file = k1_timing(ft, fp_file, n, smi, "K1c-file (the flagship's file crystal)")
    cls, kw = MESH_CRYSTALS["mesh_sphere"]
    t_cheb = k1_timing(ft, packed(mesh_config(n, 1, "fused", cls, **kw)), n, smi,
                       "K1c-cheb (example 06's mesh crystal)")
    t_k1a = k1_timing(ft, fparams, n, smi, "K1a (the flagship)")
    log(f"phase 31 K1a build: {ptxas_registers('fused_trace_flat_kernelILi0ELb0E')}; "
        f"K1c-mirror's: {ptxas_registers('fused_trace_dense_kernelILb0E')}")

    # Phase 38: this slice's stages per 2^22 rays beside K1a, and the
    # registers of their builds.
    t_weight = k1_timing(ft, packed(flagship(n, 1, engine="fused", interact_mode="weight")),
                         n, smi, "K1d weight mode (the flagship)", "38")
    t_bilinear = k1_timing(ft, packed(flagship(n, 1, engine="fused", image_mode="bilinear")),
                           n, smi, "K1d bilinear images (the flagship)", "38")
    for t, general in ((t_weight, {"interact_mode": "weight"}),
                       (t_bilinear, {"image_mode": "bilinear"})):
        t["image_adds"] = k1d_image_adds(general)
    t_mosaic = {}
    for mode in ("mc", "weight"):
        cfg_m = mosaic15_config(n, 1, "fused", interact_mode=mode)
        fp_m = packed(cfg_m)
        ops, work = mosaic_k1_ops(fp_m, n, mode == "weight")
        log(f"phase 38 mosaic15 {mode}, {n} rays: {work}")
        mosaic_slots(work, n, mode == "weight")
        t_mosaic[mode] = k1_timing(ft, fp_m, n, smi, f"K1c-mosaic {mode} (mosaic15)", "38",
                                   ops)
        t_mosaic[mode]["census"] = mosaic_ops_as_run(cfg_m, work, n)
    t_k1a_again = k1_timing(ft, fparams, n, smi, "K1a (the flagship), again", "38")
    for pattern in ("fused_trace_flat_kernelILi1ELb0E", "fused_trace_kernelILi0ELb0ELi1ELb0E",
                    "fused_trace_kernelILi0ELb0ELi2ELb0E",
                    "trace_only_kernelILb0ELi0E",
                    "trace_only_kernelILb0ELi1E",
                    "trace_only_kernelILb0ELi2E",
                    "fused_grad_bwd_kernelILb0ELb0ELi0ELb1E",
                    "fused_grad_bwd_kernelILb0ELb0ELi0ELb0E"):
        log(f"phase 38 ptxas {ptxas_registers(pattern)}")

    # Phases 39-42: the history reservoir K1e, and the file entry point.
    k1e_err, probe_err = phase_k1e_twins(ft, engine)
    k1e = phase_k1e_flagship(smi, ft, engine, xicsrt_tpu_torch.raytrace)
    phase_k1e_plasma(ft, engine, xicsrt_tpu_torch.raytrace)
    phase_cli(xicsrt_tpu_torch.raytrace)
    for pattern in ("fused_trace_flat_kernelILi0ELb1E", "fused_trace_flat_kernelILi1ELb1E",
                    "history_record_kernel", "history_probe_kernel"):
        log(f"phase 40 ptxas {ptxas_registers(pattern)}")
    # Phases 43-45: the roofline's probes R1 and R2, then the roofline tool,
    # counters read around its run.
    r1 = phase_r1(smi)
    r2 = phase_r2(smi)
    roof = phase_roofline(smi)
    timings = curved["timings"]
    phase_k5_census(smi, roof["roofline"]["rates"], {
        "flagship": (grad["k5f_ms"], grad["k5b_ms"]),
        **{name: (t["f_ms"], t["b_ms"]) for name, t in timings.items()},
        "focused_gaussian_voigt": (k5s["f_ms"], k5s["b_ms"]),
        "file_rocking": (k5file["f_ms"], k5file["b_ms"]),
        "mosaic_sphere": (k5d["f_ms"], k5d["b_ms"])})
    phase_k3_mosaic_bounds(smi, roof["roofline"]["rates"], {
        "K3 plasma_torus, 8e6 bundles (phase 25)": (k3["census"], k3["ms"]),
        "K3 weight mode, the flagship (phase 38)": (k3w["census"], k3w["ms"]),
        **{f"K1c-mosaic {mode} as run (phase 38)": ((t["census"], 0, n), t["ms"])
           for mode, t in t_mosaic.items()}})
    k1_serial = phase_k1_source_bounds(smi, roof["roofline"]["rates"], {
        "k1b": ("K1b, phase 24's source (phase 23)", source_matrix_config(1 << 22, 1, "fused"),
                1 << 22, k1b["ms"]),
        "plasma": ("K1 plasma+torus, 1000 bundles (phase 16)",
                   plasma_config(1 << 22, 1, engine="fused"), plasma["k1p_slots"],
                   plasma["k1p_ms"]),
        "plasma_1e5": ("K1 plasma+torus, 1e5 bundles (phase 16)",
                       plasma_config(1 << 22, 1, 100000, engine="fused"),
                       plasma["k1p_slots_1e5"], plasma["k1p_ms_1e5"]),
        "mirror": ("K1c-mirror, the flagship's crystal unchecked (phase 31)",
                   mirror_configs(1 << 22, 1, "fused")["flagship_no_check"], 1 << 22,
                   t_mirror["ms"]),
        "cylinder": ("K1c-cylinder, the cylinder crystal (phase 18)",
                     cylinder_config(1 << 22, 1, "fused"), 1 << 22, curved["k1c"]["ms"])})
    # Phases 46-48: ray-sharded runs, counters read around each.
    sharded = phase_sharded(ft, bg, engine, xicsrt_tpu_torch.raytrace, fused_meta,
                            plasma["example03_meta"])
    ranks = phase_ranks(smi, engine, sharded["flagship"])
    sharded_grad = phase_sharded_gradients(fg)
    # Phase 49: the long optic chains, counters read around each path.
    long_chains = phase_long_chains(smi, ft, fg, engine, xicsrt_tpu_torch.raytrace)
    unwanted = [m for m in ("h5py", "matplotlib") if m in sys.modules]
    if unwanted:
        raise AssertionError(f"chip_smoke imported {unwanted}")

    def row(name, source, replaces, launches, err, ms, plain_ms, bound_, library_ms=None,
            bound_flat=None):
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_[0], "bound_by": bound_[1], "library_ms": library_ms}
        if bound_flat is not None:  # K1: every ray through every optic
            out["bound_ms_flat"] = bound_flat[0]
        return out

    trace_cu = "xicsrt_tpu_torch/csrc/fused_trace.cu"
    grad_cu = "xicsrt_tpu_torch/csrc/fused_grad.cu"
    kernels = [
        {**row("fused_run_cuda (K1a)", trace_cu, "xicsrt_tpu/ops/fused_trace.py:1343",
               k1_launches, k1_err, k1_ms, k1_plain_ms, k1_bound, bound_flat=k1_bound_flat),
         "launches_sharded": sharded["k1"], "ms_two_shards_call": sharded["ms_sharded"],
         "ms_unsharded_call": sharded["ms_one"], "ms_two_ranks_call": ranks["ms_2"],
         "ms_one_process_call": ranks["ms_1"], "efficiency_two_ranks_one_card": ranks["efficiency"]},
        {**row("bin_images_cuda (K2)", "xicsrt_tpu_torch/csrc/bin_image.cu",
               "xicsrt_tpu/ops/pallas_binning.py:31", k2_launches, k2_err, k2_main_ms,
               k2_main_plain_ms, k2_main_bound, k2_main_library_ms),
         "ms_card_alone": k2_main_card_ms, "library_ms_card_alone": k2_main_library_card_ms,
         "ms_dense_100x100": k2_dense_ms, "plain_ms_dense_100x100": k2_dense_plain_ms,
         "bound_ms_dense_100x100": k2_dense_bound[0],
         "library_ms_dense_100x100": k2_dense_library_ms},
        {**row("fused_grad_forward_cuda (K5f)", grad_cu, "xicsrt_tpu/ops/fused_grad.py:1906",
               grad["k5f_launches"], grad["k5f_err"], grad["k5f_ms"], grad["k5f_plain_ms"],
               grad["k5f_bound"]),
         "launches_sharded": sharded_grad["launches"][0],
         "sharded_rel_err": sharded_grad["err_image"]},
        {**row("fused_grad_vjp_cuda (K5b)", grad_cu, "xicsrt_tpu/ops/fused_grad.py:1921",
               grad["k5b_launches"], grad["k5b_err"], grad["k5b_ms"], grad["k5b_plain_ms"],
               grad["k5b_bound"]),
         "launches_sharded": sharded_grad["launches"][1],
         "sharded_rel_err": sharded_grad["err_vjp"]},
        {**row("interval_gather_cuda (K4)", "xicsrt_tpu_torch/csrc/bundle_gather.cu",
               "xicsrt_tpu/ops/bundle_gather.py:80", plasma["k4_launches"], plasma["k4_err"],
               plasma["k4_ms"], plasma["k4_plain_ms"], plasma["k4_bound"],
               plasma["k4_library_ms"]),
         "launches_sharded": sharded["k4"]},
        {**row("fused_run_cuda plasma+torus (K1f, K1c-torus)", trace_cu,
               "xicsrt_tpu/ops/fused_trace.py:1428 and :616", plasma["k1p_launches"],
               plasma["k1p_err"], plasma["k1p_ms"], plasma["k1p_plain_ms"],
               plasma["k1p_bound"]),
         "serial_ms": k1_serial["plasma"], "ms_1e5_bundles": plasma["k1p_ms_1e5"],
         "bound_ms_1e5_bundles": plasma["k1p_bound_1e5"][0],
         "serial_ms_1e5_bundles": k1_serial["plasma_1e5"]},
        {**row("fused_run_cuda cylinder (K1c-cylinder)", trace_cu,
               "xicsrt_tpu/ops/fused_trace.py:784 and :903", curved["k1c"]["launches"],
               curved["k1c"]["err"], curved["k1c"]["ms"], curved["k1c"]["plain_ms"],
               curved["k1c"]["bound"], bound_flat=curved["k1c"]["bound_flat"]),
         "serial_ms": k1_serial["cylinder"], "build": curved["k1c"]["build"],
         "k1a_ms": curved["k1c"]["k1a_ms"]},
        row("fused_grad_forward_cuda torus+cylinder+plasma (K5f: K5c, K5e)", grad_cu,
            "xicsrt_tpu/ops/fused_grad.py:1727 (pallas_call :1906)",
            curved["k5f_launches"], curved["k5f_err"], torus["f_ms"], torus["f_plain"],
            torus["f_bound"]),
        row("fused_grad_vjp_cuda torus+cylinder+plasma (K5b: K5c, K5e)", grad_cu,
            "xicsrt_tpu/ops/fused_grad.py:1727 (pallas_call :1921)",
            curved["k5b_launches"], curved["k5b_err"], torus["b_ms"], torus["b_plain"],
            torus["b_bound"]),
        {**row("fused_run_cuda source matrix (K1b)", trace_cu,
               "xicsrt_tpu/ops/fused_trace.py:1538 (kernel :1343, pallas_call :1883)",
               k1b_launches, k1b["err"], k1b["ms"], k1b["plain_ms"], k1b["bound"],
               bound_flat=k1b["bound_flat"]),
         "serial_ms": k1_serial["k1b"]},
        row("fused_trace_run_cuda (K3)", "xicsrt_tpu_torch/csrc/trace_only.cu",
            "xicsrt_tpu/ops/fused_trace.py:2081 (pallas_call :2156)", k3["launches"],
            k3["err"], k3["ms"], k3["plain_ms"], k3["bound"]),
        row("fused_grad_forward_cuda source matrix (K5f: K5e-generic)", grad_cu,
            "xicsrt_tpu/ops/fused_grad.py:488 (pallas_call :1906)", k5s["f_launches"],
            k5s["f_err"], k5s["f_ms"], k5s["f_plain"], k5s["f_bound"]),
        row("fused_grad_vjp_cuda source matrix (K5b: K5e-generic)", grad_cu,
            "xicsrt_tpu/ops/fused_grad.py:488 (pallas_call :1921)", k5s["b_launches"],
            k5s["b_err"], k5s["b_ms"], k5s["b_plain"], k5s["b_bound"]),
        {**row("fused_run_cuda mirrors (K1c-mirror)", trace_cu,
               "xicsrt_tpu/ops/fused_trace.py:1099 (kernel :1343, pallas_call :1883)",
               mirror_launches, mirror_err, t_mirror["ms"], t_mirror["plain_ms"],
               t_mirror["bound"], bound_flat=t_mirror["bound_flat"]),
         "serial_ms": k1_serial["mirror"], "build": picks["K1c-mirror"],
         "k1a_ms": t_k1a["ms"]},
        {**row("fused_run_cuda file rocking (K1c-file)", trace_cu,
               "xicsrt_tpu/ops/fused_trace.py:733 (kernel :1343, pallas_call :1883)",
               file_launches, file_err, t_file["ms"], t_file["plain_ms"], t_file["bound"],
               bound_flat=t_file["bound_flat"]),
         "build": picks["K1c-file"]},
        row("fused_run_cuda mesh surrogate (K1c-cheb)", trace_cu,
            "xicsrt_tpu/ops/fused_trace.py:813 (kernel :1343, pallas_call :1883)",
            mesh_launches, mesh_err, t_cheb["ms"], t_cheb["plain_ms"], t_cheb["bound"],
            bound_flat=t_cheb["bound_flat"]),
        row("fused_grad_forward_cuda file rocking (K5f: K5c-file)", grad_cu,
            "xicsrt_tpu/ops/fused_grad.py:650 (pallas_call :1906)", k5file["f_launches"],
            k5file["f_err"], k5file["f_ms"], k5file["f_plain"], k5file["f_bound"]),
        row("fused_grad_vjp_cuda file rocking (K5b: K5c-file)", grad_cu,
            "xicsrt_tpu/ops/fused_grad.py:739 (pallas_call :1921)", k5file["b_launches"],
            k5file["b_err"], k5file["b_ms"], k5file["b_plain"], k5file["b_bound"]),
        row("fused_run_cuda weight mode (K1d-weight)", trace_cu,
            "xicsrt_tpu/ops/fused_trace.py:1719 and :1007 (kernel :1343, pallas_call :1883)",
            k1d_launches["weight"], k1d_err["weight"],
            t_weight["ms"], t_weight["plain_ms"], t_weight["bound"],
            bound_flat=t_weight["bound_flat"]) | {"image_adds": t_weight["image_adds"]},
        row("fused_run_cuda bilinear images (K1d-bilinear)", trace_cu,
            "xicsrt_tpu/ops/fused_trace.py:1163 (kernel :1343, pallas_call :1883)",
            k1d_launches["bilinear"], k1d_err["bilinear"],
            t_bilinear["ms"], t_bilinear["plain_ms"], t_bilinear["bound"],
            bound_flat=t_bilinear["bound_flat"]) | {"image_adds": t_bilinear["image_adds"]},
        row("fused_run_cuda mosaic mc (K1c-mosaic)", trace_cu,
            "xicsrt_tpu/ops/fused_trace.py:1042 (kernel :1343, pallas_call :1883)",
            mosaic15["mc"]["fused"][2], k1d_err["mosaic mc"],
            t_mosaic["mc"]["ms"], t_mosaic["mc"]["plain_ms"], t_mosaic["mc"]["bound"]),
        row("fused_run_cuda mosaic weight (K1c-mosaic)", trace_cu,
            "xicsrt_tpu/ops/fused_trace.py:1065 (kernel :1343, pallas_call :1883)",
            mosaic15["weight"]["fused"][2], k1d_err["mosaic weight"],
            t_mosaic["weight"]["ms"], t_mosaic["weight"]["plain_ms"],
            t_mosaic["weight"]["bound"]),
        row("fused_trace_run_cuda weight mode (K3-weight)",
            "xicsrt_tpu_torch/csrc/trace_only.cu",
            "xicsrt_tpu/ops/fused_trace.py:2081 (weights :2054, pallas_call :2156)",
            k3w["launches"], k1d_err["k3 weight"], k3w["ms"], k3w["plain_ms"], k3w["bound"]),
        row("fused_grad_forward_cuda mosaic (K5f: K5d)", grad_cu,
            "xicsrt_tpu/ops/fused_grad.py:1049 (pallas_call :1906)", k5d["f_launches"],
            k5d["f_err"], k5d["f_ms"], k5d["f_plain"], k5d["f_bound"]),
        row("fused_grad_vjp_cuda mosaic (K5b: K5d)", grad_cu,
            "xicsrt_tpu/ops/fused_grad.py:1281 (pallas_call :1921)", k5d["b_launches"],
            k5d["b_err"], k5d["b_ms"], k5d["b_plain"], k5d["b_bound"]),
        {**row("fused_run_cuda 'found' main step (K1e: both K1 builds launched, the probe's "
               "flag set: the marked build leaves, the build without marks runs)",
               "xicsrt_tpu_torch/csrc/fused_history.cu",
               "xicsrt_tpu/ops/fused_trace.py:1343 (pallas_call :1864)",
               k1e["launches"][0], max(probe_err, k1e["main_err"]), k1e["main_ms"],
               k1_plain_ms, k1_bound,
               bound_flat=k1_bound_flat),
         "k1_ms": k1e["k1_ms"], "ms_2_28": k1e["main_ms_2_28"],
         "k1_ms_2_28": k1e["k1_ms_2_28"], "found_ms_2_28": k1e["found_ms_2_28"],
         "k1e_ms_2_28": k1e["ms"]},
        row("history_probe_cuda (K1e probe and its selection)",
            "xicsrt_tpu_torch/csrc/fused_history.cu",
            "xicsrt_tpu/ops/fused_trace.py:1750 (the slot write's test of a chunk, kernel "
            ":1343, pallas_call :1864)", k1e["launches"][2], k1e_err, k1e["probe_ms"],
            k1e["probe_plain_ms"], k1e["probe_bound"]),
        {**row("history_record_cuda (K1e selection and record)",
               "xicsrt_tpu_torch/csrc/fused_history.cu",
               "xicsrt_tpu/ops/fused_trace.py:1720 (slot write :1750, HBM reservoir :1784, "
               "kernel :1343, pallas_call :1864)", k1e["launches"][1], k1e_err,
               k1e["record_ms"], k1e["record_plain_ms"], k1e["record_bound"]),
         "library_ms_select": k1e["select_library_ms"], "split_ms": k1e["split_ms"],
         "sort_history_span_ms": k1e["spans"].get("sort_history"),
         "raytrace_run_span_ms": k1e["spans"].get("raytrace_run")},
    ]
    k1l, k3l, k5fl, k5bl = (long_chains[k] for k in ("k1", "k3", "k5f", "k5b"))
    kernels += [
        {**row("fused_run_cuda baffle127 (K1, 127 optics)", trace_cu,
               "xicsrt_tpu/ops/fused_trace.py:1343 (127 optics :1296)", k1l["launches"],
               k1l["err"], k1l["ms"], k1l["plain_ms"], k1l["bound"],
               bound_flat=k1l["bound_flat"]),
         "rays_per_s_2_28": k1l["rays_per_s"], "found_rays_per_s_2_28": k1l["found_rays_per_s"],
         "ms_a_plate": k1l["ms_a_plate"],
         "found_launches": k1l["found_launches"]},
        {**row("fused_trace_run_cuda baffle127 (K3, 127 optics)",
               "xicsrt_tpu_torch/csrc/trace_only.cu",
               "xicsrt_tpu/ops/fused_trace.py:2081 (pallas_call :2156)", k3l["launches"],
               k3l["err"], k3l["ms"], k3l["plain_ms"], k3l["bound"]),
         "bound_ms_flat": k3l["bound_flat"][0]},
        row("fused_grad_forward_cuda baffle42 (K5f, 42 optics)", grad_cu,
            "xicsrt_tpu/ops/fused_grad.py:1727 (42 optics :1709, pallas_call :1906)",
            k5fl["launches"], k5fl["err"], k5fl["ms"], k5fl["plain_ms"], k5fl["bound"]),
        {**row("fused_grad_vjp_cuda baffle42 (K5b, 42 optics, the replay build)",
               "xicsrt_tpu_torch/csrc/fused_grad_replay.cu",
               "xicsrt_tpu/ops/fused_grad.py:1727 (42 optics :1709, pallas_call :1921)",
               k5bl["launches"], k5bl["err"], k5bl["ms"], k5bl["plain_ms"], k5bl["bound"]),
         "build": k5bl["build"], "states": k5bl["states"],
         "forwards_a_ray": k5bl["forwards_a_ray"],
         "states_bytes_2_22": k5bl["states_bytes"], "step_ms_2_24": k5bl["step_ms_2_24"],
         "flagship_ms_recompute": k5bl["flagship_ms_recompute"],
         "flagship_ms_replay": k5bl["flagship_ms_replay"]},
    ]
    probes_cu = "xicsrt_tpu_torch/csrc/roofline_probes.cu"
    rate_ms = roof["roofline"]["rate_ms"]  # the times of phase 45's rates (R2's: phase 44's)
    for body in ("trans", "sqrtdiv", "simple"):
        kernels.append(row(f"elem_rate_cuda (R1-{body})", probes_cu,
                           "tools/roofline.py:294 (pallas_call :315)",
                           roof["launches"][f"R1-{body}"], r1[body]["err"], rate_ms[body],
                           r1[body]["plain_ms"], r1[body]["bound"]))
    kernels.append(row("mma_rate_cuda (R2)", probes_cu, "tools/roofline.py:344 (pallas_call :366)",
                       roof["launches"]["R2"], r2["err"], r2["ms"], r2["plain_ms"],
                       r2["bound"], r2["library_ms"]))
    log(f"phase 31 K1a per 2^22 flagship rays beside the new stages: {t_k1a['ms']:.4f} ms; "
        f"phase 38 again {t_k1a_again['ms']:.4f} ms")
    log(f"the script took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
