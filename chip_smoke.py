"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``. Phases:

1. device: the card's name and power limit, toolchain versions;
2. build: compile the CUDA kernels of ``xicsrt_tpu_torch/csrc``;
3. K2 (binning kernel) against its plain twin on the card;
4. K1a (fused trace kernel) against its plain twin on the card;
5. the main path on the fused engine, ``raytrace(config, device='cuda')``;
6. the main path on the eager engine with the binning kernel;
7. timings: kernels against their twins, both engines' rays/s.

It prints one JSON line of kernel results, then, as its last line, the
device summary. Any failure raises, and the script exits non-zero without
the summary. It needs one CUDA device and no network.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Efficiency of the flagship chain on the JAX fused engine (source ->
# aperture -> crystal -> detector); a physics figure, not a speed.
REFERENCE_EFFICIENCY = 0.01334
FLAGSHIP_IMAGES = ((100, 100, 0.002), (100, 50, 0.004))


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


def phase_k2(native_bin, plain_bin):
    gen = torch.Generator(device="cuda").manual_seed(1)
    n = 1 << 22
    worst = 0.0
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
    return worst


def flagship(intensity, num_iter, **general):
    from __graft_entry__ import _spectrometer_config

    return _spectrometer_config(intensity=intensity, num_iter=num_iter, **general)


def phase_k1a(ft, engine):
    n = 1 << 20
    pipe = engine.Pipeline(flagship(n, 1, engine="fused"), device="cuda")
    src = ft._source_spec(pipe.source)
    optics = [ft._optic_spec(o) for o in pipe.optics]
    fparams = ft.pack_params(src, optics, pipe.params, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    uniforms = torch.rand((fparams.n_draws, n), generator=gen, device="cuda")
    tol = max(2, int(1e-6 * n))
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
            f"L1 diff {di.sum().item():.0f} (tolerance {tol} rays: FMA-free "
            f"build, but sin/exp/sqrt may round apart at thresholds)")
        if dc.max().item() > tol or di.sum().item() > 2 * tol * len(optics):
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
    from xicsrt_tpu_torch.ops import fused_trace as ft
    from xicsrt_tpu_torch.ops import native
    from xicsrt_tpu_torch.ops.pallas_binning import bin_image_cuda, bin_image_plain

    t0 = time.perf_counter()
    lib_path = native.build()
    native.library()
    log(f"phase 2 build: {lib_path} in {time.perf_counter() - t0:.1f} s")

    k2_err = phase_k2(bin_image_cuda, bin_image_plain)
    k1_err, fparams = phase_k1a(ft, engine)

    # Phase 5: the main path, fused engine, counters read around this run.
    fused_cfg = flagship(2**26, 4, engine="fused")
    budget = 2**26 * 4
    ft.fused_run_cuda.launches = 0
    bin_image_cuda.launches = 0
    fused_res = xicsrt_tpu_torch.raytrace(fused_cfg, device="cuda")
    k1_launches = ft.fused_run_cuda.launches
    if k1_launches <= 0:
        raise AssertionError("the fused main path did not launch K1a")
    fused_meta = check_main_path(fused_res, budget, "phase 5 fused")

    # Phase 6: the eager engine binning with K2.
    eager_cfg = flagship(2**22, 4, engine="xla", binning="pallas")
    ft.fused_run_cuda.launches = 0
    bin_image_cuda.launches = 0
    eager_res = xicsrt_tpu_torch.raytrace(eager_cfg, device="cuda")
    k2_launches = bin_image_cuda.launches
    if k2_launches <= 0:
        raise AssertionError("the eager main path did not launch K2")
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
    ones = torch.ones(n, device="cuda")
    k2_ms = cuda_ms(lambda: bin_image_cuda(xl, mask, ones, nx, ny, ps), 20)
    k2_plain_ms = cuda_ms(lambda: bin_image_plain(xl, mask, ones, nx, ny, ps), 20)
    k1_ms = cuda_ms(lambda: ft.fused_run_cuda(fparams, n, n, seed=(1, 2)), 20)
    k1_plain_ms = cuda_ms(lambda: ft.fused_run_plain(fparams, n, n, seed=(1, 2)), 5)
    fused_ms = cuda_ms(lambda: xicsrt_tpu_torch.raytrace(fused_cfg, device="cuda"), 3)
    eager_ms = cuda_ms(lambda: xicsrt_tpu_torch.raytrace(eager_cfg, device="cuda"), 3)
    log(f"phase 7 timings on {smi}: K2 {k2_ms:.4f} ms vs twin {k2_plain_ms:.4f} ms "
        f"(2^22 rays, 100x100); K1a {k1_ms:.4f} ms vs twin {k1_plain_ms:.4f} ms "
        f"(2^22 flagship rays, Philox); raytrace fused {budget / fused_ms * 1e3:.4g} "
        f"rays/s ({fused_ms:.2f} ms for {budget} rays); raytrace eager+K2 "
        f"{2**24 / eager_ms * 1e3:.4g} rays/s ({eager_ms:.2f} ms for {2**24} rays)")

    kernels = [
        {"name": "fused_run_cuda (K1a)", "route": "cuda",
         "source": "xicsrt_tpu_torch/csrc/fused_trace.cu",
         "replaces": "xicsrt_tpu/ops/fused_trace.py:1343",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "bin_image_cuda (K2)", "route": "cuda",
         "source": "xicsrt_tpu_torch/csrc/bin_image.cu",
         "replaces": "xicsrt_tpu/ops/pallas_binning.py:31",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
