"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``. Phases:

1. device: the card's name and power limit, toolchain versions;
2. build: compile the CUDA kernels of ``xicsrt_tpu_torch/csrc``;
3. K2 (binning kernel) against its plain twin on the card;
4. K1a (fused trace kernel) against its plain twin on the card;
5. the main path on the fused engine, ``raytrace(config, device='cuda')``;
6. the main path on the eager engine with the binning kernel;
7. timings: kernels against their twins, both engines' rays/s;
8. K5f (fused gradient forward kernel) against its plain twin;
9. K5b (its adjoint kernel) against its float32 and float64 twins, and
   linear in g;
10. the gradient path: ``make_fused_differentiable`` on the flagship at
    full width (forward + vjp), then sign descent recovering a perturbed
    crystal d-spacing (example 07's loop);
11. eager autograd on CUDA: ``make_differentiable`` + ``align`` on example
    04's task, and d(detector)/d(spacing) from autograd against K5b;
12. gradient timings: K5f and K5b against their twins, the rays/s of one
    forward+vjp step, the eager autograd step.

It prints one JSON line of kernel results, then, as its last line, the
device summary. Any failure raises, and the script exits non-zero without
the summary. It needs one CUDA device and no network.
"""

from __future__ import annotations

import copy
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
    bound = 6 * math.sqrt(sf**2 + sx**2) + 0.02 * abs(mx)
    log(f"phase 11 d(detector)/d(spacing): K5b {mf:.6g} +- {sf:.3g}, eager "
        f"autograd {mx:.6g} +- {sx:.3g} (4 seeds each; |diff| "
        f"{abs(mf - mx):.3g} < {bound:.3g} required, and |K5b| > 5 sigma)")
    if not (abs(mf) > 5 * sf and abs(mf - mx) < bound):
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
    log(f"phase 12 timings on {smi}: K5f {k5f_ms:.4f} ms vs twin {k5f_plain_ms:.4f} ms; "
        f"K5b {k5b_ms:.4f} ms vs twin {k5b_plain_ms:.4f} ms (2^22 flagship rays, "
        f"Philox); fused forward+vjp step {2**24 / step_ms * 1e3:.4g} rays/s "
        f"({step_ms:.2f} ms for 2^24 rays); eager autograd step "
        f"{eager_step_ms:.2f} ms for 2^22 rays ({n / eager_step_ms * 1e3:.4g} rays/s, "
        f"remat); example 04 align {t_align / 60 * 1e3:.2f} ms per step")
    return {"k5f_launches": k5f_launches, "k5b_launches": k5b_launches,
            "k5f_err": k5f_err, "k5b_err": k5b_err, "k5f_ms": k5f_ms,
            "k5f_plain_ms": k5f_plain_ms, "k5b_ms": k5b_ms,
            "k5b_plain_ms": k5b_plain_ms}


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
    from xicsrt_tpu_torch.ops import fused_grad as fg
    from xicsrt_tpu_torch.ops import fused_trace as ft
    from xicsrt_tpu_torch.ops import native
    from xicsrt_tpu_torch.ops.pallas_binning import bin_image_cuda, bin_image_plain

    t0 = time.perf_counter()
    lib_path = native.build()
    native.library()
    log(f"phase 2 build: {lib_path} in {time.perf_counter() - t0:.1f} s\n"
        f"{native.ptxas_report()}")

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

    grad = gradient_phases(smi, fg, engine)

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
        {"name": "fused_grad_forward_cuda (K5f)", "route": "cuda",
         "source": "xicsrt_tpu_torch/csrc/fused_grad.cu",
         "replaces": "xicsrt_tpu/ops/fused_grad.py:1906",
         "launches": grad["k5f_launches"], "max_abs_err": grad["k5f_err"],
         "ms": grad["k5f_ms"], "plain_ms": grad["k5f_plain_ms"]},
        {"name": "fused_grad_vjp_cuda (K5b)", "route": "cuda",
         "source": "xicsrt_tpu_torch/csrc/fused_grad.cu",
         "replaces": "xicsrt_tpu/ops/fused_grad.py:1921",
         "launches": grad["k5b_launches"], "max_abs_err": grad["k5b_err"],
         "ms": grad["k5b_ms"], "plain_ms": grad["k5b_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
