"""K1d: weight mode and bilinear images in the fused kernels K1 and K3,
against the JAX package on the CPU.

The twins of K1 (``ops/fused_trace.fused_run_plain``) and K3
(``fused_trace_run_plain``) run ``tests/test_fused_engine.py``'s flagship
chain in weight mode, with bilinear images and with both, on the uniforms
JAX's interpreted kernels draw (``tests/test_torch_mirror.py``'s helpers);
K3 reads the rays, and in weight mode their weights, of one JAX iteration.

Tolerances:
- counts: at most ``TOL_RAYS`` rays apart per element (XLA contracts
  multiply-adds the twin keeps apart, which can flip a ray at the Bragg
  threshold or an aperture edge);
- images, L1 over the image: 2 per such ray, plus
  - bilinear: 1e-3 of the image's sum. The hit positions agree to the
    float32 rounding of the chain, which the crystal's reflection carries
    to about 1e-4 pixel on the detector; each tent moves by as much;
  - weight mode: 1e-2 of the image's sum. A ray's weight is its rocking
    probability at the deviation sd = |d.n| cos_b - sqrt(1 - (d.n)^2)
    sin_b, a difference of two products near 0.6 that cancel to about
    1e-5 rad: one rounding of either moves sd by ~1e-7 rad, z = sd / sigma
    by ~5e-3 on the 48 urad curve, and the weight by up to ~1.5 % at
    z = 3; over the image this averages to ~0.2 % (measured 0.14-0.27 %).
XLA's CPU backend flushes float32 denormals to zero; the twins run with
``torch.set_flush_denormal(True)`` so that a rocking probability below
the normal range is zero in both (it decides a weight-mode mosaic's
reservoir pick, ``tests/test_torch_mosaic.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests import test_fused_engine as jax_fused_tests
from tests.test_torch_mirror import TOL_RAYS, k1_twin_against_jax, k3_twin_against_jax
from xicsrt_tpu_torch.draws import Draws
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.engine import build_runner, raytrace
from xicsrt_tpu_torch.ops import fused_trace as ft

MODES = {"weight": {"interact_mode": "weight"},
         "bilinear": {"image_mode": "bilinear"},
         "both": {"interact_mode": "weight", "image_mode": "bilinear"}}


@pytest.fixture(autouse=True)
def flush_denormal():
    """Float32 denormals flushed to zero, as XLA's CPU backend does."""
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def image_tolerance(general: dict):
    """The L1 bound on an image (a function of JAX's image) for the run
    modes ``general``; see the module docstring."""
    rel = 1e-2 if general.get("interact_mode") == "weight" else (
        1e-3 if general.get("image_mode") == "bilinear" else 0.0)
    return lambda ref: 2 * TOL_RAYS + rel * float(np.abs(ref).sum())


@pytest.mark.parametrize("kernel", ["K1", "K3"])
@pytest.mark.parametrize("mode", MODES)
def test_twin_matches_jax_kernel(mode, kernel):
    general = MODES[mode]
    cfg = jax_fused_tests._spectrometer(8192, **general)
    check = k1_twin_against_jax if kernel == "K1" else k3_twin_against_jax
    counts, ref, fparams = check(cfg, seed=71, image_tol=image_tolerance(general))
    assert fparams.weight == (mode != "bilinear")
    assert fparams.bilinear == (mode != "weight")
    assert fparams.stages == 1 and int(counts[-1]) > 20
    # Weight mode draws nothing at the crystal (JAX fused_trace.py:532-533).
    assert fparams.n_draws == (0 if kernel == "K3" else 2) + int(mode == "bilinear")


def _sums(res):
    return {k: float(v.sum()) for k, v in res["total"]["image"].items()}


def _metas(res):
    return {k: v["num_out"] for k, v in res["total"]["meta"].items()}


@pytest.mark.parametrize("mode", MODES)
def test_fused_engine_matches_eager_engine(mode):
    """``raytrace`` on the fused engine (K1's twin) against the eager
    engine, as ``tests/test_fused_engine.py:897-942`` holds JAX's engines:
    the rays each element keeps within 5 binomial sigma (in weight mode the
    crystal keeps every ray its bounds keep), the weighted detector sums
    within 5 sqrt(sf + sx), and a bilinear image in mc mode sums to its
    count."""
    n = 1 << 15
    results = {}
    for engine in ("fused", "xla"):
        cfg = jax_fused_tests._spectrometer(n, engine=engine, random_seed=3, **MODES[mode])
        runner, _ = build_runner(cfg, device="cpu")
        assert runner.__qualname__.startswith(
            "build_fused_run" if engine == "fused" else "Pipeline.make_run")
        results[engine] = raytrace(cfg, device="cpu")
    mf, mx = _metas(results["fused"]), _metas(results["xla"])
    for name in ("aperture", "crystal", "detector"):
        p = (mf[name] + mx[name]) / (2 * n)
        assert abs(mf[name] - mx[name]) / n < 5 * np.sqrt(2 * p * (1 - p) / n), (name, mf, mx)
    sf, sx = _sums(results["fused"])["detector"], _sums(results["xla"])["detector"]
    assert sf > 0 and abs(sf - sx) < 5.0 * np.sqrt(sf + sx), (sf, sx)
    if mode == "bilinear":  # the spot lies well inside the grid
        assert abs(sf - mf["detector"]) < 1e-3 * mf["detector"]


def test_weight_and_mc_estimate_the_same_flux():
    """Weight mode and mc mode on the fused engine estimate the same
    detector flux (``tests/test_fused_engine.py:918-926``)."""
    n = 1 << 15
    sums = {m: _sums(raytrace(jax_fused_tests._spectrometer(
        n, engine="fused", random_seed=4, interact_mode=m), device="cpu"))["detector"]
        for m in ("mc", "weight")}
    assert abs(sums["weight"] - sums["mc"]) < 5.0 * np.sqrt(sums["mc"]), sums


def test_weight_mode_k3_takes_the_rays_weights():
    """K3 in weight mode needs the rays' weights, in mc mode none; its
    twin starts each ray from its own weight."""
    cfg = jax_fused_tests._spectrometer(1024, interact_mode="weight")
    tp = TorchPipeline(cfg, device="cpu")
    fparams = ft.pack_params({"name": None, "kind": ft.SRC_RAYS, "n_draws": 0},
                             [ft._optic_spec(o) for o in tp.optics], tp.params, "cpu",
                             weight=True)
    from xicsrt_tpu_torch.draws import Draws

    rays = tp.source.generate(tp.params["sources"]["source"],
                              Draws(torch.Generator().manual_seed(5)), tp.params["filters"])
    args = (fparams, rays.origin, rays.direction, rays.wavelength, rays.mask)
    with pytest.raises(ValueError, match="weight"):
        ft.fused_trace_run_cuda(*args, seed=(1, 2))
    _, one = ft.fused_trace_run_cuda(*args, seed=(1, 2), weight=rays.weight)
    _, half = ft.fused_trace_run_cuda(*args, seed=(1, 2), weight=0.5 * rays.weight)
    assert one.sum() > 0
    torch.testing.assert_close(half, 0.5 * one)


@pytest.mark.parametrize("kernel", ["K1", "K3"])
@pytest.mark.parametrize("mode", ["mc", *MODES])
def test_twin_counts_its_image_terms(mode, kernel):
    """The twins' term tally (``terms=True``), which bounds the kernels'
    summation order on the card (``chip_smoke.twin_equal``): the images are
    the plain call's; each pixel's float32 sum lies within g(k - 1) S of
    the float64 sum S of its k nonnegative terms, g(j) = j 2^-24 / (1 -
    j 2^-24); with mc rays and nearest images, k and S are the pixel's
    count."""
    general = MODES.get(mode, {})
    pipe = TorchPipeline(jax_fused_tests._spectrometer(4096, **general), device="cpu")
    optics = [ft._optic_spec(o) for o in pipe.optics]
    modes = ft._chain_modes(pipe.general)
    if kernel == "K1":
        fparams = ft.pack_params(ft._source_spec(pipe.source), optics, pipe.params, "cpu",
                                 **modes)
        run = lambda **kw: ft.fused_run_plain(fparams, 4096, 4096, seed=(5, 6), **kw)
    else:
        fparams = ft.pack_params({"name": None, "kind": ft.SRC_RAYS, "n_draws": 0}, optics,
                                 pipe.params, "cpu", **modes)
        rays = pipe.source.generate(pipe.params["sources"][pipe.source.name],
                                    Draws(torch.Generator().manual_seed(5)),
                                    pipe.params["filters"])
        weight = {"weight": rays.weight} if fparams.weight else {}
        run = lambda **kw: ft.fused_trace_run_plain(
            fparams, rays.origin, rays.direction, rays.wavelength, rays.mask, seed=(5, 6),
            **weight, **kw)
    counts, image = run()
    counts_t, image_t, (k, mag) = run(terms=True)
    assert torch.equal(counts, counts_t) and torch.equal(image, image_t)
    assert int(k.sum()) > 20 and bool((mag >= 0).all())
    j = (k - 1.0).clamp_min(0.0) * 2.0**-24
    assert bool(((image.double() - mag).abs() <= j / (1.0 - j) * mag).all())
    if mode == "mc":
        assert torch.equal(k, image.double()) and torch.equal(mag, image.double())
    elif mode == "bilinear":  # four corners a ray, less those off the grid
        assert int(k.sum()) <= 4 * int(counts[1:].sum())


def test_pack_params_takes_the_draws_and_build_from_the_run_mode():
    """One chain's specs packed in either mode: a crystal draws once in mc
    mode and never in weight mode, and the build of K1 and K3 (``stages``)
    and the modes are read from the packed header."""
    pipe = TorchPipeline(jax_fused_tests._spectrometer(1024), device="cpu")
    src = ft._source_spec(pipe.source)
    optics = [ft._optic_spec(o) for o in pipe.optics]
    for weight in (False, True):
        for bilinear in (False, True):
            fparams = ft.pack_params(src, optics, pipe.params, "cpu", weight=weight,
                                     bilinear=bilinear)
            assert fparams.n_draws == src["n_draws"] + int(not weight)
            assert int(fparams.ip[3]) == fparams.n_draws
            assert (fparams.weight, fparams.bilinear) == (weight, bilinear)
            assert int(fparams.ip[ft.H_WEIGHT]) == weight
            assert fparams.stages == int(weight or bilinear)
            assert fparams.interact_mask == (1 << ft._INTERACT["none"]
                                             | 1 << ft._INTERACT["crystal"])
    with pytest.raises(ValueError, match="ip and ip_host"):
        dataclasses.replace(fparams, ip=fparams.ip[:-1])
