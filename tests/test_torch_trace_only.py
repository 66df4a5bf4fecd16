"""The trace-only kernel K3's plain twin against the JAX package, and the
routing that sends a source K1 refuses to it.

``build_fused_trace_run(pipe, chunk=1024, interpret=True, rng='input')``
runs the TPU kernel through its interpreter: per iteration ``k_src, k_kernel
= split(k)``, the rays of ``pipeline.generate(..., k_src)`` and uniforms
``uniform(k_kernel, (n_chunks, n_draws, 8, 128))`` (``fused_trace.py:
2175-2203``). The twin takes the same rays and the uniforms re-laid by ``ray
= chunk*1024 + s*128 + lane``.

Tolerance: per element at most ``TOL_RAYS`` rays apart and 2 per such ray in
each image's L1 norm, as ``tests/test_torch_fused.py`` holds K1 (XLA may
fuse multiply-adds and round exp and sqrt otherwise, which can flip a ray
at a threshold).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _spectrometer_config
from tests.test_torch_fused_plasma import _config as _plasma_torus_config
from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops.fused_trace import build_fused_trace_run as jax_build_fused_trace_run
from xicsrt_tpu_torch import params_from_jax, raytrace
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.engine import build_runner
from xicsrt_tpu_torch.ops import fused_trace as ft

TOL_RAYS = 3
CHUNK = 1024


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cases(name):
    if name == "flagship":
        return _spectrometer_config(intensity=3000)
    cfg = _plasma_torus_config()
    cfg["general"]["number_of_iter"] = 1
    return cfg


@pytest.mark.parametrize("name", ["flagship", "plasma_torus"])
def test_k3_twin_matches_jax_trace_only_kernel(name):
    cfg = _cases(name)
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    key = jax.random.key(9)
    ref = _tree(jax_build_fused_trace_run(jp, num_iter=1, chunk=CHUNK, interpret=True,
                                          rng="input")(key))
    k_src, k_kernel = jax.random.split(jax.random.split(key, 1)[0])
    rays = _tree(jp.generate(jp.params["sources"][jp.source.name], jp.params["filters"],
                             k_src))
    optics = [ft._optic_spec(o) for o in tp.optics]
    params = params_from_jax(_tree(jp.params), device="cpu")
    fparams = ft.pack_params({"name": None, "kind": ft.SRC_RAYS, "n_draws": 0}, optics,
                             params, "cpu")
    n = tp.num_rays
    n_chunks = -(-n // CHUNK)
    U = jax.random.uniform(k_kernel, (n_chunks, fparams.n_draws, 8, CHUNK // 8),
                           dtype=jnp.float32)
    U = torch.tensor(np.asarray(U)).permute(1, 0, 2, 3).reshape(fparams.n_draws, -1)
    counts, flat = ft.fused_trace_run_cuda(
        fparams, torch.tensor(rays.origin), torch.tensor(rays.direction),
        torch.tensor(rays.wavelength), torch.tensor(rays.mask),
        uniforms=U[:, :n].contiguous())
    names = tp.element_names
    for i, elem in enumerate(names):
        assert abs(int(counts[i]) - int(ref["meta"][elem])) <= TOL_RAYS, (
            elem, counts.tolist(), ref["meta"])
    assert int(ref["meta"]["detector"]) > 0
    off = 0
    for o in optics:
        if o["image"] is None:
            continue
        size = o["image"]["nx"] * o["image"]["ny"]
        img = flat[off:off + size].reshape(o["image"]["nx"], o["image"]["ny"]).numpy()
        off += size
        assert np.abs(img - ref["image"][o["name"]]).sum() <= 2 * TOL_RAYS
        assert img.sum() == int(counts[names.index(o["name"])])


def test_k3_twin_slices_and_philox():
    """The twin's Philox stream does not depend on its slices, and a dead
    ray is counted nowhere."""
    tp = TorchPipeline(_spectrometer_config(intensity=3000), device="cpu")
    optics = [ft._optic_spec(o) for o in tp.optics]
    fparams = ft.pack_params({"name": None, "kind": ft.SRC_RAYS, "n_draws": 0}, optics,
                             tp.params, "cpu")
    from xicsrt_tpu_torch.draws import Draws

    rays = tp.source.generate(tp.params["sources"]["source"],
                              Draws(torch.Generator().manual_seed(3)))
    mask = rays.mask.clone()
    mask[::3] = False
    args = (fparams, rays.origin, rays.direction, rays.wavelength, mask)
    whole = ft.fused_trace_run_plain(*args, seed=(4, 5))
    assert int(whole[0][0]) == int(mask.sum())
    old = ft._TWIN_SLICE
    try:
        ft._TWIN_SLICE = 700
        sliced = ft.fused_trace_run_plain(*args, seed=(4, 5))
    finally:
        ft._TWIN_SLICE = old
    assert torch.equal(whole[0], sliced[0]) and torch.equal(whole[1], sliced[1])


def _big_plasma():
    """The plasma of ``tests/test_torch_fused_plasma.py`` with 2^22 + 1
    bundles, more than K1 takes, and about 3650 expected photons."""
    cfg = _plasma_torus_config(bundle_count=(1 << 22) + 1, max_bundles=int(1e7),
                               emissivity=2e13)
    cfg["general"]["engine"] = "fused"
    return cfg


def test_plasma_beyond_k1_routes_to_k3():
    """A plasma of more than 2^22 bundles runs on ``engine='fused'``: the
    eager engine generates each iteration's rays, K3's twin traces them;
    the photon count is within 6 sigma of the real-units expectation."""
    cfg = _big_plasma()
    with pytest.raises(ft.FusedUnsupported):
        ft.build_fused_run(TorchPipeline(cfg, device="cpu"))
    runner, _ = build_runner(cfg, device="cpu")
    assert runner.__qualname__.startswith("build_fused_trace_run")
    res = raytrace(cfg, device="cpu")
    p = cfg["sources"]["plasma"]
    expected = (3 * p["emissivity"] * p["time_resolution"] * 0.02**3
                * math.sin(p["spread"] / 2.0) ** 2)
    n = res["total"]["meta"]["plasma"]["num_out"]
    assert abs(n - expected) < 6 * math.sqrt(expected), (n, expected)
    for name, img in res["total"]["image"].items():
        assert img.sum() == res["total"]["meta"][name]["num_out"]


@pytest.mark.parametrize("general,inside", [({"interact_mode": "weight"}, True),
                                            ({"image_mode": "bilinear"}, True),
                                            ({"dtype": "float64"}, False)])
def test_k3_takes_k1s_chain_subset(general, inside):
    """K3 takes K1's chain modes: weight mode and bilinear images since K1d
    (tests/test_torch_weight_images.py), not float64; history needs the
    megakernel."""
    cfg = _big_plasma()
    cfg["general"].update(general)
    if inside:
        assert callable(ft.build_fused_trace_run(TorchPipeline(cfg, device="cpu")))
    else:
        with pytest.raises(ft.FusedUnsupported):
            ft.build_fused_trace_run(TorchPipeline(cfg, device="cpu"))
    with pytest.raises(ft.FusedUnsupported, match="history"):
        ft.build_fast_run(TorchPipeline(_big_plasma(), device="cpu"), history_slots=8)
