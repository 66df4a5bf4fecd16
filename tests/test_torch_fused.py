"""The fused kernel's plain twin (K1a) against the JAX megakernel.

``build_fused_run(pipe, chunk=1024, interpret=True, rng='input')`` runs the
Pallas kernel through its interpreter on uniforms drawn as
``jax.random.uniform(key, (n_chunks, n_draws, 8, 128), float32)``
(``fused_trace.py:1973``). Ray ``r = chunk*1024 + s*128 + lane`` takes draw
``k`` from ``U[chunk, k, s, lane]``, so the port receives
``U.permute(1, 0, 2, 3).reshape(n_draws, -1)``.

Tolerance: per element, at most 3 rays may differ, and each image by at
most 2 per such ray (L1). The two compute in float32 with the same
formulas, but XLA may fuse multiply-adds and evaluate sin/exp/sqrt with
other roundings, which can flip a ray sitting at a threshold (aperture
edge, crystal acceptance, pixel boundary).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _spectrometer_config
from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops.fused_trace import build_fused_run as jax_build_fused_run
from xicsrt_tpu_torch import params_from_jax
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.ops import fused_trace as ft

N_RAYS = 8192
TOL_RAYS = 3


def _flagship():
    return _spectrometer_config(intensity=N_RAYS, engine="fused")


def _variant():
    """Isotropic source with a Poisson budget; rectangle/ellipse/square
    aperture logic; a step-rocking crystal; a zsize bound."""
    cfg = _spectrometer_config(intensity=N_RAYS - 300, engine="fused")
    src = cfg["sources"]["source"]
    src.update(angular_dist="isotropic", spread=np.radians(12.0), use_poisson=True)
    cfg["optics"]["aperture"]["aperture"] = [
        {"shape": "rectangle", "size": [0.16, 0.12], "logic": "and"},
        {"shape": "ellipse", "size": [0.03, 0.02], "origin": [0.01, 0.0], "logic": "xor"},
        {"shape": "square", "size": [0.02], "origin": [-0.04, 0.03], "logic": "nor"},
        {"shape": "none", "logic": "or"},
    ]
    cfg["optics"]["aperture"].update(xsize=0.2, ysize=0.2, zsize=1e-3)
    cfg["optics"]["crystal"].update(rocking_type="step", rocking_fwhm=2e-4)
    return cfg


def _pack(cfg):
    jp = JaxPipeline(cfg)
    tp = TorchPipeline(cfg, device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp.params))
    src = ft._source_spec(tp.source)
    optics = [ft._optic_spec(o) for o in tp.optics]
    return jp, tp, optics, ft.pack_params(src, optics, params, "cpu")


@pytest.mark.parametrize("make_config", [_flagship, _variant], ids=["flagship", "variant"])
def test_twin_matches_jax_megakernel(make_config):
    jp, tp, optics, fparams = _pack(make_config())
    n_total = tp.num_rays
    key = jax.random.key(5)
    jax_run = jax_build_fused_run(jp, chunk=1024, interpret=True, rng="input")
    ref = jax.tree_util.tree_map(np.asarray, jax_run(key))
    n_chunks = -(-n_total // 1024)
    U = jax.random.uniform(key, (n_chunks, fparams.n_draws, 8, 128), dtype=jnp.float32)
    U = torch.tensor(np.asarray(U)).permute(1, 0, 2, 3).reshape(fparams.n_draws, -1)
    U = U[:, :n_total].contiguous()
    count = int(ref["meta"]["source"])  # the JAX run's Poisson draw, if any
    counts, flat = ft.fused_run_cuda(fparams, n_total, count, uniforms=U)

    names = tp.element_names
    for i, name in enumerate(names):
        assert abs(int(counts[i]) - int(ref["meta"][name])) <= TOL_RAYS, name
    assert int(ref["meta"]["detector"]) > 20
    off = 0
    for o in optics:
        if o["image"] is None:
            continue
        size = o["image"]["nx"] * o["image"]["ny"]
        img = flat[off:off + size].reshape(o["image"]["nx"], o["image"]["ny"]).numpy()
        off += size
        assert np.abs(img - ref["image"][o["name"]]).sum() <= 2 * TOL_RAYS
        assert img.sum() == int(counts[names.index(o["name"])])


def test_runtime_params_move_the_geometry():
    """Geometry is a run-time buffer: moving the detector changes the
    result without rebuilding, and the JAX stale-params check has no
    counterpart."""
    tp = TorchPipeline(_flagship(), device="cpu")
    run = ft.build_fused_run(tp, num_iter=1, rng="hw")
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    base = run(tp.params, gen())
    params = copy.deepcopy(tp.params)
    frame = params["optics"]["detector"]["frame"]
    params["optics"]["detector"]["frame"] = type(frame)(
        origin=frame.origin + torch.tensor([0.0, 0.0, 0.05]), basis=frame.basis)
    moved = run(params, gen())
    assert int(moved["meta"]["crystal"]) == int(base["meta"]["crystal"])
    assert not torch.equal(moved["image"]["detector"], base["image"]["detector"])


def test_philox_known_answers_and_uniforms():
    """Random123's Philox4x32-10 known-answer vectors, then the uniform
    stream: 24-bit values in [0, 1), independent of how rays are sliced."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    words = ft.philox4x32_10(t(0), t(0), t(0), t(0), 0, 0)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    words = ft.philox4x32_10(t(0x243F6A88), t(0x85A308D3), t(0x13198A2E),
                             t(0x03707344), 0xA4093822, 0x299F31D0)
    assert [int(w) for w in words] == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]

    rays = torch.arange(1 << 16, dtype=torch.int64)
    rows = ft.philox_uniforms(rays, 5, 123, 456)
    u = torch.stack(rows)
    assert u.min() >= 0.0 and u.max() < 1.0
    assert torch.equal(u * 16777216.0, torch.floor(u * 16777216.0))
    assert abs(float(u.mean()) - 0.5) < 5 * (1 / 12 / u.numel()) ** 0.5
    tail = torch.stack(ft.philox_uniforms(rays[1000:], 5, 123, 456))
    assert torch.equal(tail, u[:, 1000:])


def test_twin_slices_do_not_change_results(monkeypatch):
    tp = TorchPipeline(_flagship(), device="cpu")
    src = ft._source_spec(tp.source)
    optics = [ft._optic_spec(o) for o in tp.optics]
    fparams = ft.pack_params(src, optics, tp.params, "cpu")
    whole = ft.fused_run_plain(fparams, N_RAYS, N_RAYS, seed=(9, 10))
    monkeypatch.setattr(ft, "_TWIN_SLICE", 1000)
    sliced = ft.fused_run_plain(fparams, N_RAYS, N_RAYS, seed=(9, 10))
    assert torch.equal(whole[0], sliced[0]) and torch.equal(whole[1], sliced[1])


@pytest.mark.parametrize("change", [
    ("sources", "source", {"xsize": 0.01, "ysize": 0.01}),
    ("sources", "source", {"spread": [-0.1, 0.1, -0.05, 0.15],
                           "angular_dist": "isotropic_xy"}),
    ("optics", "crystal", {"class_name": "XicsrtOpticSphericalMirror",
                           "crystal_spacing": None, "rocking_type": None,
                           "rocking_fwhm": None}),
    ("optics", "aperture", {"aperture": [{"shape": "triangle",
                                          "vertices": [[0, 0], [1, 0], [0, 1]]}]}),
])
def test_outside_subset_raises(change):
    section, name, update = change
    cfg = _flagship()
    cfg[section][name].update(update)
    for k in [k for k, v in update.items() if v is None]:
        del cfg[section][name][k]
    tp = TorchPipeline(cfg, device="cpu")
    with pytest.raises(ft.FusedUnsupported):
        ft.build_fused_run(tp)

