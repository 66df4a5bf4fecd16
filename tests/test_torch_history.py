"""The history reservoir K1e: the twin against the JAX megakernel's.

``build_fused_run(jp, chunk=1024, interpret=True, rng='input',
history_slots=..., history_mode=...)`` runs the Pallas kernel through its
interpreter; its uniforms map onto the port's as in
``tests/test_torch_fused.py``, so both trace the same rays and the
reservoirs hold the same chunks.

Tolerance: masks equal per kept ray, except at most 3 threshold rays per
element (the two round sin/exp/sqrt apart, as ``test_torch_fused.py``
allows); a field is compared where it is finite on both sides and both
masks agree, to 1e-5 of the field's largest magnitude; the weight field
in weight mode as ``tests/test_torch_weight_images.py`` holds weighted
images, its L1 within 1e-2 of its sum: a ray's weight is its rocking
probability at a Bragg deviation that cancels two products near 0.6 to
about 1e-5 rad, so one rounding XLA contracts differently moves it by
percents in the curve's tails (ROADMAP Queue 3, "Weight-mode images
against JAX"). Weight mode runs with float32 denormals flushed, as XLA's
CPU backend flushes them.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xicsrt_tpu
from __graft_entry__ import _spectrometer_config
from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops.fused_trace import build_fused_run as jax_build_fused_run
from xicsrt_tpu_torch import params_from_jax, raytrace
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.ops import fused_trace as ft

N_RAYS = 8192
CHUNK = 1024
TOL_RAYS = 3
FIELDS = ("origin", "direction", "wavelength", "weight")


@pytest.fixture
def flush_denormal():
    """Float32 denormals flushed to zero, as XLA's CPU backend does."""
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _uniforms(key, n_draws: int, n_total: int) -> torch.Tensor:
    n_chunks = -(-n_total // CHUNK)
    U = jax.random.uniform(key, (n_chunks, n_draws, 8, CHUNK // 8), dtype=jnp.float32)
    U = torch.tensor(np.asarray(U)).permute(1, 0, 2, 3).reshape(n_draws, -1)
    return U[:, :n_total].contiguous()


def _both(cfg, mode, slots, seed):
    """JAX's interpreted K1 and the port's twin on the same uniforms: (JAX
    output, port output, the port's reservoir)."""
    jp = JaxPipeline(cfg)
    tp = TorchPipeline(cfg, device="cpu")
    key = jax.random.key(seed)
    ref = jax_build_fused_run(jp, chunk=CHUNK, interpret=True, rng="input",
                              history_slots=slots, history_mode=mode)(key)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp.params), device="cpu")
    run = ft.build_fused_run(tp, num_iter=1, rng="input", history_slots=slots,
                             history_mode=mode, chunk=CHUNK)
    fparams = ft.pack_params(ft._source_spec(tp.source),
                             [ft._optic_spec(o) for o in tp.optics], params, "cpu",
                             **ft._chain_modes(tp.general))
    U = _uniforms(key, fparams.n_draws, tp.num_rays)
    out = run(params, torch.Generator().manual_seed(0), uniforms=U)
    spec = ft._history_spec(tp, ft._source_spec(tp.source), CHUNK, slots, mode)
    *_, hist = ft.fused_run_plain(fparams, tp.num_rays, tp.num_rays, U, history=spec)
    return ref, out, hist


def _assert_reservoirs_agree(ref, out, names):
    for name in names:
        jr, pr = ref["history"][name], out["history"][name]
        jm, pm = np.asarray(jr.mask), pr.mask.numpy()
        assert jm.shape == pm.shape, name
        assert (jm != pm).sum() <= TOL_RAYS, (name, int((jm != pm).sum()))
        for field in FIELDS:
            a, b = np.asarray(getattr(jr, field), np.float64), getattr(pr, field).double().numpy()
            assert a.shape == b.shape, (name, field)
            ok = np.isfinite(a) & np.isfinite(b)
            agree = (jm == pm) if a.ndim == 1 else (jm == pm)[:, None]
            ok &= agree
            if field == "weight":
                l1 = np.abs(b[ok] - a[ok]).sum()
                assert l1 <= 1e-2 * np.abs(a[ok]).sum(), (name, l1)
                continue
            scale = max(np.abs(a[ok]).max(), 1e-30)
            np.testing.assert_allclose(b[ok], a[ok], rtol=0, atol=1e-5 * scale,
                                       err_msg=f"{name}.{field}")


@pytest.mark.parametrize("mode,slots", [("found", 2), ("sampled", None)])
@pytest.mark.parametrize("interact", ["mc", "weight"])
def test_reservoir_matches_jax_megakernel(mode, slots, interact, flush_denormal):
    cfg = _spectrometer_config(intensity=N_RAYS, engine="fused", interact_mode=interact)
    ref, out, hist = _both(cfg, mode, slots, seed=5)
    names = list(out["history"])
    assert names == ["source", "aperture", "crystal", "detector"]
    _assert_reservoirs_agree(ref, out, names)
    n_fields = 9 if interact == "weight" else 8
    assert hist.slots.shape[1] == n_fields * len(names)
    if mode == "found":
        assert hist.chunks.tolist() == [0, 1] and int(hist.used) == 2
        assert int(out["history"]["detector"].mask.sum()) > 5
    else:  # history_max_lost 10000: ceil(10000 / 1024) slots, all 8 chunks used
        assert hist.slots.shape[0] == 10 and int(hist.used) == 8
        assert hist.chunks.tolist()[:8] == list(range(8))
        born = out["history"]["source"].mask
        assert int(born.sum()) == N_RAYS
    if interact == "weight":
        w = out["history"]["detector"].weight[out["history"]["detector"].mask]
        assert bool(((w >= 0) & (w <= 1)).all()) and bool((w < 1).any())


def test_selection_skips_chunks_without_a_found_ray():
    """A detector small enough that 2 of the 8 chunks keep a ray: 'found'
    keeps chunks 1 and 6, as JAX's sequential grid does; the source
    element's fields show both reservoirs hold the same rays."""
    cfg = _spectrometer_config(intensity=N_RAYS, engine="fused")
    cfg["optics"]["detector"].update(xsize=0.03, ysize=0.024)
    ref, out, hist = _both(cfg, "found", 2, seed=7)
    assert hist.chunks.tolist() == [1, 6] and int(hist.used) == 2
    _assert_reservoirs_agree(ref, out, list(out["history"]))
    np.testing.assert_array_equal(out["history"]["source"].origin.numpy(),
                                  np.asarray(ref["history"]["source"].origin))
    d = out["history"]["detector"]
    assert int(d.mask.sum()) == int(out["meta"]["detector"]) == 2


def test_raytrace_auto_found_is_bounded_with_the_jax_keys(caplog):
    """``engine='auto'``, ``keep_history='found'`` runs K1's twin: the found
    history is one slot (8192 rays) of a 4 x 8192-ray run, complete in it;
    lost rays come from the same chunk, truncated to history_max_lost."""
    cfg = _spectrometer_config(intensity=N_RAYS, num_iter=4, engine="auto",
                               keep_history="found", history_found_slots=1,
                               history_max_lost=500)
    with caplog.at_level(logging.WARNING, logger="xicsrt_tpu_torch"):
        res = raytrace(cfg, device="cpu")
    assert not caplog.records
    found, lost = res["found"]["history"], res["lost"]["history"]
    n_found = found["detector"]["origin"].shape[0]
    n_det = res["total"]["meta"]["detector"]["num_out"]
    assert 0 < n_found < n_det
    assert lost["detector"]["origin"].shape[0] == 500
    for name in found:
        assert found[name]["mask"].all() and found[name]["origin"].shape == (n_found, 3)
    assert not lost["detector"]["mask"].any() and lost["source"]["mask"].all()

    jax_cfg = _spectrometer_config(intensity=2048, engine="fused", keep_history="found",
                                   history_found_slots=1)
    ref = xicsrt_tpu.raytrace(jax_cfg)
    assert set(res) == set(ref)
    for section in ("found", "lost"):
        assert set(res[section]) == set(ref[section])
        assert set(res[section]["history"]) == set(ref[section]["history"])
        for name, rays in ref[section]["history"].items():
            assert set(res[section]["history"][name]) == set(rays)
        assert res[section]["meta"]["detector"].keys() == ref[section]["meta"]["detector"].keys()


def _filtered_past_k1():
    """A box source behind nine pass-all sightlines: past K1's 8 filters,
    so only K3 can run it, and K3 keeps no history."""
    cfg = _spectrometer_config(intensity=4096, engine="fused", keep_history="found")
    names = [f"sight{k}" for k in range(9)]
    cfg["sources"]["source"].update(xsize=0.01, ysize=0.01, filters=names)
    cfg["filters"] = {n: {"class_name": "XicsrtBundleFilterSightline",
                          "origin": [0.0, 0.0, 0.0], "zaxis": [0.0, 0.0, 1.0],
                          "radius": 1.0} for n in names}
    return cfg


def test_k3_only_config_refuses_history_on_fused_and_degrades_on_auto(caplog):
    cfg = _filtered_past_k1()
    with pytest.raises(ft.FusedUnsupported, match="megakernel"):
        raytrace(cfg, device="cpu")
    cfg["general"]["engine"] = "auto"
    with caplog.at_level(logging.WARNING, logger="xicsrt_tpu_torch"):
        res = raytrace(cfg, device="cpu")
    assert any("degrades to FULL per-ray history" in r.message for r in caplog.records)
    n_det = res["total"]["meta"]["detector"]["num_out"]
    assert res["found"]["history"]["detector"]["origin"].shape[0] == n_det
