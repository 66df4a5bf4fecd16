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

import chip_smoke
import xicsrt_tpu
from __graft_entry__ import _spectrometer_config
from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops.fused_trace import build_fused_run as jax_build_fused_run
from xicsrt_tpu_torch import engine, params_from_jax, raytrace
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


def _twin_inputs(cfg, slots, seed):
    """The port's packed chain, the uniforms ``_both`` gives it, its 'found'
    reservoir spec and its rays."""
    tp = TorchPipeline(cfg, device="cpu")
    jp = JaxPipeline(cfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp.params), device="cpu")
    fparams = ft.pack_params(ft._source_spec(tp.source),
                             [ft._optic_spec(o) for o in tp.optics], params, "cpu",
                             **ft._chain_modes(tp.general))
    U = _uniforms(jax.random.key(seed), fparams.n_draws, tp.num_rays)
    spec = ft._history_spec(tp, ft._source_spec(tp.source), CHUNK, slots, "found")
    return fparams, U, spec, tp.num_rays


@pytest.mark.parametrize("chain", ["dense", "sparse"])
def test_probe_keeps_the_marked_path_chunks_and_jax_reservoir(chain, monkeypatch):
    """K1e's probe twin, taken at this size too (``PROBE_MIN_RAYS`` 0), on
    the flagship (every chunk keeps a ray: its one window of 2 chunks finds
    both, sets the flag, and K1 marks nothing) and on a sparse detector
    (the window finds chunk 1 alone, the flag stays clear and K1 marks the
    run: the fallback). Either way the counts, the image and the reservoir
    equal, bit for bit, those of the run that marks every chunk in K1
    (``PROBE_MIN_RAYS`` above the run), and the reservoir agrees with JAX's
    interpreted megakernel."""
    monkeypatch.setattr(ft, "PROBE_MIN_RAYS", 0)
    cfg = _spectrometer_config(intensity=N_RAYS, engine="fused")
    seed = 5
    if chain == "sparse":
        cfg["optics"]["detector"].update(xsize=0.03, ysize=0.024)
        seed = 7
    ref, out, hist = _both(cfg, "found", 2, seed)
    _assert_reservoirs_agree(ref, out, list(out["history"]))
    fparams, U, spec, n = _twin_inputs(cfg, 2, seed)
    probe = ft.history_probe_plain(fparams, n, n, spec, U)
    assert ft.probe_windows(spec, n) == [(0, 2)] and probe.chunks == 2
    if chain == "dense":
        assert int(probe.used) == 2 and int(probe.marks[-1]) == 1
        assert probe.marks[:2].tolist() == [1, 1] and not probe.marks[2:-1].any()
        assert hist.chunks.tolist() == [0, 1]
    else:
        assert int(probe.used) == 1 and int(probe.marks[-1]) == 0
        assert probe.marks[:-1].nonzero().flatten().tolist() == [1]
        assert hist.chunks.tolist() == [1, 6]
    counts, image, probed = ft.fused_run_plain(fparams, n, n, U, history=spec)
    monkeypatch.setattr(ft, "PROBE_MIN_RAYS", 1 << 62)
    counts_m, image_m, marked = ft.fused_run_plain(fparams, n, n, U, history=spec)
    for a, b in ((counts, counts_m), (image, image_m), (hist.slots, marked.slots),
                 (hist.chunks, marked.chunks), (hist.used, marked.used),
                 (probed.slots, marked.slots), (probed.chunks, marked.chunks)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_probe_runs_from_its_least_run_size():
    """A 'found' run of ``PROBE_MIN_RAYS`` rays or more probes, and a
    shorter one takes zeroed marks, which K1 makes; 'sampled' takes
    neither."""
    tp = TorchPipeline(_spectrometer_config(intensity=N_RAYS, engine="fused"), device="cpu")
    fparams = ft.pack_params(ft._source_spec(tp.source), [ft._optic_spec(o) for o in tp.optics],
                             tp.params, "cpu")
    calls = []

    def prober(fp, n_total, count, spec, *args):
        calls.append(n_total)
        covered = min(spec.n_chunks(n_total), 16)
        return ft.Probe(torch.zeros(spec.n_chunks(n_total) + 1, dtype=torch.int32),
                        torch.zeros((), dtype=torch.int32), covered)

    spec = ft.HistorySpec("found", 8, 8192)
    big, small = ft.PROBE_MIN_RAYS, ft.PROBE_MIN_RAYS - 1
    for n, probed in ((big, True), (small, False)):
        marks, got = ft._found_marks(fparams, n, n, spec, None, (0, 0), None, prober)
        assert got == probed and marks.shape == (spec.n_chunks(n) + 1,)
        assert not marks.any()
    assert calls == [big]
    assert ft._found_marks(fparams, big, big, ft.HistorySpec("sampled", 8, 8192), None,
                           (0, 0), None, prober) == (None, False)


@pytest.mark.parametrize("n_chunks,slots,windows", [
    (32768, 8, [(0, 8), (8, 24), (24, 32)]),
    (512, 8, [(0, 8)]),
    (128, 8, [(0, 8)]),
    (8, 2, [(0, 2)]),
    (5, 8, [(0, 5)]),
    (20000, 8, [(0, 8), (8, 20)]),
])
def test_probe_windows_double_up_to_a_share_of_the_run(n_chunks, slots, windows):
    """The probe's windows: ``slots`` chunks, then twice as many each time,
    from chunk 0 in order, up to ceil(n_chunks / 1024) chunks
    (``PROBE_SHARE``) and at least the first ``slots`` (every chunk of a
    shorter run)."""
    assert ft.PROBE_SHARE == 1024
    spec = ft.HistorySpec("found", slots, 1024)
    got = ft.probe_windows(spec, n_chunks * 1024 - 100)
    assert got == windows
    assert got[-1][1] == min(n_chunks, max(slots, -(-n_chunks // 1024)))


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


def _past_k1():
    """A plasma of more bundles than K1 takes (``tests/test_torch_trace_
    only.py``'s, 2^22 + 1): only K3 can run it, and K3 keeps no history."""
    from tests.test_torch_trace_only import _big_plasma

    cfg = _big_plasma()
    cfg["general"]["keep_history"] = "found"
    return cfg


def test_k3_only_config_refuses_history_on_fused_and_degrades_on_auto(caplog):
    cfg = _past_k1()
    with pytest.raises(ft.FusedUnsupported, match="megakernel"):
        raytrace(cfg, device="cpu")
    cfg["general"]["engine"] = "auto"
    with caplog.at_level(logging.WARNING, logger="xicsrt_tpu_torch"):
        res = raytrace(cfg, device="cpu")
    assert any("degrades to FULL per-ray history" in r.message for r in caplog.records)
    n_det = res["total"]["meta"]["detector"]["num_out"]
    assert res["found"]["history"]["detector"]["origin"].shape[0] == n_det


# ---------------------------------------------------------------------------
# The found/lost split (engine._sort_history) against the algorithm it
# replaces: masks and every field copied to numpy, indexed there.
# ---------------------------------------------------------------------------

def _history_of(cfg):
    """One run's device history and element names, as ``raytrace_single``
    hands them to the split."""
    runner, pipe = engine.build_runner(cfg, device="cpu")
    out = runner(pipe.params, engine._run_generator(pipe.general, 0, pipe.device))
    return out["history"], pipe.element_names


@pytest.mark.parametrize("max_lost", [300, 10**6])
@pytest.mark.parametrize("which", ["fused found", "fused sampled weight", "eager full"])
def test_sort_history_matches_the_numpy_split(which, max_lost):
    """The split on the fused reservoir ('found', and 'sampled' in weight
    mode, whose weights are a field of their own) and on the eager engine's
    full history equals the numpy split on the same history and seed:
    keys and their order, dtypes, shapes and every value in ray order; the
    lost sample truncated (300) or whole."""
    if which == "eager full":
        cfg = _spectrometer_config(intensity=4096, num_iter=2, engine="xla",
                                   keep_history=True)
    else:
        mode = which.split()[1]
        cfg = _spectrometer_config(intensity=N_RAYS, num_iter=2, engine="fused",
                                   keep_history=mode, history_found_slots=1,
                                   interact_mode="weight" if "weight" in which else "mc")
    history, names = _history_of(cfg)
    got = engine._sort_history(history, names, max_lost, np.random.default_rng(11))
    want = chip_smoke.sort_history_numpy(history, names, max_lost, np.random.default_rng(11))
    chip_smoke.splits_equal(got, want, which)
    n_lost = want[1][names[0]]["mask"].shape[0]
    assert want[0][names[-1]]["mask"].shape[0] > 0 and n_lost > 0
    assert (n_lost == 300) == (max_lost == 300)


@pytest.mark.parametrize("probe_from", [0, 1 << 62], ids=["probed", "marked"])
def test_found_run_totals_equal_the_run_without_history(probe_from, monkeypatch):
    """A 'found' run's meta and images equal, bit for bit, those of the same
    run without history, whether it probes (``PROBE_MIN_RAYS`` 0: the
    probe, then K1's twin, which marks only where the probe's flag is
    clear) or K1 marks every chunk."""
    monkeypatch.setattr(ft, "PROBE_MIN_RAYS", probe_from)
    res = {kh: raytrace(_spectrometer_config(intensity=N_RAYS, num_iter=2, engine="fused",
                                             keep_history=kh, history_found_slots=2),
                        device="cpu")
           for kh in (False, "found")}
    chip_smoke.totals_equal(res["found"], res[False], f"PROBE_MIN_RAYS {probe_from}")
    assert res["found"]["found"]["history"]["detector"]["mask"].shape[0] > 0


def test_results_rays_are_the_reservoir_fields():
    """``_results`` rebuilds each element's ``Rays`` from the reservoir's
    rows: a contiguous (N, 3) origin and direction, the wavelength, the
    weight (field 8 in weight mode), and the mask alive and in a used
    slot."""
    n_opt, n_fields, slots, chunk = 2, 9, 3, 1024
    gen = torch.Generator().manual_seed(2)
    res = torch.rand((slots, n_fields * (1 + n_opt), chunk), generator=gen)
    res[:, 7::n_fields] = (res[:, 7::n_fields] > 0.5).float()
    hist = ft.History(res, torch.tensor([4, 9, 0], dtype=torch.int32),
                      torch.tensor(2, dtype=torch.int32))
    names = ["source", "crystal", "detector"]
    out = ft._results(torch.zeros(3), torch.zeros(0), [], names, False, False, hist)
    for e, name in enumerate(names):
        rays = out["history"][name]
        rows = res[:, e * n_fields:(e + 1) * n_fields].permute(1, 0, 2).reshape(n_fields, -1)
        for key, lo in (("origin", 0), ("direction", 3)):
            t = getattr(rays, key)
            assert t.is_contiguous() and torch.equal(t, rows[lo:lo + 3].T)
        assert torch.equal(rays.wavelength, rows[6]) and torch.equal(rays.weight, rows[8])
        valid = torch.arange(slots * chunk) < 2 * chunk
        assert torch.equal(rays.mask, (rows[7] != 0) & valid)


def test_profiler_totals_hold_the_run_and_the_split():
    """``raytrace`` with the profiler on records the spans ``chip_smoke.py``
    reads of a 'found' call: ``raytrace_run`` and ``sort_history``, one
    call each."""
    from xicsrt_tpu_torch.utils.profiler import profiler

    cfg = _spectrometer_config(intensity=N_RAYS, engine="fused", keep_history="found",
                               history_found_slots=1)
    profiler.reset()
    profiler.enable()
    try:
        raytrace(cfg, device="cpu")
    finally:
        profiler.disable()
    totals = profiler.totals()
    profiler.reset()
    for name in ("raytrace_run", "sort_history"):
        assert totals[name][1] == 1 and totals[name][0] > 0, name
