"""Long optic chains on the fused engines against the JAX package, on the
CPU: K1, K1e and K3 take the 127 optics JAX's megakernel takes, K5f/K5b the
42 its fused gradient takes, and apertures and source filters have no count
limit of the port's own.

The chains are ``xicsrt_tpu_torch/tools/bench_scenarios.baffle_config``:
the flagship behind a stack of circular aperture plates (``baffle27``: 24
plates, 27 optics; ``baffle127``: 124, 127 optics). JAX runs its Pallas
kernels through the interpreter on ``jax.random.uniform(key, (n_chunks,
n_draws, 8, 128))`` and the port's twins take the same uniforms in their ray
order (``tests/test_torch_fused.py``). Tolerances are the modules' own:
counts within 3 rays a element and images within 2 a such ray (L1) of
JAX's (``tests/test_torch_mirror.py``), the reservoir as
``tests/test_torch_history.py`` holds it, K5's images and vjp as
``tests/test_torch_fused_grad.py`` holds the flagship chain's. Where both
sides are the port's own twin on the same uniforms (the pass-through
invariant), the results are equal to the bit.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import xicsrt_tpu
from tests.test_torch_fused_grad import _config as _grad_config
from tests.test_torch_fused_grad import _gs, _np_tree
from tests.test_torch_history import _assert_reservoirs_agree, _both
from tests.test_torch_mirror import k1_twin_against_jax, k3_twin_against_jax
from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops import fused_grad as FG
from xicsrt_tpu.ops import fused_trace as jax_ft
from xicsrt_tpu_torch import engine, params_from_jax, raytrace
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.gradients import make_fused_differentiable
from xicsrt_tpu_torch.ops import fused_grad as fg
from xicsrt_tpu_torch.ops import fused_trace as ft
from xicsrt_tpu_torch.tools.bench_scenarios import (_spectrometer_config, baffle_config,
                                                    with_baffles)
from xicsrt_tpu_torch.tools.roofline import k1_live_ops, live_lanes

N_RAYS = 8192


def _packed(cfg, device="cpu"):
    pipe = TorchPipeline(cfg, device=device)
    src = ft._source_spec(pipe.source, {f.name: f for f in pipe.filters})
    optics = [ft._optic_spec(o) for o in pipe.optics]
    return pipe, ft.pack_params(src, optics, pipe.params, device,
                                **ft._chain_modes(pipe.general))


# ---------------------------------------------------------------------------
# (a) The limits: JAX's, and none of the port's own on apertures and filters.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plates,ok", [(124, True), (125, False)], ids=["127", "128"])
def test_trace_kernels_take_127_optics_and_refuse_128_as_jax(plates, ok):
    cfg = baffle_config(plates, 1024, engine="fused")
    pipe = TorchPipeline(cfg, device="cpu")
    assert len(pipe.optics) == plates + 3
    if ok:
        assert callable(ft.build_fused_run(pipe))
        assert callable(ft.build_fused_trace_run(pipe))
        return
    for build in (ft.build_fused_run, ft.build_fused_trace_run):
        with pytest.raises(ft.FusedUnsupported, match="^more than 127 optics$"):
            build(pipe)
    with pytest.raises(jax_ft.FusedUnsupported, match="^more than 127 optics$"):
        jax_ft.build_fused_run(JaxPipeline(cfg), interpret=True)


@pytest.mark.parametrize("plates,ok", [(39, True), (40, False)], ids=["42", "43"])
def test_gradient_kernels_take_42_optics_and_refuse_43_as_jax(plates, ok):
    cfg = baffle_config(plates, 1024, interact_mode="weight", image_mode="bilinear")
    if ok:
        _, _, _, spec = fg.build_fused_diff(TorchPipeline(cfg, device="cpu"))
        assert spec["static"].n_optics == 42 and fg.n_slots_of(spec["static"]) == 1008
        return
    with pytest.raises(fg.FusedGradUnsupported, match="^more than 42 optics$"):
        make_fused_differentiable(cfg, device="cpu")
    with pytest.raises(FG.FusedGradUnsupported, match="^more than 42 optics$"):
        FG.build_fused_diff(JaxPipeline(cfg), interpret=True)


def _many_sightlines(n_filters, intensity):
    """The flagship's source as a 2 cm box behind ``n_filters`` sightlines
    along +z, each a little off axis, so each cuts some origins."""
    cfg = _spectrometer_config(intensity, engine="fused")
    names = [f"sight{k}" for k in range(n_filters)]
    cfg["sources"]["source"].update(xsize=0.02, ysize=0.02, filters=names)
    cfg["filters"] = {n: {"class_name": "XicsrtBundleFilterSightline",
                          "origin": [0.0005 * np.cos(k), 0.0005 * np.sin(k), 0.0],
                          "zaxis": [0.0, 0.0, 1.0], "radius": 0.012}
                      for k, n in enumerate(names)}
    return cfg


def test_more_than_64_apertures_and_8_filters_pack_and_match_jax():
    """70 apertures on one plate and 9 sightline filters on the source pack
    and run on K1; the twin against JAX's K1."""
    cfg = _many_sightlines(9, 4096)
    plate = cfg["optics"]["aperture"]
    plate["aperture"] = plate["aperture"] + [
        {"shape": "circle", "size": [0.2 + 0.001 * k], "logic": "and"} for k in range(68)]
    _, fparams = _packed(cfg)
    assert fparams.ip_host[1] == 70 and fparams.ip_host[ft.H_FILTERS] == 9
    assert TorchPipeline(cfg, device="cpu") is not None
    assert engine.build_runner(cfg, device="cpu")[0].__qualname__.startswith("build_fused_run")
    counts, _, _ = k1_twin_against_jax(cfg, seed=7)
    assert 0 < int(counts[0]) < 4096 and int(counts[-1]) > 0


def test_head_counts_the_packed_buffers():
    """The trace kernels' head (``xrt_head_floats``): 128 counters, ip and
    fp rounded to 16 bytes; the flagship's 1472 bytes, baffle127's (126
    apertures) under 32 KB."""
    _, fparams = _packed(_spectrometer_config(1024, engine="fused"))
    n_fp, n_ip = fparams.fp.numel(), fparams.ip.numel()
    assert (n_fp, n_ip) == (168, 70) and ft.head_bytes(n_fp, n_ip) == 1472
    _, fparams = _packed(baffle_config(124, 1024, engine="fused"))
    n_fp, n_ip = fparams.fp.numel(), fparams.ip.numel()
    assert fparams.n_optics + 1 == ft.MAX_OPTICS + 1 == 128
    assert ft.head_bytes(n_fp, n_ip) % 16 == 0 and ft.head_bytes(n_fp, n_ip) < 32 * 1024


# ---------------------------------------------------------------------------
# (b)-(e) baffle27 and a 33-optic chain against the interpreted JAX kernels.
# ---------------------------------------------------------------------------

def test_baffle27_k1_twin_matches_jax_megakernel():
    cfg = baffle_config(24, N_RAYS, engine="fused")
    counts, ref, fparams = k1_twin_against_jax(cfg, seed=27)
    assert fparams.n_optics == 27
    assert int(counts[1]) < N_RAYS and int(counts[-1]) > 20  # the first plate clips
    # The same counts by the rays' reaches, as K1 takes them.
    from tests.test_torch_mirror import _uniforms

    uniforms = _uniforms(jax.random.key(27), fparams.n_draws, N_RAYS)
    _assert_counts_by_reach(*_reaches(fparams, N_RAYS, uniforms))


def test_baffle27_found_reservoir_matches_jax():
    cfg = baffle_config(24, N_RAYS, engine="fused")
    ref, out, hist = _both(cfg, "found", 2, seed=27)
    names = list(out["history"])
    assert len(names) == 28 and names[-1] == "detector"
    _assert_reservoirs_agree(ref, out, names)
    assert hist.slots.shape[1] == 8 * 28 and int(hist.used) == 2
    assert int(out["history"]["detector"].mask.sum()) > 5


def test_baffle27_k3_twin_matches_jax_trace_only():
    cfg = baffle_config(24, N_RAYS, engine="fused")
    counts, _, fparams = k3_twin_against_jax(cfg, seed=27)
    assert fparams.n_optics == 27 and int(counts[-1]) > 20


def _chain33():
    """The gradient tests' flagship chain behind 30 plates (33 optics) at
    one JAX chunk of rays: JAX's pipeline and K5 spec, the port's
    ``build_fused_diff``, JAX's uniforms (and in the port's ray order) and
    both packed parameter vectors."""
    cfg = with_baffles(_grad_config(intensity=1024), 30)
    jp = JaxPipeline(cfg)
    jforward, jvjp, jpack, jspec = FG.build_fused_diff(jp, chunk=1024, interpret=True,
                                                       rng="input")
    forward, vjp, pack, spec = fg.build_fused_diff(TorchPipeline(cfg, device="cpu"),
                                                   rng="input", chunk=1024)
    assert spec["static"].n_optics == 33
    key = jax.random.key(33)
    U = jax.random.uniform(key, (jspec["n_chunks"], jspec["n_draws"], 8, 128),
                           dtype=jnp.float32)
    Ut = torch.tensor(np.asarray(U)).permute(1, 0, 2, 3).reshape(jspec["n_draws"], -1)
    jpvec = jpack(jp.params)
    pvec = pack(params_from_jax(_np_tree(jp.params), device="cpu"))
    np.testing.assert_array_equal(pvec.numpy(), np.asarray(jpvec))
    return {"jforward": jforward, "jspec": jspec, "key": key, "U": U, "jpvec": jpvec,
            "forward": forward, "vjp": vjp, "spec": spec, "pvec": pvec,
            "Ut": Ut[:, :spec["n_total"]].contiguous()}


def test_33_optic_forward_matches_jax_kernel():
    """make_fused_differentiable's forward on a 33-optic chain against
    JAX's interpreted K5f on the same uniforms: totals rtol 2e-4, pixels
    1e-3 of the largest."""
    c = _chain33()
    ref = _np_tree(c["jforward"](c["jpvec"], c["key"])["image"])
    out = c["forward"](c["pvec"], 0, uniforms=c["Ut"])["image"]
    assert set(out) == set(ref)
    for name, img in out.items():
        img = img.numpy()
        assert ref[name].sum() > 0
        np.testing.assert_allclose(img.sum(), ref[name].sum(), rtol=2e-4)
        np.testing.assert_allclose(img, ref[name], rtol=0, atol=1e-3 * np.abs(ref[name]).max())


def test_33_optic_vjp_matches_jax_autodiff():
    """The float32 vjp on a 33-optic chain against JAX's float32 reference
    for its K5b: ``jax.grad`` of ``tests/test_fused_grad.py``'s replica of
    the kernel's loss (JAX's own forward functions, the check JAX's tests
    hold K5b to; its interpreted K5b takes minutes on 33 optics here), on
    the same uniforms, at the bound the port's vjp keeps to JAX's kernel:
    rtol 2e-3, atol 2e-5 of the largest slot."""
    from tests.test_fused_grad import _replica_loss

    c = _chain33()
    gs = _gs(c["spec"])
    ref = np.asarray(jax.jit(jax.grad(
        lambda v: _replica_loss(c["jspec"], v, c["U"], gs)))(c["jpvec"]))
    ours = c["vjp"](c["pvec"], 0, gs, uniforms=c["Ut"]).numpy()
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-5 * scale)


# ---------------------------------------------------------------------------
# (f) The pass-through invariant at 127 optics, (g) 'auto' takes K1, and the
# bound of a 127-optic chain.
# ---------------------------------------------------------------------------

def test_127_optic_pass_through_equals_the_flagship_to_the_bit():
    """124 plates that every ray clears (a circle of 10 m): plates draw
    nothing, so the aperture, crystal and detector see the flagship's rays;
    their counts and images equal the 3-optic flagship's to the bit under
    the same draws, in both RNG modes, and each plate counts the source."""
    wide = baffle_config(124, N_RAYS, engine="fused")
    for k in range(124):
        wide["optics"][f"baffle{k:03d}"]["aperture"][0]["size"] = [10.0]
    _, long_ = _packed(wide)
    _, short = _packed(_spectrometer_config(N_RAYS, engine="fused"))
    assert long_.n_optics == 127 and long_.n_draws == short.n_draws
    U = torch.rand((short.n_draws, N_RAYS), generator=torch.Generator().manual_seed(127))
    for kwargs in ({"seed": (12, 7)}, {"uniforms": U}):
        c_long, i_long = ft.fused_run_cuda(long_, N_RAYS, N_RAYS, **kwargs)
        c_short, i_short = ft.fused_run_cuda(short, N_RAYS, N_RAYS, **kwargs)
        assert torch.equal(c_long[-3:], c_short[1:]) and torch.equal(i_long, i_short)
        assert c_long[:125].tolist() == [N_RAYS] * 125
        assert int(c_short[-1]) > 0


def test_auto_runs_a_27_optic_chain_on_the_fused_engine(caplog):
    cfg = baffle_config(24, N_RAYS, engine="auto")
    runner, _ = engine.build_runner(cfg, device="cpu")
    assert runner.__qualname__.startswith("build_fused_run")
    with caplog.at_level(logging.INFO, logger="xicsrt_tpu_torch"):
        res = raytrace(cfg, device="cpu")
    assert not any("fused engine unavailable" in r.message for r in caplog.records)
    meta = res["total"]["meta"]
    assert len(meta) == 28 and meta["source"]["num_out"] == N_RAYS
    assert res["total"]["image"]["detector"].sum() == meta["detector"]["num_out"] > 0


def test_127_optic_bound_counts_the_rays_alive_into_each_optic():
    """``tools/roofline``'s bound of baffle127 (``chip_smoke.k1_bounds``):
    the rays alive into each optic from the twin's masks, the first plate
    the source's count and every later one the rays its predecessor kept;
    fewer operations than every ray through every optic."""
    _, fparams = _packed(baffle_config(124, N_RAYS, engine="fused"))
    live = live_lanes(fparams, N_RAYS)
    counts = live["counts"]
    assert len(live["rays_into"]) == 127
    assert live["rays_into"] == counts[:127]
    ops = k1_live_ops(fparams, live, N_RAYS)
    assert 0 < ops["live_rays"] < ops["flat"]
    assert chip_smoke.k1_bounds(fparams, N_RAYS)[0][0] > 0


# ---------------------------------------------------------------------------
# Example 02 (the aperture logic whose packing moved) on both port engines.
# ---------------------------------------------------------------------------

def test_example02_engines_match_jax():
    """``examples/example_02_aperture.py``'s config at 2 iterations, random
    seed 0, on JAX and on the port's eager and fused engines: the detector
    counts pairwise within 5 binomial sigma."""
    cfg = chip_smoke.example_config("example_02_aperture.py")
    cfg["general"].update(number_of_iter=2, random_seed=0, print_results=False,
                          keep_history=False)
    n = 2 * int(cfg["sources"]["source"]["intensity"])
    hits = {"jax": int(xicsrt_tpu.raytrace(cfg)["total"]["meta"]["detector"]["num_out"])}
    for kind in ("xla", "fused"):
        run = dict(cfg, general=dict(cfg["general"], engine=kind))
        res = raytrace(run, device="cpu")
        assert res["total"]["meta"]["source"]["num_out"] == n
        hits[kind] = int(res["total"]["meta"]["detector"]["num_out"])
    names = list(hits)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            pooled = (hits[a] + hits[b]) / (2 * n)
            sigma = (pooled * (1 - pooled) * 2 / n) ** 0.5
            assert abs(hits[a] - hits[b]) / n < 5 * sigma, (a, b, hits)
    assert 0.2 < hits["fused"] / n < 0.4


def test_a_head_past_a_blocks_shared_memory_is_refused():
    """Apertures have no count limit of their own: only packed buffers too
    large for the head of a block's shared memory (``HEAD_MAX_BYTES``,
    about 8000 apertures) are refused, with ``FusedUnsupported``."""
    cfg = _spectrometer_config(1024, engine="fused")
    plate = cfg["optics"]["aperture"]
    plate["aperture"] = [{"shape": "circle", "size": [0.2], "logic": "and"}] * 8200
    with pytest.raises(ft.FusedUnsupported, match="shared memory"):
        _packed(cfg)
    plate["aperture"] = plate["aperture"][:7800]
    fparams = _packed(cfg)[1]
    assert ft.head_bytes(fparams.fp.numel(), fparams.ip.numel()) <= ft.HEAD_MAX_BYTES


# ---------------------------------------------------------------------------
# (f) The premises of the long-chain kernels' designs, on the twins: K1 and
# K3 count each ray once, by its reach (the source and the elements it
# leaves alive), and K5b replays each optic from its saved entry state.
# ---------------------------------------------------------------------------

def _reach_chain(chain, n, mode):
    general = {"interact_mode": "weight"} if mode == "weight" else {}
    if chain == "baffle27":
        return baffle_config(24, n, engine="fused", **general)
    if chain == "mosaic":
        return chip_smoke.mosaic15_config(n, 1, "fused", **general)
    cfg = chip_smoke.variant_config("torus_crystal")
    cfg["general"].update(engine="fused", number_of_iter=1, **general)
    cfg["sources"]["source"]["intensity"] = n
    return cfg


def _reaches(fparams, n, uniforms):
    """The K1 twin on ``n`` rays of ``uniforms`` with its record hook: (each
    element's alive, the source's as row 0; the twin's counts)."""
    F, I = [float(x) for x in fparams.fp.tolist()], [int(x) for x in fparams.ip.tolist()]
    alive = torch.zeros((1 + fparams.n_optics, n), dtype=torch.bool)

    def record(e, px, py, pz, dx, dy, dz, a, wt, wl=None):
        alive[e] = a

    counts = torch.zeros(1 + fparams.n_optics, dtype=torch.int64)
    image = torch.zeros(fparams.img_total, dtype=torch.float32)
    (rays, at_source, attrs), = list(ft._slices(fparams, n, n, None))
    ft._trace_slice(F, I, fparams.aux, at_source, ft._draws(fparams, rays, uniforms, (0, 0)),
                    counts, image, attrs, record=record)
    return alive, counts


def _assert_counts_by_reach(alive, counts):
    """No ray alive after an element where it was dead before it, and the
    suffix sums of the histogram of the rays' reaches
    (``ft.reach_counts_plain``, the kernels' ``xrt_count_reach``) are the
    per-element counts."""
    assert not bool((alive[1:] & ~alive[:-1]).any())
    reach = torch.where(alive[0], alive[1:].sum(dim=0), -1)
    assert torch.equal(ft.reach_counts_plain(reach, alive.shape[0] - 1), counts)


@pytest.mark.parametrize("mode", ["mc", "weight"])
@pytest.mark.parametrize("chain", ["baffle27", "mosaic", "torus"])
def test_counts_are_the_suffix_sums_of_the_rays_reaches(chain, mode):
    """Along the K1 twin's chain (its record hook: each element's alive),
    in mc and weight mode, alive never returns, and the counts K1 and K3
    now take by reach are the twin's per-element counts (against JAX's on
    baffle27: test_baffle27_k1_twin_matches_jax_megakernel)."""
    n = 1024
    _, fparams = _packed(_reach_chain(chain, n, mode))
    uniforms = torch.rand((fparams.n_draws, n), generator=torch.Generator().manual_seed(21))
    alive, counts = _reaches(fparams, n, uniforms)
    assert int(alive[-1].sum()) > 0 and int(alive[0].sum()) > int(alive[-1].sum())
    _assert_counts_by_reach(alive, counts)
    assert torch.equal(counts, ft.fused_run_plain(fparams, n, n, uniforms=uniforms)[0])


def _same(a, b) -> bool:
    """Equal to the bit: tensors (NaN where NaN), and tuples, lists and
    dicts of them."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())
        return torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("chain", ["baffle42", "mosaic_sphere", "torus_crystal"])
def test_k5_optic_replayed_from_its_entry_state_gives_the_forwards_locals(chain):
    """K5b's replay build on the K5 twin: optic i run alone from the ray's
    saved entry state (position, direction, weight; alive from the first
    optic that lost the ray) with its draws from a cursor at the source's
    draws plus the optics' before it (``fg.optic_draws_plain``) gives the
    full forward's locals, exit state and image terms bit for bit, under
    explicit uniforms; on baffle42's first 8 optics, a mosaic chain and a
    torus chain."""
    n = 256
    cfg = (baffle_config(39, n, 1, interact_mode="weight", image_mode="bilinear")
           if chain == "baffle42" else chip_smoke.grad_variant(chain, n))
    _, _, pack, pipe = make_fused_differentiable(cfg, device="cpu")
    spec = fg.build_fused_diff(pipe, num_iter=1)[3]
    static, lam = spec["static"], spec["lam"]
    P = pack(pipe.params).detach()
    F, I = fg._static_lists(static)
    gen = torch.Generator().manual_seed(5)
    rows = list(torch.rand((static.n_draws, n), generator=gen))

    def draws_from(k):
        pos = [k]

        def draw():
            pos[0] += 1
            return rows[pos[0] - 1]
        return draw, pos

    draw, pos = draws_from(0)
    state, lam_r, _ = fg._source_state(F, I, P, torch.arange(n), draw, lam)
    n_opt = min(I[0], 8)
    saved = []  # (entry state, cursor, locals, exit state, image terms)
    for e in range(n_opt):
        cursor = pos[0]
        out = fg._optic_fwd(F, I, static.aux, e, P, lam_r, state, draw)
        assert pos[0] == cursor + fg.optic_draws_plain(I, e)
        saved.append((state, cursor, *out))
        state = out[0]
    exits = torch.stack([s[2][7] for s in saved])
    first_dead = torch.where(~exits.all(dim=0), (~exits).int().argmax(dim=0), n_opt)
    for i, (entry, cursor, exit_state, locs, img) in enumerate(saved):
        alive = first_dead >= i
        assert torch.equal(alive, entry[7])
        replay, _ = draws_from(cursor)
        out = fg._optic_fwd(F, I, static.aux, i, P, lam_r, (*entry[:7], alive), replay)
        assert _same(out, (exit_state, locs, img)), f"optic {i}"
    if chain == "mosaic_sphere":
        assert any(fg.optic_draws_plain(I, e) > 0 for e in range(n_opt))
