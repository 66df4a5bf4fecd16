"""File rocking curves on every engine of the port against the JAX package.

- ``utils/bragg_files`` reads an XOP table, a simple one and a sigma/pi
  pair of files exactly as JAX's copy does (the tables are written here by
  ``tests/test_coverage_extra.py``'s writer; nothing is downloaded).
- The eager crystal's probability against JAX's XLA interaction on the same
  deviations: float32, to 1e-6 (the two interpolate alike; XLA may fuse a
  multiply-add). A pure-sigma curve of the gaussian's shape detects as the
  gaussian crystal does, within 6 sqrt(N) (``test_coverage_extra.py:71-91``).
- K1's file stage (K1c-file): the twin against the interpreted JAX
  megakernel under the same uniforms on ``tests/test_fused_engine.py``'s file
  crystal (:528-550, ``rocking_mix`` 0.7), and K3's twin against JAX's
  trace-only kernel, with ``tests/test_torch_mirror.py``'s bound.
- K5's (K5c-file): the twins on ``tests/test_fused_grad.py``'s
  ``file_rocking`` variant against the interpreted JAX K5 kernels: images
  as ``tests/test_torch_fused_grad.py`` holds them, the adjoint within rtol
  1e-3, atol 1e-5 of the largest slot (the two take the same table values
  and slopes; XLA may fuse the matvec's two products); the hand adjoint
  against ``torch.autograd`` of the forward twin at float64 (rtol 1e-9); and
  the slope on a node of the table, which reads exactly 0 in both packages.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xicsrt_tpu
from tests.test_coverage_extra import _base_config, _write_xop_file
from tests.test_fused_grad import _variant_config
from tests.test_torch_fused_grad import _flat, _gs, _np_tree
from tests.test_torch_mirror import k1_twin_against_jax, k3_twin_against_jax
from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops import fused_grad as FG
from xicsrt_tpu.utils import bragg_files as jax_bragg_files
from xicsrt_tpu_torch import params_from_jax, raytrace
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.ops import fused_grad as fg
from xicsrt_tpu_torch.ops import fused_trace as ft
from xicsrt_tpu_torch.utils import bragg_files


@pytest.fixture(scope="module")
def xop(tmp_path_factory):
    path = tmp_path_factory.mktemp("rocking") / "diff_pat.dat"
    _write_xop_file(str(path), fwhm=150e-6)
    return str(path)


def _file_crystal(xop, mix=0.7, **general):
    """``tests/test_fused_engine.py:528-550``'s file crystal on the
    flagship geometry (spherical crystal, detector)."""
    cfg = _base_config(**general)
    cfg["optics"]["crystal"].update(rocking_type="file", rocking_fwhm=None,
                                    rocking_file=xop, rocking_filetype="xop",
                                    rocking_mix=mix)
    return cfg


def test_bragg_files_match_jax(xop, tmp_path):
    ours, ref = bragg_files.read(xop), jax_bragg_files.read(xop)
    simple = tmp_path / "curve.txt"
    rng = np.random.default_rng(3)
    cols = np.stack([np.sort(rng.uniform(-1e-3, 1e-3, 50))[::-1], rng.random(50),
                     rng.random(50)], axis=-1)
    np.savetxt(simple, cols, header="dtheta reflect_s reflect_p")
    pairs = [(ours, ref), (bragg_files.read(str(simple), "simple"),
                           jax_bragg_files.read(str(simple), "simple")),
             (bragg_files.read([str(simple), xop], "simple"),
              jax_bragg_files.read([str(simple), xop], "simple"))]
    for a, b in pairs:
        assert set(a) == set(b) == {"dtheta", "reflect_s", "reflect_p"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert np.all(np.diff(ours["dtheta"]) > 0) and ours["dtheta"][0] == pytest.approx(-300e-6)
    with pytest.raises(ValueError):
        bragg_files.read(str(simple))  # the filetype cannot be guessed


def test_eager_file_crystal_matches_jax(xop):
    cfg = _file_crystal(xop)
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    delta = np.random.default_rng(5).uniform(-400e-6, 400e-6, 20000).astype(np.float32)
    delta[:5] = [-300e-6, 300e-6, 0.0, -301e-6, 301e-6]
    jopt = jp.optics[0]
    ref = np.asarray(jopt.make_reflection_probability()(jp.params["optics"]["crystal"],
                                                        jnp.asarray(delta)))
    crystal = tp.optics[0]
    ours = crystal.reflection_probability(tp.params["optics"]["crystal"],
                                          torch.from_numpy(delta)).numpy()
    assert ref.max() > 0.8 and ref[3] == ref[4] == 0.0  # 0.7 sigma + 0.3 pi at the peak
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def test_sigma_only_curve_detects_as_the_gaussian(xop, tmp_path):
    """A pure-sigma table of the gaussian's shape (48 urad) on the eager
    engine detects as the gaussian crystal does."""
    table = tmp_path / "diff_pat.dat"
    _write_xop_file(str(table))
    counts = []
    for cfg in (_base_config(number_of_iter=4), _file_crystal(str(table), mix=1.0,
                                                               number_of_iter=4)):
        counts.append(raytrace(cfg, device="cpu")["total"]["meta"]["detector"]["num_out"])
    assert min(counts) > 100
    assert abs(counts[0] - counts[1]) < 6 * np.sqrt(counts[0]), counts


def test_k1_file_twin_matches_jax_megakernel(xop):
    cfg = _file_crystal(xop)
    cfg["sources"]["source"]["intensity"] = 8192
    counts, ref, fparams = k1_twin_against_jax(cfg, seed=51)
    assert not fparams.cheb and int(counts[-1]) > 50
    K = int(fparams.ip[ft.HDR_I + ft.OI_K])
    assert K == 2048 and fparams.aux.numel() == 1 + K


def test_k3_file_twin_matches_jax_trace_only(xop):
    cfg = _file_crystal(xop)
    cfg["sources"]["source"]["intensity"] = 8192
    counts, _, _ = k3_twin_against_jax(cfg, seed=53)
    assert int(counts[-1]) > 50


def test_engines_agree_on_a_file_crystal(xop):
    cfg = _file_crystal(xop, number_of_iter=2, keep_history=False)
    cfg["sources"]["source"]["intensity"] = 1 << 14
    out = {}
    for engine in ("xla", "fused"):
        c = copy.deepcopy(cfg)
        c["general"]["engine"] = engine
        out[engine] = raytrace(c, device="cpu")["total"]["meta"]["detector"]["num_out"]
    n = 1 << 15
    p = (out["xla"] + out["fused"]) / (2 * n)
    assert out["xla"] > 200
    assert abs(out["xla"] - out["fused"]) / n < 5 * np.sqrt(p * (1 - p) * 2 / n), out


@pytest.fixture(scope="module")
def file_pair():
    cfg = _variant_config("file_rocking")
    jp = JaxPipeline(cfg)
    jforward, jvjp, jpack, jspec = FG.build_fused_diff(jp, chunk=1024, interpret=True,
                                                       rng="input")
    tp = TorchPipeline(cfg, device="cpu")
    forward, vjp, pack, spec = fg.build_fused_diff(tp, rng="input", chunk=1024)
    key = jax.random.key(5)
    U = jax.random.uniform(key, (jspec["n_chunks"], jspec["n_draws"], 8, 128),
                           dtype=jnp.float32)
    U = torch.tensor(np.asarray(U)).permute(1, 0, 2, 3).reshape(jspec["n_draws"], -1)
    return {"jp": jp, "jforward": jforward, "jvjp": jvjp, "jpvec": jpack(jp.params),
            "key": key, "forward": forward, "vjp": vjp, "spec": spec,
            "pvec": pack(params_from_jax(_np_tree(jp.params), device="cpu")),
            "U": U[:, :spec["n_total"]].contiguous()}


def test_k5_file_forward_twin_matches_jax(file_pair):
    p = file_pair
    np.testing.assert_array_equal(p["pvec"].numpy(), np.asarray(p["jpvec"]))
    assert p["spec"]["static"].aux.numel() > 1
    ref = _np_tree(p["jforward"](p["jpvec"], p["key"])["image"])
    out = p["forward"](p["pvec"], 0, uniforms=p["U"])["image"]
    for name, img in out.items():
        img = img.numpy()
        assert ref[name].sum() > 0
        np.testing.assert_allclose(img.sum(), ref[name].sum(), rtol=2e-4)
        np.testing.assert_allclose(img, ref[name], rtol=0, atol=1e-3 * np.abs(ref[name]).max())


def test_k5_file_vjp_twin_matches_jax_and_autograd(file_pair):
    p = file_pair
    spec = p["spec"]
    gs = _gs(spec)
    ref = np.asarray(p["jvjp"](p["jpvec"], p["key"], gs))
    ours = p["vjp"](p["pvec"], 0, gs, uniforms=p["U"]).numpy()
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-5 * scale)
    # The hand adjoint against autograd of the forward twin, at float64.
    g = _flat(gs, spec, torch.float64)
    pvec = p["pvec"].double().requires_grad_(True)
    images = fg.fused_grad_forward_plain(spec["static"], pvec, spec["n_total"], spec["lam"],
                                         uniforms=p["U"])
    (images * g).sum().backward()
    auto = pvec.grad.numpy()
    hand = fg.fused_grad_vjp_plain(spec["static"], pvec.detach(), spec["n_total"],
                                   spec["lam"], g, uniforms=p["U"]).numpy()
    np.testing.assert_allclose(hand, auto, rtol=1e-9, atol=1e-10 * np.abs(auto).max())
    b = 0  # the crystal's slots: its pose reaches the table's slope
    assert np.abs(auto[b:b + 12]).max() > 0 and abs(auto[b + 15]) > 0


def test_file_slope_is_zero_on_a_node():
    """On a node of the table (f = k exactly) the adjoint's slope is 0, as
    JAX's tent derivative with sign(0) = 0 gives; inside a segment it is
    the segment's slope, and out of range the curve is 0."""
    K, inv_step = 16, 1024.0  # f = delta * 1024, exact in float32
    T = torch.tensor(np.random.default_rng(7).random(K).astype(np.float32))
    delta = torch.tensor([5 / 1024, 5.25 / 1024, 15 / 1024, 0.0, -1 / 1024, 16 / 1024],
                         dtype=torch.float32)
    val, inr, f, k = ft.file_value_plain(T, 0.0, inv_step, delta)
    slope = fg.file_slope_plain(T, inv_step, f, k)
    assert slope[0] == 0.0 and slope[2] == 0.0 and slope[3] == 0.0
    assert slope[1] == (T[6] - T[5]) * inv_step
    assert inr.tolist() == [True, True, True, True, False, False]
    assert val[0] == T[5] and val[2] == T[15]
    rk = {"K": K, "lo": 0.0, "inv_step": inv_step}
    jd = jnp.zeros((8, 128), jnp.float32).at[0, :6].set(jnp.asarray(delta.numpy()))
    jval, jslope, jinr = FG._file_interp(rk, T.numpy()[None, :], jd, need_slope=True)
    np.testing.assert_array_equal(np.asarray(jslope)[0, :4], slope[:4].numpy())
    np.testing.assert_array_equal(np.asarray(jval)[0, :4], val[:4].numpy())
    np.testing.assert_array_equal(np.asarray(jinr)[0, :6], inr.numpy())


def test_xla_engines_agree_on_file_reflectivity(xop):
    """The port's eager engine and JAX's XLA engine detect alike on the file
    crystal (different random streams: 5 binomial sigma)."""
    cfg = _file_crystal(xop, number_of_iter=1)
    cfg["sources"]["source"]["intensity"] = 1 << 14
    a = xicsrt_tpu.raytrace(copy.deepcopy(cfg))["total"]["meta"]["detector"]["num_out"]
    b = raytrace(cfg, device="cpu")["total"]["meta"]["detector"]["num_out"]
    n = 1 << 14
    p = (a + b) / (2 * n)
    assert a > 100 and abs(a - b) / n < 5 * np.sqrt(p * (1 - p) * 2 / n), (a, b)
