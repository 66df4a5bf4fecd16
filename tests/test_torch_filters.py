"""Source filters against the JAX package: ``filters/sightline.py``, the
config's ``filters`` section wired into a generic source (its rays) and a
plasma (its bundles), and the sightline on both engines.

Tolerances as in ``tests/test_torch_source_matrix.py``: masks, cumulative
counts and bundle origins exactly (the filter is one float32 comparison of
the same operations), positions 1e-6 m, directions 1e-5, wavelengths
5e-7 A.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _spectrometer_config
from tests.test_torch_plasma import _plasma_config
from tests.test_torch_source_matrix import assert_rays_match, jax_source_rows
from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu_torch import params_from_jax, raytrace
from xicsrt_tpu_torch.dispatch import lookup
from xicsrt_tpu_torch.draws import ExplicitDraws
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.filters import FilterBase, FilterSightline

SIGHT = {"class_name": "XicsrtBundleFilterSightline", "origin": [0.01, 0.0, 0.0],
         "zaxis": [0.0, 0.0, 1.0], "radius": 0.02}


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _np(x):
    return np.asarray(x)


def _filtered_source(n=2048, **general):
    cfg = _spectrometer_config(intensity=n, **general)
    cfg["sources"]["source"].update(xsize=0.06, ysize=0.06, filters=["sight", "pass"])
    cfg["filters"] = {"sight": dict(SIGHT), "pass": {"class_name": "XicsrtBundleFilter"}}
    return cfg


def test_registry_names():
    assert lookup("XicsrtBundleFilterSightline") is FilterSightline
    assert lookup("filter_sightline") is FilterSightline
    assert lookup("XicsrtBundleFilter") is FilterBase
    assert lookup("filter_none") is FilterBase


def test_sightline_matches_jax_on_the_same_origins():
    cfg = _filtered_source()
    cfg["filters"]["sight"].update(zaxis=[0.3, 0.1, 1.0], origin=[0.01, -0.02, 0.0],
                                   radius=0.04)
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    rng = np.random.default_rng(3)
    origin = rng.uniform(-0.05, 0.05, (4096, 3)).astype(np.float32)
    mask = rng.uniform(size=4096) < 0.9
    jflt = {f.name: f for f in jp.filters}["sight"]
    ref = _np(jflt.make_filter()(jp.params["filters"]["sight"], jnp.asarray(origin),
                                 jnp.asarray(mask)))
    tflt = {f.name: f for f in tp.filters}["sight"]
    out = tflt.make_filter()(tp.params["filters"]["sight"], torch.tensor(origin),
                             torch.tensor(mask))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert 0.1 < ref.mean() < 0.8
    passed = {f.name: f for f in tp.filters}["pass"].make_filter()(
        None, torch.tensor(origin), torch.tensor(mask))
    assert torch.equal(passed, torch.tensor(mask))


def test_params_carry_the_filters():
    cfg = _filtered_source()
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    assert set(tp.params["filters"]) == {"sight", "pass"}
    converted = params_from_jax(_tree(jp.params), device="cpu")
    for key in ("origin", "basis"):
        assert torch.equal(getattr(converted["filters"]["sight"]["frame"], key),
                           getattr(tp.params["filters"]["sight"]["frame"], key))
    assert torch.equal(converted["filters"]["sight"]["radius"],
                       tp.params["filters"]["sight"]["radius"])


def test_undefined_filter_raises_key_error():
    cfg = _filtered_source()
    del cfg["filters"]["sight"]
    with pytest.raises(KeyError, match="sight"):
        TorchPipeline(cfg, device="cpu")


def test_filtered_source_generates_as_jax():
    cfg = _filtered_source()
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    key = jax.random.key(41)
    ref = _tree(jp.generate(jp.params["sources"]["source"], jp.params["filters"], key))
    params = params_from_jax(_tree(jp.params), device="cpu")
    rows, counts = jax_source_rows(jp.source, key)
    rays = tp.source.generate(params["sources"]["source"], ExplicitDraws(rows, counts),
                              params["filters"])
    assert_rays_match(rays, ref)
    # A circle of r = 0.02 in a 0.06 box: pi 0.02^2 / 0.06^2 of the rays.
    frac = ref.mask.mean()
    expect = math.pi * 0.02**2 / 0.06**2
    assert abs(frac - expect) < 5 * math.sqrt(expect * (1 - expect) / len(ref.mask))


def _filtered_plasma():
    """``tests/test_plasma.py``'s cubic plasma with floor counts of 5.3
    photons per bundle (the port takes its own counts from the filtered
    rates) and a sightline through part of the box."""
    cfg = _plasma_config(use_poisson=False, emissivity=2.12e10, filters=["sight"])
    cfg["filters"] = {"sight": dict(SIGHT, origin=[0.02, 0.0, 0.0], radius=0.03)}
    return cfg


def test_plasma_bundle_tables_and_rays_match_jax():
    cfg = _filtered_plasma()
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    src = jp.source
    N, B = src.num_rays, src.bundle_count
    key = jax.random.key(43)
    (k_bundle, k_prof, k_counts, k_voxel, k_dir, k_wave,
     k_cauchy) = jax.random.split(key, 7)
    sp = jp.params["sources"]["plasma"]
    cum, table, _ = jax.jit(src.make_bundle_tables(jp.source_filter_fns))(
        sp, jp.params["filters"], k_bundle, k_prof, k_counts)
    cum, table = _np(cum), _np(table)
    params = params_from_jax(_tree(jp.params), device="cpu")
    rows = [_np(jax.random.uniform(k_bundle, (B, 3), dtype=jnp.float32)).reshape(-1)]
    cum_t, table_t, total = tp.source.bundle_tables(params["sources"]["plasma"],
                                                    ExplicitDraws(rows[:1]),
                                                    params["filters"])
    np.testing.assert_array_equal(cum_t.numpy(), cum)
    np.testing.assert_allclose(table_t.numpy(), table, rtol=1e-6, atol=1e-7)
    counts = np.diff(np.concatenate([[0], cum]))
    assert set(np.unique(counts)) == {0, 5}  # floor(5.3) where the sightline keeps
    assert 0 < int((counts == 0).sum()) < B and int(total) == int(cum[-1])

    # The rays of one iteration on JAX's draws.
    rows += [_np(jax.random.uniform(k_voxel, (N, 3), dtype=jnp.float32)).reshape(-1)]
    ku, kphi = jax.random.split(k_dir)
    rows += [_np(jax.random.uniform(ku, (N,), dtype=jnp.float32)),
             _np(jax.random.uniform(kphi, (N,), dtype=jnp.float32)),
             _np(jax.random.normal(k_wave, (N,), dtype=jnp.float32))]
    ref = _tree(jp.generate(sp, jp.params["filters"], key))
    rays = tp.source.generate(params["sources"]["plasma"], ExplicitDraws(rows),
                              params["filters"])
    mask = rays.mask.numpy()
    np.testing.assert_array_equal(mask, ref.mask)
    np.testing.assert_allclose(rays.origin.numpy()[mask], ref.origin[mask], rtol=0, atol=1e-7)
    np.testing.assert_allclose(rays.direction.numpy()[mask], ref.direction[mask], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(rays.wavelength.numpy()[mask], ref.wavelength[mask], rtol=0,
                               atol=5e-7)


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_sightline_survivors_on_both_engines(engine):
    """The filter's survivor fraction is its geometry's on the eager engine
    and on the fused twin (K1b's in-kernel test), within 5 binomial sigma."""
    n = 1 << 14
    res = raytrace(_filtered_source(n, engine=engine), device="cpu")
    kept = res["total"]["meta"]["source"]["num_out"]
    expect = math.pi * 0.02**2 / 0.06**2
    assert abs(kept / n - expect) < 5 * math.sqrt(expect * (1 - expect) / n), kept
    det = res["total"]["meta"]["detector"]["num_out"]
    assert res["total"]["image"]["detector"].sum() == det


@pytest.fixture(scope="module")
def eager_filtered_plasma():
    cfg = _filtered_plasma()
    cfg["general"].update(engine="xla", keep_history=False)
    return raytrace(cfg, device="cpu")


@pytest.mark.parametrize("engine", ["fused", "auto"])
def test_filtered_plasma_on_the_fused_engine(engine, eager_filtered_plasma):
    """The sightline cuts a plasma's bundles in the per-iteration tables of
    the fused engine (K1f's twin here) as on the eager engine: both draw the
    tables first from the same seed, so one iteration's counts agree
    exactly, and the cut keeps under half of the 5 photons per bundle."""
    cfg = _filtered_plasma()
    cfg["general"].update(engine=engine, keep_history=False)
    res = raytrace(cfg, device="cpu")
    ref = eager_filtered_plasma["total"]["meta"]
    meta = res["total"]["meta"]
    n_bundles = TorchPipeline(cfg, device="cpu").source.bundle_count
    assert 0 < int(meta["plasma"]["num_out"]) < 0.5 * 5 * n_bundles
    for name in ("plasma", "detector"):
        assert int(meta[name]["num_out"]) == int(ref[name]["num_out"]), name
    assert res["total"]["image"]["detector"].sum() == int(meta["detector"]["num_out"])
