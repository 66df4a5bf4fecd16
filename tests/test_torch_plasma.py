"""Plasma sources of the port against the JAX package.

- Budgets: ``num_rays`` equals JAX's exactly (the same numpy dry run).
- Bundle tables: given JAX's own uniforms and Poisson counts through
  ``ExplicitDraws``, ``cum`` is equal and the table matches to float32
  rounding (XLA may fuse the frame's multiply-adds).
- Rays: given the same uniforms and normals, ``generate`` matches JAX's per
  ray (origins 1e-7 m, directions 1e-5, wavelengths one float32 ulp, 5e-7 A,
  leaving out the rays of a bundle whose temperature flipped).
- Autograd: d(sum of the detector image)/d(temperature) equals ``jax.grad``
  at float64 on the same draws (rtol 1e-6).
- Real units on the port's eager engine, as ``tests/test_plasma.py``:
  expected count within 5 sigma, Doppler width at rtol 0.1, spread_radius
  spot, the ``max_rays`` guard, point bundles, the toroidal mask, the
  datafile and cylindrical profiles.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops import voigt as jvoigt
from xicsrt_tpu_torch import params_from_jax, raytrace
from xicsrt_tpu_torch.draws import ExplicitDraws, poisson_counts
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.ops import voigt as tvoigt


def _plasma_config(**plasma_overrides):
    """``tests/test_plasma.py``'s fixture."""
    plasma = {
        "class_name": "XicsrtPlasmaCubic",
        "origin": [0.0, 0.0, 0.0], "zaxis": [0.0, 0.0, 1.0],
        "xsize": 0.1, "ysize": 0.1, "zsize": 0.1,
        "target": [0.0, 0.0, 1.0], "spread": np.pi / 3,
        "emissivity": 2e10, "temperature": 100.0, "wavelength": 3.9492,
        "time_resolution": 1e-3, "bundle_volume": 1e-6, "bundle_count": 1000,
        "use_poisson": True,
    }
    plasma.update(plasma_overrides)
    return {
        "general": {"number_of_iter": 1, "random_seed": 0, "print_results": False},
        "sources": {"plasma": plasma},
        "optics": {"detector": {
            "class_name": "XicsrtOpticDetector", "origin": [0.0, 0.0, 1.0],
            "zaxis": [0.0, 0.0, -1.0], "xsize": 4.0, "ysize": 4.0, "pixel_size": 0.04}},
    }


def _example03():
    """``examples/example_03_plasma_spectrometer.py``'s config."""
    return {
        "general": {"number_of_iter": 4, "random_seed": 0, "print_results": False},
        "sources": {"plasma": {
            "class_name": "XicsrtPlasmaCubic", "origin": [0.0, 0.0, 0.0],
            "xsize": 0.02, "ysize": 0.02, "zsize": 0.02,
            "target": [0.0, 0.0, 0.80374151], "spread": np.radians(10.0),
            "emissivity": 1e16, "temperature": 1000.0, "mass_number": 40.0,
            "wavelength": 3.9492, "time_resolution": 1e-3, "bundle_volume": 1e-6,
            "bundle_count": 4000, "use_poisson": True, "max_rays": int(5e6)}},
        "optics": {
            "crystal": {
                "class_name": "XicsrtOpticToroidalCrystal",
                "origin": [0.0, 0.0, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151], "xsize": 0.2, "ysize": 0.2,
                "radius_major": 1.0, "radius_minor": 0.64, "crystal_spacing": 2.45676,
                "rocking_type": "gaussian", "rocking_fwhm": 100e-6},
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084], "xsize": 0.4, "ysize": 0.2},
        },
    }


def _toroidal(**extra):
    cfg = _plasma_config()
    cfg["sources"]["plasma"].update(class_name="XicsrtPlasmaToroidal", major_radius=1.0,
                                    minor_radius=0.02, torus_origin=[-1.0, 0.0, 0.0],
                                    **extra)
    return cfg


def _datafile(tmp_path):
    rho = np.linspace(0, 1, 50)
    prof, tfile = tmp_path / "emiss.txt", tmp_path / "temp.txt"
    np.savetxt(prof, np.stack([rho, 1e10 * (1 - rho**2)], axis=-1))
    np.savetxt(tfile, np.stack([rho, 100.0 * (1 - 0.5 * rho)], axis=-1))
    cfg = _plasma_config()
    cfg["sources"]["plasma"].update(
        class_name="XicsrtPlasmaToroidalDatafile", major_radius=1.0, minor_radius=0.05,
        torus_origin=[-1.0, 0.0, 0.0], emissivity_file=str(prof),
        temperature_file=str(tfile))
    return cfg


def _variants(tmp_path):
    cyl = _plasma_config()
    cyl["sources"]["plasma"]["class_name"] = "XicsrtPlasmaCylindrical"
    generic = _plasma_config(spread=None, spread_radius=0.05, velocity=[1e4, 0.0, 2e4],
                             emissivity=2e12,
                             linewidth=1e14)
    generic["sources"]["plasma"]["class_name"] = "XicsrtPlasmaGeneric"
    return {
        "example03": _example03(),
        "fixture": _plasma_config(),
        "generic": generic,
        "point": _plasma_config(bundle_type="point"),
        "cylindrical": cyl,
        "toroidal": _toroidal(),
        "datafile": _datafile(tmp_path),
    }


VARIANTS = ["example03", "fixture", "generic", "point", "cylindrical", "toroidal",
            "datafile"]


@pytest.mark.parametrize("name", VARIANTS)
def test_budget_equals_jax(name, tmp_path):
    cfg = _variants(tmp_path)[name]
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    assert tp.num_rays == jp.num_rays
    assert tp.source.bundle_count == jp.source.bundle_count
    assert tp.source.voxel_size == jp.source.voxel_size


def _jax_draws(jp, key, dtype):
    """The uniforms, normals and Poisson counts one JAX iteration draws
    (``plasma.py:325-396``; ``engine.py:128``), as port rows in its draw
    order, plus JAX's own (cum, table) and rays."""
    src = jp.source
    N, B = src.num_rays, src.bundle_count
    k_source, _ = jax.random.split(key)
    (k_bundle, k_prof, k_counts, k_voxel, k_dir, k_wave,
     k_cauchy) = jax.random.split(k_source, 7)
    sp = jp.params["sources"][src.name]
    cum, table, _ = jax.jit(src.make_bundle_tables())(
        sp, jp.params["filters"], k_bundle, k_prof, k_counts)
    cum = np.asarray(cum)
    counts = np.diff(np.concatenate([[0], cum]))
    ku, kphi = jax.random.split(k_dir)
    rows = [np.asarray(jax.random.uniform(k_bundle, (B, 3), dtype=dtype)).reshape(-1)]
    if src.voxel_size > 0.0:
        rows.append(np.asarray(jax.random.uniform(k_voxel, (N, 3), dtype=dtype)).reshape(-1))
    rows += [np.asarray(jax.random.uniform(ku, (N,), dtype=dtype)),
             np.asarray(jax.random.uniform(kphi, (N,), dtype=dtype)),
             np.asarray(jax.random.normal(k_wave, (N,), dtype=dtype))]
    if src.gamma > 0.0:
        rows.append(np.asarray(jax.random.uniform(k_cauchy, (N,), dtype=dtype)))
    rays = jax.tree_util.tree_map(
        np.asarray, jp.generate(sp, jp.params["filters"], k_source))
    return rows, counts, cum, np.asarray(table), rays


@pytest.mark.parametrize("name", VARIANTS)
def test_bundle_tables_and_rays_match_jax(name, tmp_path):
    cfg = _variants(tmp_path)[name]
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    rows, counts, cum, table, ref = _jax_draws(jp, jax.random.key(7), jnp.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp.params), device="cpu")
    sp = params["sources"]["plasma"]

    cum_t, table_t, total = tp.source.bundle_tables(sp, ExplicitDraws(rows[:1], [counts]))
    np.testing.assert_array_equal(cum_t.numpy(), cum)
    assert int(total) == int(cum[-1])
    np.testing.assert_allclose(table_t[:, :3].numpy(), table[:, :3], rtol=0, atol=1e-7)
    # Temperature: profiles at rho near 1 may fall on the other side in
    # float32 against JAX's float64 rho (jax_enable_x64 in the test suite).
    flips = np.abs(table_t[:, 4].numpy() - table[:, 4]) > 1e-4 * np.abs(table[:, 4]) + 1e-9
    assert flips.sum() <= 1, flips.sum()
    np.testing.assert_allclose(table_t[:, 3].numpy(), table[:, 3], rtol=1e-6)
    np.testing.assert_array_equal(table_t[:, 5:].numpy(), table[:, 5:])

    rays = tp.source.generate(sp, ExplicitDraws(rows, [counts]))
    mask = rays.mask.numpy()
    np.testing.assert_array_equal(mask, ref.mask)
    assert mask.sum() == min(int(cum[-1]), tp.num_rays) > 100
    np.testing.assert_allclose(rays.origin.numpy()[mask], ref.origin[mask], rtol=0, atol=1e-7)
    # Directions to 1e-5, as tests/test_torch_ops.py holds the isotropic
    # cone: near the axis sqrt(1 - z^2) turns one ulp of z (or of the
    # bundle's cos(spread)) into ~1e-6 and more of x and y.
    np.testing.assert_allclose(rays.direction.numpy()[mask], ref.direction[mask],
                               rtol=0, atol=1e-5)
    # A flipped bundle's rays take another Doppler width: leave them out.
    bundle = np.minimum(np.searchsorted(cum, np.arange(tp.num_rays), side="right"),
                        len(cum) - 1)
    same = mask & ~flips[bundle]
    np.testing.assert_allclose(rays.wavelength.numpy()[same], ref.wavelength[same],
                               rtol=0, atol=5e-7)


def test_params_from_jax_carries_plasma_and_torus_params():
    cfg = _example03()
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp.params), device="cpu")
    for section in ("sources", "optics"):
        for name, own in tp.params[section].items():
            theirs = params[section][name]
            assert set(own) <= set(theirs), (name, set(own) - set(theirs))
            for key, value in own.items():
                if key == "frame":
                    assert torch.equal(value.basis, theirs[key].basis)
                    assert torch.equal(value.origin, theirs[key].origin)
                else:
                    assert torch.equal(value, theirs[key]), (name, key)
    for key in ("target", "emissivity", "temperature", "time_resolution", "velocity"):
        assert key in params["sources"]["plasma"]
    for key in ("radius_major", "radius_minor", "crystal_spacing"):
        assert key in params["optics"]["crystal"]


def test_temperature_gradient_matches_jax_grad():
    """Autograd reaches the plasma temperature (the Doppler width) as
    jax.grad does: weight mode, bilinear images, float64."""
    cfg = _example03()
    cfg["general"].update(dtype="float64", interact_mode="weight",
                          image_mode="bilinear", keep_history=False, number_of_iter=1)
    cfg["sources"]["plasma"].update(emissivity=2e14)
    cfg["optics"]["crystal"]["rocking_fwhm"] = 2e-3
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    key = jax.random.key(3)
    rows, counts, _, _, _ = _jax_draws(jp, key, jnp.float64)
    it = jp.make_iteration(keep_history=False, keep_images=True)

    def loss(temp):
        params = copy.copy(jp.params)
        params["sources"] = {"plasma": dict(jp.params["sources"]["plasma"],
                                            temperature=temp)}
        return jnp.sum(it(params, key)["image"]["detector"])

    t0 = jp.params["sources"]["plasma"]["temperature"]
    ref_val, ref_grad = jax.value_and_grad(loss)(t0)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp.params), device="cpu")
    temp = params["sources"]["plasma"]["temperature"].clone().requires_grad_(True)
    params["sources"]["plasma"]["temperature"] = temp
    out = tp.make_iteration(False, True)(params, ExplicitDraws(rows, [counts]))
    value = out["image"]["detector"].sum()
    value.backward()
    assert float(ref_val) > 50
    np.testing.assert_allclose(value.item(), float(ref_val), rtol=1e-9)
    assert float(ref_grad) != 0.0
    np.testing.assert_allclose(float(temp.grad), float(ref_grad), rtol=1e-6)


# --- real units on the eager engine (tests/test_plasma.py) --------------

def _run(cfg):
    return raytrace(cfg, device="cpu")


def test_expected_ray_count_and_big_detector():
    results = _run(_plasma_config())
    meta = results["total"]["meta"]
    n_gen = meta["plasma"]["num_out"]
    expected = 2e10 * 1e-3 * 0.1**3 * np.sin((np.pi / 3) / 2) ** 2
    assert expected > 1000
    assert abs(n_gen - expected) < 5 * np.sqrt(expected)
    assert meta["detector"]["num_out"] == n_gen


def test_poisson_count_varies_with_seed():
    counts = set()
    for seed in range(3):
        cfg = _plasma_config()
        cfg["general"]["random_seed"] = seed
        counts.add(_run(cfg)["total"]["meta"]["plasma"]["num_out"])
    assert len(counts) > 1


def test_doppler_broadening_scales_with_temperature():
    w_cold = _run(_plasma_config(temperature=10.0))["found"]["history"]["plasma"]["wavelength"]
    w_hot = _run(_plasma_config(temperature=1000.0))["found"]["history"]["plasma"]["wavelength"]
    assert w_hot.std() > 5 * w_cold.std()
    expected = 3.9492 * np.sqrt(1000.0 * 1.602176634e-19
                                / (1.66053906892e-27 * 299792458.0**2))
    np.testing.assert_allclose(w_hot.std(), expected, rtol=0.1)


def test_spread_radius_spot_size():
    hits = _run(_plasma_config(spread=None, spread_radius=0.05))[
        "found"]["history"]["detector"]["origin"]
    r = np.sqrt(hits[:, 0] ** 2 + hits[:, 1] ** 2)
    assert np.percentile(r, 99) < 0.05 + 0.1 * np.sqrt(3) / 2 + 0.02


def test_max_rays_guard():
    with pytest.raises(ValueError, match="max_rays|too many"):
        _run(_plasma_config(emissivity=1e15, max_rays=int(1e6)))


def test_point_bundles_and_profiles(tmp_path):
    assert _run(_plasma_config(bundle_type="point"))["total"]["meta"]["plasma"]["num_out"] > 0
    src = _run(_toroidal())["found"]["history"]["plasma"]["origin"]
    r_cyl = np.sqrt((src[:, 0] + 1.0) ** 2 + src[:, 1] ** 2)
    assert len(src) and np.all(np.sqrt((r_cyl - 1.0) ** 2 + src[:, 2] ** 2) < 0.04)
    assert _run(_datafile(tmp_path))["total"]["meta"]["plasma"]["num_out"] > 0
    assert _run(_variants(tmp_path)["cylindrical"])["total"]["meta"]["plasma"]["num_out"] > 0


def test_flux_coordinates_round_trip():
    tp = TorchPipeline(_toroidal(), device="cpu")
    flx = np.array([[0.25, 0.3, 1.0], [0.81, -2.0, -0.5]])
    np.testing.assert_allclose(tp.source.flx_from_car(tp.source.car_from_flx(flx)), flx,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tp.source.rho_from_car(tp.source.car_from_flx(flx)),
                               np.sqrt(flx[:, 0]), rtol=1e-12)


def test_voigt_helpers_match_jax():
    """The line-shape helpers equal JAX's (float64, rtol 1e-15)."""
    x = np.linspace(3.9, 4.0, 201)
    np.testing.assert_allclose(tvoigt.voigt_profile(x, 2.0, 3.95, 1e-3, 4e-4),
                               jvoigt.voigt_profile(x, 2.0, 3.95, 1e-3, 4e-4), rtol=1e-15)
    for args in ((1000.0, 40.0, 3.9492), (0.0, 40.0, 3.9492), (-5.0, 1.0, 1.0)):
        assert tvoigt.doppler_sigma(*args) == pytest.approx(jvoigt.doppler_sigma(*args),
                                                            rel=1e-15, abs=0.0)
    assert tvoigt.natural_gamma(3e14, 3.9492) == pytest.approx(
        jvoigt.natural_gamma(3e14, 3.9492), rel=1e-15)


def test_poisson_counts_are_poisson():
    """Bundle counts, drawn by parts at rates of 64 and more: over R draws
    each rate's mean is within 5 standard errors of the rate, its variance
    within 5 sqrt(2/R) of it, relative, and its third central moment (the
    rate, for a Poisson count) within 5 standard errors, sqrt((6 rate^3 +
    18 rate^2 + rate) / R), of it. Rates below 64 are torch.poisson's
    draws, number for number."""
    rates = [0.0, 3.0, 63.5, 64.0, 152.0, 1000.0, 3999.0, 4000.0, 5000.0, 16777.0]
    R = 20000
    lam = torch.tensor(rates, dtype=torch.float32).repeat_interleave(R)
    counts = poisson_counts(lam, torch.Generator().manual_seed(1)).reshape(len(rates), R)
    assert counts.dtype == torch.int64
    for rate, row in zip(rates, counts.double()):
        if rate == 0.0:
            assert not row.any()
            continue
        assert abs(row.mean().item() - rate) < 5 * np.sqrt(rate / R), rate
        assert abs(row.var().item() / rate - 1.0) < 5 * np.sqrt(2.0 / R), rate
        m3 = ((row - row.mean()) ** 3).mean().item()
        assert abs(m3 - rate) < 5 * np.sqrt((6 * rate**3 + 18 * rate**2 + rate) / R), rate
    below = torch.tensor([0.0, 3.0, 40.0, 63.5]).repeat(100)
    np.testing.assert_array_equal(
        poisson_counts(below, torch.Generator().manual_seed(2)).numpy(),
        torch.poisson(below, generator=torch.Generator().manual_seed(2)).numpy())


def test_filters_and_other_angular_dists_raise():
    """A filter name the filters section does not define raises KeyError,
    as in JAX (engine.py:70-72); plasmas emit only isotropic cones."""
    cfg = _plasma_config(filters=["sight"])
    with pytest.raises(KeyError, match="sight"):
        TorchPipeline(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        TorchPipeline(_plasma_config(angular_dist="flat"), device="cpu")
