"""Parity of the port's L0 ops with the JAX package.

The same numpy-seeded float32 inputs go through ``xicsrt_tpu.ops`` and
``xicsrt_tpu_torch.ops``. JAX runs with x64 enabled in this suite, so every
JAX input is explicitly float32. Tolerance: 1e-6 absolute on unit-scale
float32 values (a few ulp), masks exactly equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xicsrt_tpu.ops import aperture as jap
from xicsrt_tpu.ops import physics as jphys
from xicsrt_tpu.ops import spread as jspread
from xicsrt_tpu.ops import vector as jvec
from xicsrt_tpu_torch.ops import aperture as tap
from xicsrt_tpu_torch.ops import physics as tphys
from xicsrt_tpu_torch.ops import spread as tspread
from xicsrt_tpu_torch.ops import vector as tvec

ATOL = 1e-6


def _f32(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def _close(a_jax, b_torch, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b_torch), np.asarray(a_jax), rtol=0,
                               atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(20261016)


def _unit(rng, n):
    v = _f32(rng, n, 3)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


VECTOR_CASES = {
    "dot": lambda m, a, b, u: m.dot(a, b),
    "magnitude": lambda m, a, b, u: m.magnitude(a),
    "normalize": lambda m, a, b, u: m.normalize(a),
    "safe_normalize": lambda m, a, b, u: m.safe_normalize(a),
    "reflect": lambda m, a, b, u: m.reflect(a, u),
    "vector_rotate": lambda m, a, b, u: m.vector_rotate(a, u, 0.3),
    "orthogonal_basis": lambda m, a, b, u: m.orthogonal_basis(u, b[0], b[1]),
    "cylindrical_from_cartesian": lambda m, a, b, u: m.cylindrical_from_cartesian(a),
    "cartesian_from_cylindrical": lambda m, a, b, u: m.cartesian_from_cylindrical(a),
    "toroidal_from_cartesian": lambda m, a, b, u: m.toroidal_from_cartesian(a, 0.5),
    "cartesian_from_toroidal": lambda m, a, b, u: m.cartesian_from_toroidal(a, 0.5),
}


@pytest.mark.parametrize("name", sorted(VECTOR_CASES))
def test_vector_ops(rng, name):
    a, b, u = _f32(rng, 257, 3), _f32(rng, 257, 3), _unit(rng, 257)
    fn = VECTOR_CASES[name]
    ref = fn(jvec, jnp.asarray(a), jnp.asarray(b), jnp.asarray(u))
    out = fn(tvec, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(u))
    assert out.dtype == torch.float32
    _close(ref, out)


def test_rotation_matrix_and_rotate_to_frame(rng):
    axis = np.array([0.3, -0.2, 0.9], np.float32)
    ref = jvec.rotation_matrix(jnp.asarray(axis), jnp.float32(0.7))
    out = tvec.rotation_matrix(torch.from_numpy(axis), 0.7)
    _close(ref, out)  # unit-scale entries, atol 1e-6

    d, u = _unit(rng, 64), _unit(rng, 64)
    jb = jvec.orthogonal_basis(jnp.asarray(u), jnp.asarray(d[0]), jnp.asarray(d[1]))
    tb = tvec.orthogonal_basis(torch.from_numpy(u), torch.from_numpy(d[0]),
                               torch.from_numpy(d[1]))
    ref = jvec.rotate_to_frame(jnp.asarray(d), jb)
    out = tvec.rotate_to_frame(torch.from_numpy(d), tb)
    _close(ref, out)


def test_point_in_triangle_and_spiral(rng):
    p = _f32(rng, 500, 2)
    tri = [np.array(v, np.float32) for v in ([-0.5, -0.4], [0.6, -0.3], [0.0, 0.7])]
    ref = jvec.point_in_triangle_2d(jnp.asarray(p), *map(jnp.asarray, tri))
    out = tvec.point_in_triangle_2d(torch.from_numpy(p), *map(torch.from_numpy, tri))
    assert np.array_equal(np.asarray(ref), out.numpy())

    phi = _f32(rng, 100, lo=0.0, hi=0.5)
    ref = jvec.sinusoidal_spiral(jnp.asarray(phi), 0.5, 1.2, 0.9)
    out = tvec.sinusoidal_spiral(torch.from_numpy(phi), 0.5, 1.2,
                                 torch.tensor(0.9, dtype=torch.float32))
    _close(ref, out, atol=1e-5)  # radius ~1.2 m, a few float32 ulp


def test_physics():
    wl = np.array([1.0, 3.9492, 7.0], np.float32)
    ref = jphys.bragg_angle(jnp.asarray(wl), jnp.float32(2.45676))
    out = tphys.bragg_angle(torch.from_numpy(wl), 2.45676)
    _close(ref, out)
    assert tphys.energy_from_wavelength(3.9492) == jphys.energy_from_wavelength(3.9492)
    assert tphys.wavelength_from_energy(3139.5) == jphys.wavelength_from_energy(3139.5)


APERTURES = {
    "none": {"shape": "none"},
    "circle": {"shape": "circle", "size": [0.3], "origin": [0.05, -0.02]},
    "square": {"shape": "square", "size": [0.5]},
    "rectangle": {"shape": "rectangle", "size": [0.6, 0.3], "origin": [-0.1, 0.0]},
    "ellipse": {"shape": "ellipse", "size": [0.4, 0.2]},
    "triangle": {"shape": "triangle",
                 "vertices": [[-0.3, -0.2], [0.4, -0.3], [0.0, 0.35]]},
}


@pytest.mark.parametrize("logic", ["and", "not", "or", "nand", "nor", "xor", "xnor"])
@pytest.mark.parametrize("shape", sorted(APERTURES))
def test_aperture_logic(rng, shape, logic):
    """Every shape x logic op, after a circle that shapes the running mask,
    on a mask with dead rays: masks exactly equal."""
    x = _f32(rng, 2000, 3, lo=-0.5, hi=0.5)
    mask = rng.uniform(size=2000) < 0.8
    spec_cfg = [{"shape": "circle", "size": [0.35]}, dict(APERTURES[shape], logic=logic)]
    ref = jap.aperture_mask(jnp.asarray(x), jnp.asarray(mask),
                            jap.normalize_aperture_spec(spec_cfg))
    out = tap.aperture_mask(torch.from_numpy(x), torch.from_numpy(mask),
                            tap.normalize_aperture_spec(spec_cfg))
    assert np.array_equal(np.asarray(ref), out.numpy())


def test_aperture_spec_errors():
    with pytest.raises(ValueError):
        tap.normalize_aperture_spec({"shape": "hexagon"})
    with pytest.raises(ValueError):
        tap.normalize_aperture_spec({"shape": "circle", "logic": "maybe"})


def _jax_uniform_pair(key, n):
    """The two uniform rows the JAX samplers draw (spread.py:58-62, 103-105)."""
    k1, k2 = jax.random.split(key)
    return (jax.random.uniform(k1, (n,), dtype=jnp.float32),
            jax.random.uniform(k2, (n,), dtype=jnp.float32))


@pytest.mark.parametrize("spread_deg", [1.0, 10.0, 60.0])
def test_isotropic(spread_deg):
    key, n = jax.random.key(3), 4096
    spread = math.radians(spread_deg)
    ref = jspread.sample_isotropic(key, n, spread, dtype=jnp.float32)
    u, v = _jax_uniform_pair(key, n)
    out = tspread.sample_isotropic(torch.tensor(np.asarray(u)),
                                   torch.tensor(np.asarray(v)), spread)
    _close(np.asarray(ref)[:, 2], out[:, 2])
    # x, y: rho = sqrt(1 - z^2) turns one ulp of z (XLA may fuse u*span+lo
    # into an FMA) into ~1e-6 near the cone axis; 1e-5 bounds that.
    _close(np.asarray(ref)[:, :2], out[:, :2], atol=1e-5)


@pytest.mark.parametrize("spread", [
    math.radians(10.0),                       # symmetric, 1 value
    [math.radians(4.0), math.radians(9.0)],   # symmetric, 2 values
    [-0.05, 0.12, -0.03, 0.08],               # asymmetric: Newton inverse
    [-0.2, -0.05, 0.01, 0.15],                # asymmetric, off-axis window
])
def test_isotropic_xy(spread):
    key, n = jax.random.key(11), 4096
    ref = jspread.sample_isotropic_xy(key, n, spread, dtype=jnp.float32)
    u, v = _jax_uniform_pair(key, n)
    out = tspread.sample_isotropic_xy(torch.tensor(np.asarray(u)),
                                      torch.tensor(np.asarray(v)), spread)
    _close(ref, out)
    assert tspread.solid_angle(spread, "isotropic_xy") == pytest.approx(
        jspread.solid_angle(spread, "isotropic_xy"), rel=1e-15)


def test_samplers_not_ported_raise():
    """Every JAX distribution name dispatches (the gaussian cone takes two
    normals); an unknown name raises."""
    u = torch.rand(4)
    for name, sampler in (("flat", tspread.sample_flat),
                          ("flat_xy", tspread.sample_flat_xy),
                          ("gaussian", tspread.sample_flat_gaussian),
                          ("flat_gaussian", tspread.sample_flat_gaussian)):
        assert torch.equal(tspread.sample_direction(u, u, 0.1, name), sampler(u, u, 0.1))
    with pytest.raises(ValueError):
        tspread.sample_direction(u, u, 0.1, "nonsense")
    assert tspread.solid_angle(0.2, "isotropic") == jspread.solid_angle(0.2, "isotropic")
