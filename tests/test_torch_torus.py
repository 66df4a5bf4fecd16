"""The torus of the eager engine against the JAX package.

- ``ops/polynomials.solve_quartic`` against JAX's on seeded coefficients
  (float64; the same Ferrari steps and Newton polish, ``torch.arccos``
  against ``jnp.arccos``): equal NaN patterns, roots to rtol 1e-9.
- ``ShapeTorus.intersect`` against JAX's for the four ``convex`` pairs on
  the same float32 rays: hit masks equal except at stated tangency rays,
  distances and normals to float32 rounding where both hit.
- The torus golden of the CPU reference on the port's eager engine, with
  the statistics of ``tests/test_reference_parity_families.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops import polynomials as jpoly
from xicsrt_tpu.rays import Rays as JaxRays
from xicsrt_tpu_torch import params_from_jax
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.engine import raytrace
from xicsrt_tpu_torch.ops import polynomials as tpoly
from xicsrt_tpu_torch.rays import Rays

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torus_reference_image.npz")


def _quartics(n, seed):
    """Half with four real roots spread over [-2, 2], half random."""
    rng = np.random.default_rng(seed)
    roots = rng.uniform(-2.0, 2.0, (n // 2, 4))
    coef_real = np.stack([np.ones(n // 2), -roots.sum(1),
                          (roots[:, :, None] * roots[:, None, :]).sum((1, 2)) / 2
                          - (roots**2).sum(1) / 2,
                          -(roots[:, [0, 0, 0, 1]] * roots[:, [1, 1, 2, 2]]
                            * roots[:, [2, 3, 3, 3]]).sum(1),
                          roots.prod(1)], axis=1)
    coef_rand = rng.normal(size=(n - n // 2, 5))
    coef_rand[:, 0] = rng.uniform(0.5, 2.0, n - n // 2)
    return np.concatenate([coef_real, coef_rand]), roots


def test_solve_quartic_matches_jax():
    coef, roots = _quartics(4000, seed=1)
    ours = tpoly.solve_quartic(*torch.from_numpy(coef).T).numpy()
    ref = np.asarray(jpoly.solve_quartic(*jnp.asarray(coef).T))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(ours[ok], ref[ok], rtol=1e-9, atol=1e-12)
    # The four-real-root half: every root found, ascending.
    np.testing.assert_allclose(ours[:2000], np.sort(roots, axis=1), rtol=1e-7, atol=1e-7)


def _torus_config(convex):
    return {
        "general": {"number_of_iter": 1, "random_seed": 0, "print_results": False},
        "sources": {"source": {"class_name": "XicsrtSourceDirected", "intensity": 16,
                               "wavelength": 3.9492}},
        "optics": {"crystal": {
            "class_name": "XicsrtOpticToroidalMirror",
            "origin": [0.0, 0.0, 0.5], "zaxis": [0.0, 0.0, -1.0],
            "xsize": 0.15, "ysize": 0.15,
            "radius_major": 1.0, "radius_minor": 0.5, "convex": convex}},
    }


def _cone(n, seed, half_angle):
    rng = np.random.default_rng(seed)
    t = np.tan(half_angle) * (2 * rng.random((n, 2)) - 1)
    d = np.concatenate([t, np.ones((n, 1))], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.zeros((n, 3), np.float32), d.astype(np.float32)


@pytest.mark.parametrize("convex", [[False, False], [False, True], [True, False],
                                    [True, True]])
def test_torus_intersect_matches_jax(convex):
    """Masks may differ only for rays grazing the tube (|t * d_y| near the
    patch edge of the quartic's root choice): none on this cone. Distances
    to 2e-6 m and normals to 2e-6: the float32 quartic's conditioning after
    the closest-approach shift."""
    cfg = _torus_config(convex)
    jp = JaxPipeline(cfg)
    tp = TorchPipeline(cfg, device="cpu")
    origin, direction = _cone(20000, seed=2, half_angle=np.radians(12.0))
    n = len(origin)
    jr = JaxRays(origin=jnp.asarray(origin), direction=jnp.asarray(direction),
                 wavelength=jnp.full((n,), 3.9492, jnp.float32),
                 weight=jnp.ones((n,), jnp.float32), mask=jnp.ones((n,), bool))
    t_j, n_j, m_j = jax.tree_util.tree_map(
        np.asarray, jp.optics[0].make_intersect()(jp.params["optics"]["crystal"], jr))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp.params), device="cpu")
    tr = Rays(origin=torch.from_numpy(origin), direction=torch.from_numpy(direction),
              wavelength=torch.full((n,), 3.9492), weight=torch.ones(n),
              mask=torch.ones(n, dtype=torch.bool))
    t_t, n_t, m_t = (x.numpy() for x in tp.optics[0].intersect(params["optics"]["crystal"], tr))
    assert m_j.sum() > 0.5 * n
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_allclose(t_t[m_j], t_j[m_j], rtol=0, atol=2e-6)
    np.testing.assert_allclose(n_t[m_j], n_j[m_j], rtol=0, atol=2e-6)


def _golden_config(engine):
    return {
        "general": {"number_of_iter": 5, "random_seed": 11, "print_results": False,
                    "keep_history": False, "engine": engine},
        "sources": {"source": {"class_name": "XicsrtSourceDirected", "intensity": 1e5,
                               "wavelength": 3.9492, "spread": np.radians(10.0)}},
        "optics": {
            "crystal": {"class_name": "XicsrtOpticToroidalCrystal",
                        "origin": [0.0, 0.0, 0.80374151],
                        "zaxis": [0.0, 0.59497864, -0.80374151],
                        "xsize": 0.2, "ysize": 0.2, "radius_major": 1.0,
                        "radius_minor": 0.2, "crystal_spacing": 2.45676,
                        "rocking_type": "gaussian", "rocking_fwhm": 1e-3},
            "detector": {"class_name": "XicsrtOpticDetector",
                         "origin": [0.0, 0.76871290, 0.56904832],
                         "zaxis": [0.0, -0.95641806, 0.29200084],
                         "xsize": 0.4, "ysize": 0.2, "pixel_size": 0.004},
        },
    }


def assert_matches_torus_golden(result):
    """The four checks of test_reference_parity_families.py:123-187: crystal
    acceptance and efficiency within 5 sigma of the golden's, superpixel
    chi2/ndof < 3, line centroid within 0.75 px and an unresolved width."""
    golden = dict(np.load(GOLDEN))
    meta = {k: v["num_out"] for k, v in result["total"]["meta"].items()}
    n_gen, n_ref = meta["source"], float(golden["n_generated"])
    for elem in ("crystal", "detector"):
        k, k_ref = meta[elem], float(golden[f"meta_{elem}"])
        p = (k + k_ref) / (n_gen + n_ref)
        assert abs(k / n_gen - k_ref / n_ref) < 5 * np.sqrt(p / n_gen + p / n_ref), elem
    ref = golden["image"].astype(np.float64)
    img = result["total"]["image"]["detector"].astype(np.float64)
    R = ref.reshape(10, 10, 5, 10).sum(axis=(1, 3))
    O = img.reshape(10, 10, 5, 10).sum(axis=(1, 3))
    scale = R.sum() / O.sum()
    O = O * scale
    keep = (R + O) > 50
    assert keep.sum() > 0
    assert ((O[keep] - R[keep]) ** 2 / (R[keep] + scale * O[keep])).sum() / keep.sum() < 3.0
    ys = np.arange(ref.shape[1])

    def moments(prof):
        prof = prof / prof.sum()
        mu = (prof * ys).sum()
        return mu, np.sqrt((prof * (ys - mu) ** 2).sum())

    (mu_r, sd_r), (mu_o, sd_o) = moments(ref.sum(0)), moments(img.sum(0))
    assert abs(mu_o - mu_r) < 0.75
    assert sd_r < 1.0 and sd_o < 1.0  # the line is unresolved at 4 mm pixels


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_torus_golden(engine):
    """The eager engine's quartic and the fused twin's Newton root."""
    assert_matches_torus_golden(raytrace(_golden_config(engine), device="cpu"))
