"""The cylinder on both engines against the JAX package.

- ``ShapeCylinder.intersect`` (eager) against JAX's on the same float32
  rays, concave and convex: equal hit masks, distances and normals to
  2e-6 (the two evaluate the same float32 quadratic; XLA may fuse
  multiply-adds).
- The fused twin (K1's cylinder stage) against the JAX megakernel run by
  its interpreter on the same uniforms, with ``tests/test_torch_fused.py``'s
  bound: at most 3 rays apart per element, each image by at most 2 per such
  ray (L1).
- Both engines of the port on one cylindrical-crystal config: detection
  efficiencies within 5 binomial sigma.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_fused_grad import _variant_config
from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops.fused_trace import build_fused_run as jax_build_fused_run
from xicsrt_tpu.rays import Rays as JaxRays
from xicsrt_tpu_torch import params_from_jax
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.engine import raytrace
from xicsrt_tpu_torch.ops import fused_trace as ft
from xicsrt_tpu_torch.rays import Rays

TOL_RAYS = 3


def _mirror_config(convex):
    return {
        "general": {"number_of_iter": 1, "random_seed": 0, "print_results": False},
        "sources": {"source": {"class_name": "XicsrtSourceDirected", "intensity": 16,
                               "wavelength": 3.9492}},
        "optics": {"mirror": {
            "class_name": "XicsrtOpticCylindricalMirror",
            "origin": [0.0, 0.0, 0.5], "zaxis": [0.0, 0.0, -1.0],
            "xaxis": [np.sqrt(0.5), np.sqrt(0.5), 0.0],
            "xsize": 0.2, "ysize": 0.2, "radius": 0.8, "convex": convex}},
    }


def _cone(n, seed, half_angle):
    rng = np.random.default_rng(seed)
    t = np.tan(half_angle) * (2 * rng.random((n, 2)) - 1)
    d = np.concatenate([t, np.ones((n, 1))], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.zeros((n, 3), np.float32), d.astype(np.float32)


@pytest.mark.parametrize("convex", [False, True])
def test_cylinder_intersect_matches_jax(convex):
    cfg = _mirror_config(convex)
    jp = JaxPipeline(cfg)
    tp = TorchPipeline(cfg, device="cpu")
    origin, direction = _cone(20000, seed=3, half_angle=np.radians(15.0))
    n = len(origin)
    jr = JaxRays(origin=jnp.asarray(origin), direction=jnp.asarray(direction),
                 wavelength=jnp.full((n,), 3.9492, jnp.float32),
                 weight=jnp.ones((n,), jnp.float32), mask=jnp.ones((n,), bool))
    t_j, n_j, m_j = jax.tree_util.tree_map(
        np.asarray, jp.optics[0].make_intersect()(jp.params["optics"]["mirror"], jr))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp.params), device="cpu")
    tr = Rays(origin=torch.from_numpy(origin), direction=torch.from_numpy(direction),
              wavelength=torch.full((n,), 3.9492), weight=torch.ones(n),
              mask=torch.ones(n, dtype=torch.bool))
    t_t, n_t, m_t = (x.numpy() for x in tp.optics[0].intersect(params["optics"]["mirror"], tr))
    assert m_j.sum() == n  # a cylinder of 0.8 m catches the whole 15 deg cone
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=2e-6)
    np.testing.assert_allclose(n_t, n_j, rtol=0, atol=2e-6)


def _mc_config(kind, intensity=8192):
    """A cylindrical variant of ``tests/test_fused_grad.py`` in mc mode with
    nearest images on the fused engine."""
    cfg = copy.deepcopy(_variant_config(kind))
    cfg["general"].update(engine="fused", interact_mode="mc", image_mode="nearest")
    cfg["sources"]["source"]["intensity"] = intensity
    return cfg


@pytest.mark.parametrize("kind", ["cylinder_crystal", "convex_cylinder_mirror"])
def test_fused_twin_cylinder_matches_jax_megakernel(kind):
    cfg = _mc_config(kind)
    if kind == "convex_cylinder_mirror":  # K1 traces no mirror: a crystal
        mirror = cfg["optics"]["mirror"]
        mirror.update(class_name="XicsrtOpticCylindricalCrystal",
                      crystal_spacing=2.45676, rocking_type="step", rocking_fwhm=10.0)
    jp = JaxPipeline(cfg)
    tp = TorchPipeline(cfg, device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp.params), device="cpu")
    src = ft._source_spec(tp.source)
    optics = [ft._optic_spec(o) for o in tp.optics]
    fparams = ft.pack_params(src, optics, params, "cpu")
    n_total = tp.num_rays
    key = jax.random.key(6)
    ref = jax.tree_util.tree_map(
        np.asarray, jax_build_fused_run(jp, chunk=1024, interpret=True, rng="input")(key))
    n_chunks = -(-n_total // 1024)
    U = jax.random.uniform(key, (n_chunks, fparams.n_draws, 8, 128), dtype=jnp.float32)
    U = torch.tensor(np.asarray(U)).permute(1, 0, 2, 3).reshape(fparams.n_draws, -1)
    counts, flat = ft.fused_run_cuda(fparams, n_total, n_total,
                                     uniforms=U[:, :n_total].contiguous())
    names = tp.element_names
    for i, name in enumerate(names):
        assert abs(int(counts[i]) - int(ref["meta"][name])) <= TOL_RAYS, name
    assert int(ref["meta"]["detector"]) > 200
    off = 0
    for o in optics:
        if o["image"] is None:
            continue
        size = o["image"]["nx"] * o["image"]["ny"]
        img = flat[off:off + size].reshape(o["image"]["nx"], o["image"]["ny"]).numpy()
        off += size
        assert np.abs(img - ref["image"][o["name"]]).sum() <= 2 * TOL_RAYS


def test_engines_agree_on_a_cylindrical_crystal():
    cfg = _mc_config("cylinder_crystal", intensity=1 << 15)
    cfg["general"]["number_of_iter"] = 2
    res = {}
    for engine in ("xla", "fused"):
        c = copy.deepcopy(cfg)
        c["general"]["engine"] = engine
        out = raytrace(c, device="cpu")
        res[engine] = {k: v["num_out"] for k, v in out["total"]["meta"].items()}
    a, b = res["xla"], res["fused"]
    assert a["source"] == b["source"] == 1 << 16
    p1, p2 = a["detector"] / a["source"], b["detector"] / b["source"]
    pooled = (a["detector"] + b["detector"]) / (a["source"] + b["source"])
    sigma = np.sqrt(pooled * (1 - pooled) * 2 / a["source"])
    assert a["detector"] > 500
    assert abs(p1 - p2) < 5 * sigma, (p1, p2, sigma)
