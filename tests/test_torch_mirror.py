"""Mirrors in K1 and K3 (K1c-mirror) against the JAX package, and an optic's
``filters`` list, which both packages accept and ignore.

A mirror, and a crystal without its Bragg check, reflects the rays its
bounds keep, ``d' = d - 2 (d.n) n``, with no draw (JAX
``fused_trace.py:1099-1103``). The configs are ``tests/test_fused_engine.
py``'s mirror chains: the plane fold (:129-165), the convex spherical
mirror (:219), the convex toroidal crystals without their Bragg check
(:589-608), the wide-spread grazing torus (:610-629) and the convex
cylindrical mirror (:744).

``k1_twin_against_jax`` runs the JAX megakernel through its interpreter on
``jax.random.uniform(key, (n_chunks, n_draws, 8, 128))`` and the port's
twin on the same uniforms in its ray order (``tests/test_torch_fused.py``);
``k3_twin_against_jax`` does the same for the trace-only kernels
(``tests/test_torch_trace_only.py``). Tolerance, as there: per element at
most ``TOL_RAYS`` rays apart and each image by at most 2 per such ray (L1),
since XLA may fuse multiply-adds and round sin/exp/sqrt otherwise, which can
flip a ray at a threshold.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_fused_engine as jax_fused_tests
from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops.fused_trace import build_fused_run as jax_build_fused_run
from xicsrt_tpu.ops.fused_trace import build_fused_trace_run as jax_build_fused_trace_run
from xicsrt_tpu_torch import params_from_jax
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.ops import fused_trace as ft

TOL_RAYS = 3
CHUNK = 1024


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _uniforms(key, n_draws, n):
    """JAX's (n_chunks, n_draws, 8, 128) uniforms in the port's ray order."""
    if n_draws == 0:  # a chain of mirrors and detectors draws nothing
        return torch.zeros((0, n))
    U = jax.random.uniform(key, (-(-n // CHUNK), n_draws, 8, CHUNK // 8), dtype=jnp.float32)
    return torch.tensor(np.asarray(U)).permute(1, 0, 2, 3).reshape(n_draws, -1)[:, :n].contiguous()


def _compare(counts, flat, ref, names, optics, tol, image_tol=None, unit_sums=True):
    """Counts within ``tol`` rays of JAX's and images within ``image_tol``
    (L1: a number, or a function of JAX's image; by default 2 per such ray);
    with ``unit_sums`` (mc mode, nearest images) every image sums to its
    count."""
    for i, name in enumerate(names):
        assert abs(int(counts[i]) - int(ref["meta"][name])) <= tol, (
            name, counts.tolist(), ref["meta"])
    off = 0
    for o in optics:
        if o["image"] is None:
            continue
        size = o["image"]["nx"] * o["image"]["ny"]
        img = flat[off:off + size].reshape(o["image"]["nx"], o["image"]["ny"]).numpy()
        off += size
        limit = (2 * tol if image_tol is None else
                 image_tol(ref["image"][o["name"]]) if callable(image_tol) else image_tol)
        assert np.abs(img - ref["image"][o["name"]]).sum() <= limit, (
            o["name"], np.abs(img - ref["image"][o["name"]]).sum(), limit)
        if unit_sums:
            assert img.sum() == int(counts[names.index(o["name"])])


def k1_twin_against_jax(cfg, seed, tol=TOL_RAYS, image_tol=None):
    """The K1 twin and the interpreted JAX megakernel on ``cfg`` under the
    same uniforms: counts within ``tol`` rays, each image's L1 difference
    within ``image_tol`` (by default 2 per such ray). Returns (the twin's
    counts, JAX's result, the packed buffers)."""
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    params = params_from_jax(_tree(jp.params), device="cpu")
    src = ft._source_spec(tp.source, {f.name: f for f in tp.filters})
    optics = [ft._optic_spec(o) for o in tp.optics]
    fparams = ft.pack_params(src, optics, params, "cpu", **ft._chain_modes(tp.general))
    n = tp.num_rays
    key = jax.random.key(seed)
    ref = _tree(jax_build_fused_run(jp, chunk=CHUNK, interpret=True, rng="input")(key))
    counts, flat = ft.fused_run_cuda(fparams, n, n, uniforms=_uniforms(key, fparams.n_draws, n))
    _compare(counts, flat, ref, tp.element_names, optics, tol, image_tol,
             not (fparams.weight or fparams.bilinear))
    return counts, ref, fparams


def k3_twin_against_jax(cfg, seed, tol=TOL_RAYS, image_tol=None):
    """The K3 twin and JAX's interpreted trace-only kernel on the rays of
    one JAX iteration under the same uniforms. Returns (the twin's counts,
    JAX's result, the packed buffers)."""
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    key = jax.random.key(seed)
    ref = _tree(jax_build_fused_trace_run(jp, num_iter=1, chunk=CHUNK, interpret=True,
                                          rng="input")(key))
    k_src, k_kernel = jax.random.split(jax.random.split(key, 1)[0])
    rays = _tree(jp.generate(jp.params["sources"][jp.source.name], jp.params["filters"],
                             k_src))
    optics = [ft._optic_spec(o) for o in tp.optics]
    fparams = ft.pack_params({"name": None, "kind": ft.SRC_RAYS, "n_draws": 0}, optics,
                             params_from_jax(_tree(jp.params), device="cpu"), "cpu",
                             **ft._chain_modes(tp.general))
    n = rays.mask.shape[0]
    counts, flat = ft.fused_trace_run_cuda(
        fparams, torch.tensor(rays.origin), torch.tensor(rays.direction),
        torch.tensor(rays.wavelength), torch.tensor(rays.mask),
        uniforms=_uniforms(k_kernel, fparams.n_draws, n),
        weight=torch.tensor(rays.weight) if fparams.weight else None)
    _compare(counts, flat, ref, tp.element_names, optics, tol, image_tol,
             not (fparams.weight or fparams.bilinear))
    return counts, ref, fparams


def _fold(n):
    """The plane fold onto a step-rocking flat crystal (:129-165)."""
    return {
        "general": {"number_of_iter": 1, "random_seed": 0, "keep_history": False,
                    "print_results": False},
        "sources": {"source": {"class_name": "XicsrtSourceDirected", "intensity": n,
                               "wavelength": 3.9492, "angular_dist": "isotropic",
                               "spread": np.radians(5.0)}},
        "optics": {
            "mirror": {"class_name": "XicsrtOpticPlanarMirror", "origin": [0.0, 0.0, 0.5],
                       "zaxis": [0.0, 0.3826834, -0.9238795], "xsize": 0.5, "ysize": 0.5},
            "crystal": {"class_name": "XicsrtOpticPlanarCrystal",
                        "origin": [0.0, 0.21213203, 0.28786797], "zaxis": [0.0, -1.0, 0.0],
                        "xsize": 0.5, "ysize": 0.5,
                        "crystal_spacing": 3.9492 / (2.0 * np.sin(np.pi / 4)),
                        "rocking_type": "step", "rocking_fwhm": 5e-3},
        },
    }


def _single(n, optic, spread_deg):
    """One optic under an isotropic cone, as the JAX tests' mirrors."""
    cfg = jax_fused_tests.TestWidenedSubset._crystal_config(None, n, optic)
    cfg["sources"]["source"].update(angular_dist="isotropic", spread=np.radians(spread_deg))
    del cfg["optics"]["detector"]
    return cfg


def _mirror_configs(n):
    torus = {"class_name": "XicsrtOpticToroidalCrystal", "origin": [0.0, 0.0, 0.5],
             "zaxis": [0.0, 0.0, -1.0], "xsize": 0.15, "ysize": 0.15,
             "radius_major": 1.0, "radius_minor": 0.5, "check_bragg": False,
             "crystal_spacing": 2.45676}
    return {
        "plane_fold": _fold(n),
        "convex_sphere": _single(n, {"class_name": "XicsrtOpticSphericalMirror",
                                     "origin": [0.0, 0.0, 0.5], "zaxis": [0.0, 0.0, -1.0],
                                     "xsize": 0.3, "ysize": 0.3, "radius": 2.0,
                                     "convex": True}, 3.0),
        "torus_no_check_tt": _single(n, dict(torus, convex=[True, True]), 3.0),
        "torus_no_check_tf": _single(n, dict(torus, convex=[True, False]), 3.0),
        "torus_grazing": _single(n, dict(torus, xsize=0.5, ysize=0.5, radius_minor=0.1,
                                         pixel_size=0.03125, convex=[False, False]), 28.0),
        "convex_cylinder": _single(n, {"class_name": "XicsrtOpticCylindricalMirror",
                                       "origin": [0.0, 0.0, 0.5], "zaxis": [0.0, 0.0, -1.0],
                                       "xsize": 0.3, "ysize": 0.3, "radius": 2.0,
                                       "convex": True}, 3.0),
    }


@pytest.mark.parametrize("name", list(_mirror_configs(1)))
def test_k1_mirror_twin_matches_jax_megakernel(name):
    cfg = _mirror_configs(4096)[name]
    counts, ref, fparams = k1_twin_against_jax(cfg, seed=41)
    assert not fparams.cheb
    assert int(counts[-1]) > 0
    interacts = [int(fparams.ip[ft.HDR_I + e * ft.OPT_I + 2]) for e in range(fparams.n_optics)]
    assert 2 in interacts


@pytest.mark.parametrize("name", ["plane_fold", "torus_no_check_tt"])
def test_k3_mirror_twin_matches_jax_trace_only(name):
    cfg = _mirror_configs(4096)[name]
    counts, _, _ = k3_twin_against_jax(cfg, seed=43)
    assert int(counts[-1]) > 0


def test_mirror_reflects_without_a_draw():
    """A mirror draws no uniform; a crystal without its Bragg check is
    packed as a mirror, so the chain's draws are the source's alone."""
    tp = TorchPipeline(_mirror_configs(16)["torus_no_check_tt"], device="cpu")
    spec = ft._optic_spec(tp.optics[0])
    assert spec["interact"] == 2 and spec["n_draws"] == 0
    fparams = ft.pack_params(ft._source_spec(tp.source), [spec], tp.params, "cpu")
    assert fparams.n_draws == 2


def test_optic_filters_are_accepted_and_ignored():
    """An optic's ``filters`` list builds on both packages and changes
    nothing: under the same uniforms each package counts exactly as it does
    without the list, and the two packages agree (the module's bound)."""
    from __graft_entry__ import _spectrometer_config

    cfg = _spectrometer_config(intensity=4096, engine="fused")
    cfg["filters"] = {"sight": {"class_name": "XicsrtBundleFilterSightline",
                                "origin": [0.0, 0.0, 0.0], "zaxis": [0.0, 0.0, 1.0],
                                "radius": 1e-4}}
    plain = copy.deepcopy(cfg)
    cfg["optics"]["crystal"]["filters"] = ["sight"]
    counts, ref, _ = k1_twin_against_jax(cfg, seed=45)
    base, ref_base, _ = k1_twin_against_jax(plain, seed=45)
    assert torch.equal(counts, base) and int(counts[-1]) > 20
    assert {k: int(v) for k, v in ref["meta"].items()} == {
        k: int(v) for k, v in ref_base["meta"].items()}
