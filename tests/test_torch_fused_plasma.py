"""The fused kernel's plain twin with a plasma source and a toroidal crystal
(K1f, K1c-torus) against the JAX megakernel.

``build_fused_run(pipe, chunk=1024, interpret=True, rng='input')`` runs the
Pallas kernel through its interpreter. Its plasma pads each iteration to
``round_up(N, 1024)`` rays and draws uniforms ``U[chunk, k, s, lane]`` for
the padded ray ``chunk*1024 + s*128 + lane`` (``fused_trace.py:1279-1282,
1973``); the port traces ``N`` rays per iteration, so the test re-lays ``U``
onto ``(n_draws, num_iter * N)`` by (iteration, local ray). The bundle
tables are rebuilt with JAX's own key discipline (``split(key, num_iter)``,
then ``split(j_key, 7)[:3]``, ``fused_trace.py:1917-1921``) and handed to
the twin as tensors.

Tolerance: per element at most ``TOL_RAYS`` rays apart, each image by at
most 2 per such ray (L1). The twin draws its normals with
``torch.special.erfinv`` and XLA with its own ``erf_inv``; they differ by
ulps, which moves a wavelength by ~1e-11 A and can flip a ray at the edge
of the crystal's rocking curve; XLA may also fuse multiply-adds the twin
rounds apart. Measured on this config: 0 rays apart per element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops.fused_trace import _optic_spec as jax_optic_spec
from xicsrt_tpu.ops.fused_trace import build_fused_run as jax_build_fused_run
from xicsrt_tpu.ops.fused_trace import torus_local_quadratic_t
from xicsrt_tpu_torch import params_from_jax
from xicsrt_tpu_torch import raytrace
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.engine import build_runner
from xicsrt_tpu_torch.ops import fused_trace as ft

TOL_RAYS = 2
CHUNK = 1024


def _config(**plasma):
    """``tests/test_fused_engine.py:1084-1108``: 100 bundles, a toroidal
    crystal of 2 mrad rocking width, 3 iterations."""
    src = {
        "class_name": "XicsrtPlasmaCubic", "origin": [0.0, 0.0, 0.0],
        "xsize": 0.02, "ysize": 0.02, "zsize": 0.02,
        "target": [0.0, 0.0, 0.80374151], "spread": np.radians(10.0),
        "emissivity": 2e13, "temperature": 500.0, "mass_number": 40.0,
        "wavelength": 3.9492, "time_resolution": 1e-3, "bundle_volume": 1e-6,
        "bundle_count": 100, "use_poisson": True,
    }
    src.update(plasma)
    return {
        "general": {"number_of_iter": 3, "random_seed": 0, "keep_history": False,
                    "print_results": False},
        "sources": {"plasma": src},
        "optics": {
            "crystal": {
                "class_name": "XicsrtOpticToroidalCrystal",
                "origin": [0.0, 0.0, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151], "xsize": 0.2, "ysize": 0.2,
                "radius_major": 1.0, "radius_minor": 0.64, "crystal_spacing": 2.45676,
                "rocking_type": "gaussian", "rocking_fwhm": 2e-3},
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084], "xsize": 0.4, "ysize": 0.2},
        },
    }


def _jax_tables(jp, key, num_iter):
    tables = jax.jit(jp.source.make_bundle_tables())
    sp = jp.params["sources"][jp.source.name]
    cums, tabs = [], []
    for j_key in jax.random.split(key, num_iter):
        ks = jax.random.split(j_key, 7)
        cum, table, _ = tables(sp, jp.params["filters"], ks[0], ks[1], ks[2])
        cums.append(np.asarray(cum))
        tabs.append(np.asarray(table))
    return torch.from_numpy(np.stack(cums)), torch.from_numpy(np.stack(tabs))


@pytest.mark.parametrize("plasma", [{}, {"linewidth": 3e14, "velocity": [0.0, 2e4, 0.0],
                                         "bundle_type": "point"}],
                         ids=["voxel", "point_cauchy_doppler"])
def test_twin_matches_jax_megakernel(plasma):
    cfg = _config(**plasma)
    num_iter = cfg["general"]["number_of_iter"]
    jp = JaxPipeline(cfg)
    tp = TorchPipeline(cfg, device="cpu")
    key = jax.random.key(5)
    ref = jax.tree_util.tree_map(
        np.asarray, jax_build_fused_run(jp, chunk=CHUNK, interpret=True, rng="input")(key))

    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp.params), device="cpu")
    src = ft._source_spec(tp.source)
    optics = [ft._optic_spec(o) for o in tp.optics]
    fparams = ft.pack_params(src, optics, params, "cpu")
    n = tp.num_rays
    cpi = -(-n // CHUNK)
    U = jax.random.uniform(key, (num_iter * cpi, fparams.n_draws, 8, CHUNK // 8),
                           dtype=jnp.float32)
    U = (torch.from_numpy(np.array(U)).reshape(num_iter, cpi, fparams.n_draws, CHUNK)
         .permute(2, 0, 1, 3).reshape(fparams.n_draws, num_iter, cpi * CHUNK)[:, :, :n]
         .reshape(fparams.n_draws, num_iter * n).contiguous())
    bundles = _jax_tables(jp, key, num_iter)
    counts, flat = ft.fused_run_cuda(fparams, num_iter * n, 0, uniforms=U, bundles=bundles)

    expected = num_iter * 2e13 * 1e-3 * 0.02**3 * np.sin(np.radians(10.0) / 2) ** 2
    assert abs(int(counts[0]) - expected) < 6 * np.sqrt(expected)
    assert int(counts[0]) == int(ref["meta"]["plasma"])
    for i, name in enumerate(tp.element_names):
        assert abs(int(counts[i]) - int(ref["meta"][name])) <= TOL_RAYS, name
    assert int(ref["meta"]["detector"]) > 30
    nx, ny = optics[1]["image"]["nx"], optics[1]["image"]["ny"]
    off = optics[0]["image"]["nx"] * optics[0]["image"]["ny"]
    img = flat[off:off + nx * ny].reshape(nx, ny).numpy()
    assert img.sum() == int(counts[2])
    assert np.abs(img - ref["image"]["detector"]).sum() <= 2 * TOL_RAYS


def test_torus_root_matches_jax_per_ray():
    """The twin's torus root against JAX ``torus_local_quadratic_t`` on the
    rays of ``tests/test_fused_engine.py:652``'s two sweeps: hit masks equal
    but for at most 2 beam rays, and those within 1e-4 of the tangency line
    |y| = r_minor, where the convergence test sits on its threshold; t to
    5e-6 m where both hit (XLA may fuse multiply-adds that the twin rounds
    apart, and four Newton steps carry the difference)."""
    cfg = {
        "general": {"number_of_iter": 1, "random_seed": 0, "print_results": False,
                    "keep_history": False},
        "sources": {"source": {"class_name": "XicsrtSourceDirected", "intensity": 16,
                               "wavelength": 3.9492}},
        "optics": {"crystal": {
            "class_name": "XicsrtOpticToroidalCrystal",
            "origin": [0.0, 0.0, 0.0], "zaxis": [0.0, 0.0, 1.0],
            "xsize": 2.0, "ysize": 2.0, "radius_major": 1.0, "radius_minor": 0.2,
            "crystal_spacing": 2.45676, "rocking_type": "gaussian",
            "rocking_fwhm": 1e-3}},
    }
    jp = JaxPipeline(cfg)
    tp = TorchPipeline(cfg, device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp.params), device="cpu")
    fparams = ft.pack_params(ft._source_spec(tp.source), [ft._optic_spec(tp.optics[0])],
                             params, "cpu")
    o = [float(x) for x in fparams.fp[ft.SRC_F:ft.SRC_F + ft.OPT_F].tolist()]
    spec = jax_optic_spec(jp.optics[0], 3.9492, False, "mc")

    y = np.linspace(-0.25, 0.25, 50001)
    beam = (np.stack([np.zeros_like(y), y, np.ones_like(y)], 1),
            np.tile([0.0, 0.0, -1.0], (len(y), 1)))
    rng = np.random.default_rng(0)
    t = np.tan(np.radians(20.0)) * (2 * rng.random((50000, 2)) - 1)
    d = np.concatenate([t, -np.ones((50000, 1))], 1)
    cone = (np.tile([0.0, 0.0, 1.0], (50000, 1)), d / np.linalg.norm(d, axis=1, keepdims=True))
    for label, (origin, direction) in (("beam", beam), ("cone", cone)):
        p = [np.asarray(origin[:, i], np.float32) for i in range(3)]
        q = [np.asarray(direction[:, i], np.float32) for i in range(3)]
        n = len(p[0])
        t_j, m_j, _, _ = torus_local_quadratic_t(
            spec, *(jnp.asarray(a) for a in p + q), jnp.ones((n,), bool))
        t_t, m_t = ft.torus_hit_plain(
            o, *(torch.from_numpy(a) for a in p + q), torch.ones(n, dtype=torch.bool),
            lambda v: torch.full((n,), v, dtype=torch.float32))
        m_j, t_j = np.asarray(m_j), np.asarray(t_j)
        m_t, t_t = m_t.numpy(), t_t.numpy()
        assert m_j.sum() > 0.5 * n
        apart = m_t != m_j
        if label == "beam":
            assert apart.sum() <= 2 and np.all(np.abs(np.abs(y[apart]) - 0.2) < 1e-4)
        else:
            assert not apart.any()
        both = m_t & m_j
        np.testing.assert_allclose(t_t[both], t_j[both], rtol=0, atol=5e-6)


def test_engine_routes_plasma_to_the_fused_twin():
    """``engine='auto'`` with ``keep_history=False`` takes the fused engine
    for a plasma (JAX ``engine.py:374-435``); full history stays eager;
    ``'fused'`` with full history raises; over 2^22 bundles is outside
    K1's subset and runs on the trace-only kernel K3's twin."""
    cfg = _config()
    cfg["general"]["engine"] = "auto"
    runner, pipe = build_runner(cfg, device="cpu")
    assert runner.__qualname__.startswith("build_fused_run")
    res = raytrace(cfg, device="cpu")
    expected = 3 * 2e13 * 1e-3 * 0.02**3 * np.sin(np.radians(10.0) / 2) ** 2
    n = res["total"]["meta"]["plasma"]["num_out"]
    assert abs(n - expected) < 6 * np.sqrt(expected)
    assert res["total"]["image"]["detector"].sum() == res["total"]["meta"]["detector"]["num_out"]
    cfg["general"]["keep_history"] = True
    runner, _ = build_runner(cfg, device="cpu")
    assert not runner.__qualname__.startswith("build_fused_run")
    cfg["general"]["engine"] = "fused"
    with pytest.raises(NotImplementedError):
        build_runner(cfg, device="cpu")
    big = _config(bundle_count=(1 << 22) + 1, max_bundles=int(1e7), emissivity=2e10)
    big["general"]["engine"] = "fused"
    with pytest.raises(ft.FusedUnsupported):
        ft.build_fused_run(TorchPipeline(big, device="cpu"))
    runner, _ = build_runner(big, device="cpu")
    assert runner.__qualname__.startswith("build_fused_trace_run")
