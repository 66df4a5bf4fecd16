"""Mesh optics on both engines of the port against the JAX package.

- ``optics/mesh_shapes.py``: the dense and the grid-refined intersects
  against JAX's on the same float32 rays: hit masks equal but for at most
  1e-4 of the rays (a ray on a triangle edge may fall to either side),
  distances to 2e-6 and normals to 2e-5 (the two sum the same float32
  products in other orders).
- The eager engine against the reference's ``mesh_sphere`` golden
  (``tests/golden/mesh_sphere_reference_image.npz``) with the checks of
  ``tests/test_reference_parity_families.py:123-187``, at its num_iter=2;
  the sphere mesh's exact triangles accept about 2 % more than the
  analytic sphere on the same rays, on JAX's XLA engine as on the port's.
- The Chebyshev surrogate (K1c-cheb): ``_fit_cheb_surface`` equals JAX's
  coefficient for coefficient, and the kernels' packed nonzero terms sum
  as JAX's zero-skipping sums, bit for bit; the K1 twin against the interpreted JAX
  megakernel on ``tests/test_fused_engine.py``'s three mesh crystals
  (:797-803), and the K3 twin against JAX's trace-only kernel on the mesh
  crystal behind a plasma (:854), at most 2 rays apart per element (a ray
  at the domain edge |u| = 1 may flip; XLA may fuse multiply-adds). The
  cylinder focuses its line onto the detector's central pixel boundary
  (fy = 24.5, a round-half-to-even tie), where one float32 rounding moves a
  ray one pixel: its images are held to 12 (L1), which the analytic
  cylinder's K1 twin also needs there (8-10 against JAX's kernel at seeds
  61-63, 2-6 for the mesh).
- The fallbacks: a faceted mesh raises "faceted" on ``engine='fused'``, a
  rough one raises, ``'auto'`` traces both on the eager engine; K5 refuses
  meshes, as JAX's does.
- Example 06's ``config`` as written through ``raytrace(config,
  device='cpu')`` on both of its engines.
"""

import ast
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import test_fused_engine as jax_fused_tests
from tests import test_reference_parity_families as families
from tests.test_torch_mirror import k1_twin_against_jax, k3_twin_against_jax
import xicsrt_tpu
from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops import fused_trace as jft
from xicsrt_tpu.optics.mesh_shapes import grid_faces as jax_grid_faces
from xicsrt_tpu.rays import Rays as JaxRays
from xicsrt_tpu_torch import make_fused_differentiable, params_from_jax, raytrace
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.engine import build_runner
from xicsrt_tpu_torch.ops import fused_trace as ft
from xicsrt_tpu_torch.ops.fused_grad import FusedGradUnsupported
from xicsrt_tpu_torch.optics.mesh_shapes import grid_faces
from xicsrt_tpu_torch.rays import Rays

TOL_CHEB = 2
MESHES = {
    "sphere": ("XicsrtOpticMeshSphericalCrystal",
               dict(radius=1.0, mesh_size=(41, 41), mesh_coarse_size=(11, 11))),
    "cylinder": ("XicsrtOpticMeshCylindricalCrystal",
                 dict(radius=1.0, mesh_size=(41, 41), mesh_coarse_size=(11, 11))),
    "torus": ("XicsrtOpticMeshToroidalCrystal",
              dict(radius_major=1.0, radius_minor=0.64, mesh_size=(41, 41),
                   mesh_coarse_size=(11, 11), rocking_fwhm=2e-3)),
}


def _mesh_config(n, cls, **kw):
    """``tests/test_fused_engine.py``'s mesh spectrometer (:772-795)."""
    return jax_fused_tests.TestMeshSurrogate._mesh_config(None, n, cls, **kw)


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rays(n, seed, half_angle):
    """Float32 rays from the source point in a cone about +z, onto the
    crystal 0.8 m away."""
    rng = np.random.default_rng(seed)
    t = np.tan(half_angle) * (2 * rng.random((n, 2)) - 1)
    d = np.concatenate([t, np.ones((n, 1))], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.zeros((n, 3), np.float32), d.astype(np.float32)


@pytest.mark.parametrize("refine", [True, False], ids=["refine", "dense"])
@pytest.mark.parametrize("mesh", ["sphere", "torus"])
def test_mesh_intersect_matches_jax(mesh, refine):
    cls, kw = MESHES[mesh]
    cfg = _mesh_config(16, cls, **dict(kw, mesh_refine=refine, mesh_ray_block=1000,
                                       mesh_chunk=700))
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    assert tp.optics[0].param["mesh_refine"] == refine
    origin, direction = _rays(3000, seed=5, half_angle=np.radians(7.0))
    n = len(origin)
    jr = JaxRays(origin=jnp.asarray(origin), direction=jnp.asarray(direction),
                 wavelength=jnp.full((n,), 3.9492, jnp.float32),
                 weight=jnp.ones((n,), jnp.float32), mask=jnp.ones((n,), bool))
    t_j, n_j, m_j = _tree(jp.optics[0].make_intersect()(jp.params["optics"]["crystal"], jr))
    params = params_from_jax(_tree(jp.params), device="cpu")
    tr = Rays(origin=torch.from_numpy(origin), direction=torch.from_numpy(direction),
              wavelength=torch.full((n,), 3.9492), weight=torch.ones(n),
              mask=torch.ones(n, dtype=torch.bool))
    t_t, n_t, m_t = (x.numpy() for x in tp.optics[0].intersect(params["optics"]["crystal"],
                                                                tr))
    assert 0.2 * n < m_j.sum() < n  # the cone overfills the crystal
    assert (m_t != m_j).sum() <= max(1, 1e-4 * n)
    both = m_t & m_j
    np.testing.assert_allclose(t_t[both], t_j[both], rtol=0, atol=2e-6)
    np.testing.assert_allclose(n_t[both], n_j[both], rtol=0, atol=2e-5)


def test_grid_faces_and_generated_meshes_match_jax():
    np.testing.assert_array_equal(grid_faces(5, 4), jax_grid_faces(5, 4))
    for cls, kw in MESHES.values():
        cfg = _mesh_config(16, cls, **dict(kw, normal_method="fd")
                           if "Toroidal" in cls else kw)
        jo, to = JaxPipeline(cfg).optics[0], TorchPipeline(cfg, device="cpu").optics[0]
        for key in ("mesh_points", "mesh_normals", "mesh_faces", "mesh_coarse_points",
                    "mesh_coarse_faces"):
            np.testing.assert_array_equal(np.asarray(to.param[key]), np.asarray(jo.param[key]))


def test_eager_mesh_matches_the_golden():
    """``tests/test_reference_parity_families.py``'s ``mesh_sphere``
    scenario at its num_iter=2 on the port's eager engine."""
    golden = families._load_golden("mesh_sphere")
    ours = raytrace(families._config(families.CRYSTALS["mesh_sphere"], num_iter=2),
                    device="cpu")
    checks = families.TestFamilyParity()
    for check in (checks.test_crystal_acceptance, checks.test_efficiency,
                  checks.test_image_distribution_superpixels,
                  checks.test_line_position_and_width):
        check(("mesh_sphere", golden, ours))


def test_sphere_mesh_faceting_gap_is_the_references():
    """The 41 x 41 sphere's exact triangles interpolate the vertex normals
    linearly, a few urad off the sphere's, and the focusing geometry turns
    that into about 2 % more crystal hits than the analytic sphere on the
    same rays: on JAX's XLA engine as on the port's eager engine. Each
    package's gap is paired (same seed, same rays): its noise is about the
    square root of the rays it moves. The two gaps agree within 5 of that."""
    cls, kw = MESHES["sphere"]
    n = 1 << 17
    gaps = {}
    for name, run in (("jax", lambda c: xicsrt_tpu.raytrace(c)),
                      ("port", lambda c: raytrace(c, device="cpu"))):
        hits = [run(_mesh_config(n, c, **k))["total"]["meta"]["crystal"]["num_out"]
                for c, k in ((cls, kw), ("XicsrtOpticSphericalCrystal", {"radius": 1.0}))]
        gaps[name] = (hits[0] - hits[1], hits[1])
    (dj, aj), (dp, ap) = gaps["jax"], gaps["port"]
    assert dj > 0.01 * aj and dp > 0.01 * ap, gaps
    assert abs(dj / aj - dp / ap) < 5 * np.hypot(np.sqrt(dj) / aj, np.sqrt(dp) / ap), gaps


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cheb_fit_matches_jax(mesh):
    cls, kw = MESHES[mesh]
    cfg = _mesh_config(16, cls, **kw)
    ref = jft._fit_cheb_surface(JaxPipeline(cfg).optics[0])
    ours = ft._fit_cheb_surface(TorchPipeline(cfg, device="cpu").optics[0])
    assert ours["deg"] == ref["deg"]
    for key in ("C", "Cx", "Cy"):
        np.testing.assert_array_equal(ours[key], np.asarray(ref[key]))
    for key in ("cx", "cy", "sx", "sy", "zmid", "tol_c"):
        assert ours[key] == ref[key]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cheb_terms_sum_as_the_tpu_kernel_does(mesh):
    """The packed terms hold every nonzero float32 coefficient of C, Cx and
    Cy once, i outer, j inner, at an even aux offset; each matrix's terms,
    summed in their order, give JAX's zero-skipping sums bit for bit
    (float32, 4096 seeded points)."""
    cls, kw = MESHES[mesh]
    pipe = TorchPipeline(_mesh_config(16, cls, **kw), device="cpu")
    ch = ft._fit_cheb_surface(pipe.optics[0])
    terms = ft.cheb_terms(ch)
    deg = ch["deg"]
    codes = terms[:, 1].astype(int)
    s, ij = codes >> 8, codes & 255
    assert (np.diff(ij) >= 0).all() and (terms[:, 0] != 0).all()
    for k, key in enumerate(("C", "Cx", "Cy")):
        dense = np.zeros((deg + 1, deg + 1), np.float32)
        dense[ij[s == k] >> 4, ij[s == k] & 15] = terms[s == k, 0]
        np.testing.assert_array_equal(dense, np.asarray(ch[key], np.float32))

    fparams = ft.pack_params(ft._source_spec(pipe.source),
                             [ft._optic_spec(o) for o in pipe.optics], pipe.params, "cpu")
    oi = fparams.ip[ft.HDR_I:ft.HDR_I + ft.OPT_I].tolist()
    assert oi[ft.OI_CHEB] % 2 == 0 and oi[ft.OI_TERMS] == len(terms)
    np.testing.assert_array_equal(
        fparams.aux[oi[ft.OI_CHEB]:oi[ft.OI_CHEB] + terms.size].numpy(), terms.reshape(-1))

    rng = np.random.default_rng(7)
    uv = rng.uniform(-1.25, 1.25, (2, 4096)).astype(np.float32)
    T = []
    for x in uv:
        t = [np.ones_like(x), x]
        for _ in range(deg - 1):
            t.append(np.float32(2.0) * x * t[-1] - t[-2])
        T.append(t)
    for k, key in enumerate(("C", "Cx", "Cy")):
        coef = np.asarray(ch[key], np.float32)
        ref = np.zeros(4096, np.float32)
        for i in range(deg + 1):
            for j in range(deg + 1):
                if coef[i, j] != 0.0:
                    ref = ref + coef[i, j] * T[0][i] * T[1][j]
        ours = np.zeros(4096, np.float32)
        for c, code in zip(terms[s == k, 0], ij[s == k]):
            ours = ours + c * T[0][code >> 4] * T[1][code & 15]
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("deg", [4, 6, 8, 10, 12])
def test_cheb_dense_sums_equal_the_sparse_sums(deg):
    """The kernels and their twin sum every coefficient of the packed dense
    matrices (``cheb_dense``, zeros included, i outer, j inner); on a fit of
    each degree (``chip_smoke.cheb_degree_config``, the same degree as
    JAX's fit) each of the three sums equals the sparse sum of the nonzero
    terms (``cheb_terms``, the TPU kernel's zero-skipping order) bit for
    bit, signed zeros included (float32, 4096 seeded points and the clip
    edges)."""
    import chip_smoke

    cfg = chip_smoke.cheb_degree_config(deg, 16)
    pipe = TorchPipeline(cfg, device="cpu")
    ch = ft._fit_cheb_surface(pipe.optics[0])
    assert ch["deg"] == deg == jft._fit_cheb_surface(JaxPipeline(cfg).optics[0])["deg"]
    terms, dense = ft.cheb_terms(ch), ft.cheb_dense(ch)
    assert dense.shape == ((deg + 1) ** 2, 4) and (dense[:, 3] == 0).all()
    fparams = ft.pack_params(ft._source_spec(pipe.source),
                             [ft._optic_spec(o) for o in pipe.optics], pipe.params, "cpu")
    oi = fparams.ip[ft.HDR_I:ft.HDR_I + ft.OPT_I].tolist()
    assert oi[ft.OI_DENSE] % 4 == 0 and oi[ft.OI_DEG] == deg
    np.testing.assert_array_equal(
        fparams.aux[oi[ft.OI_DENSE]:oi[ft.OI_DENSE] + dense.size].numpy(), dense.reshape(-1))

    rng = np.random.default_rng(11)
    uv = rng.uniform(-1.25, 1.25, (2, 4096)).astype(np.float32)
    uv[:, :3] = [[-1.25, 0.0, 1.25], [1.25, -1.25, 0.0]]
    T = []
    for x in uv:
        t = [np.ones_like(x), x]
        for _ in range(deg - 1):
            t.append(np.float32(2.0) * x * t[-1] - t[-2])
        T.append(t)
    codes = terms[:, 1].astype(int)
    for k in range(3):
        sparse = np.zeros(4096, np.float32)
        for c, code in zip(terms[codes >> 8 == k, 0], codes[codes >> 8 == k] & 255):
            sparse = sparse + c * T[0][code >> 4] * T[1][code & 15]
        total = np.zeros(4096, np.float32)
        for i in range(deg + 1):
            for j in range(deg + 1):
                total = total + dense[(deg + 1) * i + j, k] * T[0][i] * T[1][j]
        assert (sparse != 0).any()
        np.testing.assert_array_equal(total.view(np.int32), sparse.view(np.int32))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_k1_cheb_twin_matches_jax_megakernel(mesh):
    cls, kw = MESHES[mesh]
    counts, ref, fparams = k1_twin_against_jax(_mesh_config(1 << 12, cls, **kw), seed=61,
                                               tol=TOL_CHEB,
                                               image_tol=12 if mesh == "cylinder" else None)
    assert fparams.cheb and int(counts[-1]) > 20
    assert int(fparams.ip[ft.HDR_I]) == ft._SHAPES["cheb"]


def test_k3_cheb_twin_behind_a_plasma():
    """The mesh crystal behind a cubic plasma (JAX
    ``test_mesh_with_plasma_hybrid``): K3's twin on one JAX iteration's
    plasma rays against JAX's trace-only kernel."""
    cls, kw = MESHES["sphere"]
    cfg = _mesh_config(0, cls, **dict(kw, rocking_fwhm=2e-3))
    cfg["sources"] = {"plasma": {
        "class_name": "XicsrtPlasmaCubic", "origin": [0.0, 0.0, 0.0],
        "xsize": 0.02, "ysize": 0.02, "zsize": 0.02, "target": [0.0, 0.0, 0.80374151],
        "spread": np.radians(10.0), "emissivity": 2e13, "temperature": 500.0,
        "mass_number": 40.0, "wavelength": 3.9492, "time_resolution": 1e-3,
        "bundle_volume": 1e-6, "bundle_count": 100, "use_poisson": True}}
    counts, _, _ = k3_twin_against_jax(cfg, seed=63, tol=TOL_CHEB)
    assert int(counts[0]) > 1000 and int(counts[-1]) > 10


def _faceted():
    cls, kw = MESHES["sphere"]
    return _mesh_config(1024, cls, **dict(kw, mesh_size=(21, 21), mesh_coarse_size=(11, 11),
                                          mesh_interpolate=False))


def _rough():
    nx, ny = 21, 21
    xg, yg = np.meshgrid(np.linspace(-0.1, 0.1, nx), np.linspace(-0.1, 0.1, ny),
                         indexing="ij")
    rng = np.random.default_rng(0)
    zg = 0.02 * np.sin(40 * xg) * np.cos(37 * yg) + rng.normal(0.0, 1e-3, xg.shape)
    pts = np.stack([xg.ravel(), yg.ravel(), zg.ravel()], axis=-1)
    normals = np.zeros_like(pts)
    normals[:, 2] = 1.0
    return _mesh_config(1024, "XicsrtOpticMeshCrystal", mesh_points=pts,
                        mesh_normals=normals, mesh_faces=grid_faces(nx, ny),
                        trace_local=True)


@pytest.mark.parametrize("make,match", [(_faceted, "faceted"), (_rough, "smooth height")],
                         ids=["faceted", "rough"])
def test_unfittable_meshes_fall_back(make, match):
    """``'fused'`` raises, ``'auto'`` runs the eager engine's exact
    triangles (JAX ``test_faceted_mesh_falls_back``,
    ``test_rough_mesh_falls_back``)."""
    cfg = make()
    with pytest.raises(ft.FusedUnsupported, match=match):
        ft.build_fused_run(TorchPipeline(cfg, device="cpu"))
    cfg["general"]["engine"] = "fused"
    with pytest.raises(ft.FusedUnsupported, match=match):
        raytrace(copy.deepcopy(cfg), device="cpu")
    cfg["general"]["engine"] = "auto"
    runner, _ = build_runner(cfg, device="cpu")
    assert runner.__qualname__.startswith("Pipeline.make_run")
    res = raytrace(cfg, device="cpu")
    assert res["total"]["meta"]["source"]["num_out"] == 1024
    assert res["total"]["meta"]["crystal"]["num_out"] > 0 or make is _rough


def test_fused_gradients_refuse_meshes():
    cls, kw = MESHES["sphere"]
    cfg = _mesh_config(1024, cls, **kw)
    cfg["general"].update(interact_mode="weight", image_mode="bilinear")
    with pytest.raises(FusedGradUnsupported):
        make_fused_differentiable(cfg, device="cpu")


def _example_06_config():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples",
                        "example_06_fused_engine.py")
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "config":
            return eval(compile(ast.Expression(node.value), path, "eval"), {"np": np})
    raise AssertionError("example 06 has no config")


def test_example_06_runs_on_both_engines():
    """Example 06's ``config`` as written: ``'xla'`` on the eager engine's
    triangles, ``'auto'`` on K1's Chebyshev surrogate (the twin here); the
    two detect within 5 binomial sigma."""
    out = {}
    for engine in ("xla", "auto"):
        cfg = _example_06_config()
        cfg["general"].update(engine=engine, print_results=False)
        runner, _ = build_runner(copy.deepcopy(cfg), device="cpu")
        assert runner.__qualname__.startswith(
            "build_fused_run" if engine == "auto" else "Pipeline.make_run")
        res = raytrace(cfg, device="cpu")
        out[engine] = {k: v["num_out"] for k, v in res["total"]["meta"].items()}
        for name, img in res["total"]["image"].items():
            assert img.sum() == out[engine][name]
    n = out["xla"]["source"]
    assert n == out["auto"]["source"] == 200000
    a, b = out["xla"]["detector"], out["auto"]["detector"]
    p = (a + b) / (2 * n)
    assert a > 1000 and abs(a - b) / n < 5 * np.sqrt(p * (1 - p) * 2 / n), out
