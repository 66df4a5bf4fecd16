"""The generic source matrix against the JAX package on identical draws.

- The samplers, function by function: ``flat``, ``flat_xy`` and the
  gaussian cone from the uniforms and normals JAX drew (its key splits
  reproduced), the Voigt CDF table (equal to float64 rounding) and the
  tabulated Voigt sampler (float32).
- ``generate`` of Generic, Directed and Focused sources over points,
  uniform and gaussian boxes, every cone, monochrome, uniform and Voigt
  wavelengths and a bulk velocity, on the draws of JAX's ``generate``.
- K1b: the fused kernel's plain twin against the JAX megakernel run through
  its interpreter (``rng='input'``) on the widened sources of
  ``tests/test_fused_engine.py:403-470, :944``.
- K5e-generic: the gradient kernels' twins against the interpreted JAX K5
  kernels on the six generic-source variants of
  ``tests/test_fused_grad.py:362-534``, and the hand adjoint against
  ``torch.autograd`` at float64, at the bounds of
  ``tests/test_torch_fused_grad.py``.

Tolerances: positions 1e-6 m; directions 1e-5 (sqrt(1 - z^2) turns one ulp
of z into ~1e-6 near a cone's axis, ``tests/test_torch_ops.py``);
wavelengths 5e-7 A (two float32 steps at 3.95 A: XLA may fuse a multiply-add
the port rounds apart); masks exactly. K1b's counts and images: exactly
equal, except where the source draws normals (a gaussian box or cone, a
Voigt line's Gauss part): there at most ``TOL_NORMALS`` rays apart per
element and 2 per such ray in each image's L1 norm, because the twin's
``torch.special.erfinv`` and XLA's ``erf_inv`` round a normal one float32
step apart on some draws, which can flip a ray at the rocking curve or a
pixel boundary (measured: one crystal ray on the gaussian cone, none
elsewhere).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _spectrometer_config
from tests.test_fused_grad import _variant_config
from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops import fused_grad as FG
from xicsrt_tpu.ops import spread as jspread
from xicsrt_tpu.ops import voigt as jvoigt
from xicsrt_tpu.ops.fused_trace import build_fused_run as jax_build_fused_run
from xicsrt_tpu_torch import make_fused_differentiable, params_from_jax, raytrace
from xicsrt_tpu_torch.draws import ExplicitDraws
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.engine import build_runner
from xicsrt_tpu_torch.ops import fused_grad as fg
from xicsrt_tpu_torch.ops import fused_trace as ft
from xicsrt_tpu_torch.ops import spread as tspread
from xicsrt_tpu_torch.ops import voigt as tvoigt

N = 2048
TOL_NORMALS = 2


def _np(x):
    return np.asarray(x)


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _u(key, n=N):
    return _np(jax.random.uniform(key, (n,), dtype=jnp.float32))


# ---------------------------------------------------------------------------
# Samplers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spread", [math.radians(8.0), math.radians(40.0)])
def test_flat(spread):
    key = jax.random.key(21)
    ref = _np(jspread.sample_flat(key, N, spread, dtype=jnp.float32))
    kr, kphi = jax.random.split(key)
    out = tspread.sample_flat(torch.tensor(_u(kr)), torch.tensor(_u(kphi)), spread)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("spread", [math.radians(6.0),
                                    [math.radians(6.0), math.radians(9.0)],
                                    [-0.05, 0.12, -0.03, 0.08]])
def test_flat_xy(spread):
    key = jax.random.key(22)
    ref = _np(jspread.sample_flat_xy(key, N, spread, dtype=jnp.float32))
    kx, ky = jax.random.split(key)
    out = tspread.sample_flat_xy(torch.tensor(_u(kx)), torch.tensor(_u(ky)), spread)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_flat_gaussian():
    key, spread = jax.random.key(23), math.radians(4.0)
    ref = _np(jspread.sample_flat_gaussian(key, N, spread, dtype=jnp.float32))
    g = _np(jax.random.normal(key, (N, 2), dtype=jnp.float32))
    for name in ("gaussian", "flat_gaussian"):
        out = tspread.sample_direction(torch.tensor(g[:, 0]), torch.tensor(g[:, 1]),
                                       spread, name)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("gamma,sigma", [(1e-4, 2e-4), (0.0, 3e-4), (2e-4, 0.0)])
def test_voigt_table_and_sampler(gamma, sigma):
    x, cdf = tvoigt.voigt_cdf_table(gamma, sigma)
    jx, jcdf = jvoigt.voigt_cdf_table(gamma, sigma)
    np.testing.assert_allclose(x, jx, rtol=1e-15, atol=0)
    np.testing.assert_allclose(cdf, jcdf, rtol=1e-15, atol=0)
    key = jax.random.key(24)
    x32, cdf32 = jnp.asarray(jx, jnp.float32), jnp.asarray(jcdf, jnp.float32)
    ref = _np(jvoigt.sample_voigt_tabulated(key, N, x32, cdf32))
    out = tvoigt.sample_voigt_tabulated(torch.tensor(_u(key)), torch.tensor(_np(x32)),
                                        torch.tensor(_np(cdf32)))
    # The wavelengths' tolerance: XLA may fuse the uniform's multiply-add,
    # and one ulp of u on a flat stretch of the CDF moves the offset by up
    # to ~2e-8 A, a tenth of a float32 step of the wavelength.
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=5e-7)


# ---------------------------------------------------------------------------
# Sources.
# ---------------------------------------------------------------------------

def _source_case(name):
    """The flagship chain's source changed to one corner of the matrix."""
    cfg = _spectrometer_config(intensity=N)
    src = cfg["sources"]["source"]
    if name == "generic_point_isotropic":
        src.update(class_name="XicsrtSourceGeneric", angular_dist="isotropic",
                   spread=math.radians(12.0))
    elif name == "directed_box_voigt":
        src.update(xsize=0.01, ysize=0.01, zsize=0.005, wavelength_dist="voigt",
                   linewidth=1e12, temperature=500.0, mass_number=40.0)
    elif name == "gaussian_box_uniform_velocity":
        src.update(spatial_dist="gaussian", xsize=0.01, ysize=0.01, zsize=0.0,
                   wavelength_dist="uniform", wavelength_range=[3.94, 3.96],
                   velocity=[0.0, 0.0, 1e5])
    elif name == "focused_box":
        src.pop("angular_dist")
        src.update(class_name="XicsrtSourceFocused", target=[0.0, 0.0, 0.80374151],
                   xsize=0.02, ysize=0.02, spread=math.radians(8.0))
    elif name == "focused_gaussian_voigt_velocity":
        src.update(class_name="XicsrtSourceFocused", target=[0.0, -3e-4, 0.80374151],
                   spatial_dist="gaussian", xsize=0.004, ysize=0.004, zsize=0.002,
                   angular_dist="isotropic", spread=math.radians(9.0),
                   wavelength_dist="voigt", linewidth=1e12, temperature=1000.0,
                   mass_number=40.0, velocity=[0.0, 1e5, 0.0])
    elif name in ("flat", "flat_xy", "gaussian"):
        spreads = {"flat": math.radians(8.0),
                   "flat_xy": [math.radians(6.0), math.radians(9.0)],
                   "gaussian": math.radians(4.0)}
        src.update(angular_dist=name, spread=spreads[name], xsize=0.01)
    elif name == "isotropic_xy_asym":
        src.update(spread=[-math.radians(4.0), math.radians(9.0),
                           -math.radians(5.0), math.radians(8.0)])
    elif name == "monochrome_poisson":
        src.update(wavelength_dist="monochrome", use_poisson=True, intensity=N - 200)
    return cfg


SOURCE_CASES = ["generic_point_isotropic", "directed_box_voigt",
                "gaussian_box_uniform_velocity", "focused_box",
                "focused_gaussian_voigt_velocity", "flat", "flat_xy", "gaussian",
                "isotropic_xy_asym", "monochrome_poisson"]


def jax_source_rows(source, key):
    """The rows JAX's generic ``generate`` draws from ``key``
    (``generic.py:266-271``), in the port's draw order, and its Poisson
    count: box offsets (3 columns), the cone's two rows, the wavelength's
    uniform."""
    p, n = source.param, source.num_rays
    k_origin, k_dir, k_wave, k_mask = jax.random.split(key, 4)
    rows, counts = [], []
    if any(float(p[k] or 0.0) for k in ("xsize", "ysize", "zsize")):
        if str(p["spatial_dist"]).lower() == "gaussian":
            box = jax.random.normal(k_origin, (n, 3), dtype=jnp.float32)
        else:
            box = jax.random.uniform(k_origin, (n, 3), dtype=jnp.float32)
        rows += [_np(box)[:, i] for i in range(3)]
    angular = str(p["angular_dist"]).lower()
    if angular in ("gaussian", "flat_gaussian"):
        g = _np(jax.random.normal(k_dir, (n, 2), dtype=jnp.float32))
        rows += [g[:, 0], g[:, 1]]
    else:
        ka, kb = jax.random.split(k_dir)
        rows += [_u(ka, n), _u(kb, n)]
    wtype = str(p["wavelength_dist"]).lower()
    if wtype == "uniform" or (wtype == "voigt" and source.voigt_table is not None):
        rows.append(_u(k_wave, n))
    if p["use_poisson"]:
        counts.append(int(jax.random.poisson(k_mask, source._scaled_intensity)))
    return rows, counts


def assert_rays_match(rays, ref):
    mask = rays.mask.numpy()
    np.testing.assert_array_equal(mask, ref.mask)
    np.testing.assert_allclose(rays.origin.numpy(), ref.origin, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rays.direction.numpy(), ref.direction, rtol=0, atol=1e-5)
    np.testing.assert_allclose(rays.wavelength.numpy(), ref.wavelength, rtol=0, atol=5e-7)


@pytest.mark.parametrize("name", SOURCE_CASES)
def test_generate_matches_jax(name):
    cfg = _source_case(name)
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    assert tp.num_rays == jp.num_rays
    key = jax.random.key(31)
    ref = _tree(jp.generate(jp.params["sources"]["source"], jp.params["filters"], key))
    params = params_from_jax(_tree(jp.params), device="cpu")
    rows, counts = jax_source_rows(jp.source, key)
    rays = tp.source.generate(params["sources"]["source"], ExplicitDraws(rows, counts),
                              params["filters"])
    assert rays.dtype == torch.float32
    assert_rays_match(rays, ref)
    if "voigt" in name:  # a real line: the offsets spread
        assert ref.wavelength.std() > 1e-5
    if "velocity" in name:
        assert not np.allclose(ref.wavelength, np.round(ref.wavelength, 3))


# ---------------------------------------------------------------------------
# K1b: the fused kernel's twin against the JAX megakernel.
# ---------------------------------------------------------------------------

def fused_case(name, n):
    """``tests/test_fused_engine.py``'s widened-subset sources on its chain
    (:403-470, :944, :977)."""
    cfg = _spectrometer_config(intensity=n, engine="fused")
    src = cfg["sources"]["source"]
    if name == "box_voigt":
        src.update(xsize=0.01, ysize=0.01, zsize=0.005, wavelength_dist="voigt",
                   linewidth=1e12, temperature=500.0, mass_number=40.0)
        cfg["optics"]["crystal"]["rocking_fwhm"] = 200e-6
    elif name == "gaussian_uniform_velocity":
        src.update(spatial_dist="gaussian", xsize=0.01, ysize=0.01, zsize=0.0,
                   wavelength_dist="uniform", wavelength_range=[3.94, 3.96],
                   velocity=[0.0, 0.0, 1e5])
        cfg["optics"]["crystal"]["rocking_fwhm"] = 200e-6
    elif name == "focused":
        src.pop("angular_dist")
        src.update(class_name="XicsrtSourceFocused", target=[0.0, 0.0, 0.80374151],
                   xsize=0.02, ysize=0.02, zsize=0.0, spread=math.radians(8.0))
    elif name in ("flat", "flat_xy", "gaussian"):
        spreads = {"flat": math.radians(8.0),
                   "flat_xy": [math.radians(6.0), math.radians(9.0)],
                   "gaussian": math.radians(4.0)}
        src.update(angular_dist=name, spread=spreads[name])
    elif name == "isotropic_xy_asym":
        src.update(spread=[-math.radians(4.0), math.radians(9.0),
                           -math.radians(5.0), math.radians(8.0)])
    elif name == "sightline":
        src.update(xsize=0.06, ysize=0.06, zsize=0.0, filters=["sight"])
        cfg["filters"] = {"sight": {"class_name": "XicsrtBundleFilterSightline",
                                    "origin": [0.01, 0.0, 0.0], "zaxis": [0.0, 0.0, 1.0],
                                    "radius": 0.02}}
    return cfg


FUSED_CASES = ["box_voigt", "gaussian_uniform_velocity", "focused", "flat", "flat_xy",
               "gaussian", "isotropic_xy_asym", "sightline"]


def compare_with_megakernel(cfg, key, tol):
    """Counts and images of the twin and the interpreted JAX megakernel on
    the same uniforms, ``tol`` rays apart per element at most; returns
    (twin counts, JAX meta, the packed buffers)."""
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    params = params_from_jax(_tree(jp.params), device="cpu")
    src = ft._source_spec(tp.source, {f.name: f for f in tp.filters})
    optics = [ft._optic_spec(o) for o in tp.optics]
    fparams = ft.pack_params(src, optics, params, "cpu")
    n_total = tp.num_rays
    ref = _tree(jax_build_fused_run(jp, chunk=1024, interpret=True, rng="input")(key))
    n_chunks = -(-n_total // 1024)
    U = jax.random.uniform(key, (n_chunks, fparams.n_draws, 8, 128), dtype=jnp.float32)
    U = torch.tensor(_np(U)).permute(1, 0, 2, 3).reshape(fparams.n_draws, -1)
    counts, flat = ft.fused_run_cuda(fparams, n_total, n_total,
                                     uniforms=U[:, :n_total].contiguous())
    names = tp.element_names
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
        assert np.abs(img - ref["image"][o["name"]]).sum() <= 2 * tol
        assert img.sum() == int(counts[names.index(o["name"])])
    return counts, ref["meta"], fparams


@pytest.mark.parametrize("name", FUSED_CASES)
def test_k1b_twin_matches_jax_megakernel(name):
    normals = name in ("box_voigt", "gaussian_uniform_velocity", "gaussian")
    counts, meta, fparams = compare_with_megakernel(
        fused_case(name, N), jax.random.key(5), TOL_NORMALS if normals else 0)
    assert fparams.full_source
    assert int(meta["detector"]) > 0
    if name == "sightline":  # the filter cuts: a circle of r = 0.02 in a 0.06 box
        assert int(counts[0]) < 0.6 * N


@pytest.mark.parametrize("name", FUSED_CASES)
def test_every_engine_runs_the_source(name):
    """Each corner of the matrix runs through ``raytrace`` on 'xla',
    'fused' and 'auto' (which takes K1) with images summing to the counts,
    and through ``make_fused_differentiable``; a filtered source stays
    outside K5, as in JAX (``fused_grad.py:100-102``)."""
    for engine in ("xla", "fused", "auto"):
        cfg = fused_case(name, 1024)
        cfg["general"]["engine"] = engine
        if engine == "auto":
            runner, _ = build_runner(cfg, device="cpu")
            assert runner.__qualname__.startswith("build_fused_run")
        res = raytrace(cfg, device="cpu")
        meta = {k: v["num_out"] for k, v in res["total"]["meta"].items()}
        assert 0 < meta["source"] <= 1024
        for elem, img in res["total"]["image"].items():
            assert img.sum() == meta[elem]
    cfg = fused_case(name, 1024)
    cfg["general"].update(engine="xla", interact_mode="weight", image_mode="bilinear")
    if name == "sightline":
        with pytest.raises(fg.FusedGradUnsupported, match="filtered"):
            make_fused_differentiable(cfg, device="cpu")
        return
    forward, vjp, pack, pipe = make_fused_differentiable(cfg, device="cpu")
    pvec = pack(pipe.params)
    images = forward(pvec, 1)["image"]
    gvec = vjp(pvec, 1, images)
    assert all(torch.isfinite(v).all() for v in images.values())
    assert torch.isfinite(gvec).all() and gvec.abs().max() > 0


def test_k1b_point_source_keeps_the_cut():
    """The flagship's point source takes the kernels' point-source cut, and
    mono wavelengths keep the optics' constant Bragg angles."""
    tp = TorchPipeline(_spectrometer_config(intensity=N, engine="fused"), device="cpu")
    src = ft._source_spec(tp.source)
    fparams = ft.pack_params(src, [ft._optic_spec(o) for o in tp.optics], tp.params, "cpu")
    assert not fparams.full_source and not src["per_ray_wl"]
    assert int(fparams.ip[ft.H_PER_RAY_WL]) == 0


# ---------------------------------------------------------------------------
# K5e-generic: the gradient kernels' twins on the generic variants.
# ---------------------------------------------------------------------------

GRAD_CASES = ["plane_crystal_flat", "sphere_mirror_isotropic", "uniform_wavelength",
              "convex_sphere_flat_xy", "asym_xy_crystal", "focused_gaussian_voigt"]


@pytest.fixture(scope="module", params=GRAD_CASES)
def grad_pair(request):
    """The interpreted JAX K5 kernels and the port's twins on one variant,
    with JAX's uniforms in the port's ray order."""
    cfg = _variant_config(request.param)
    jp = JaxPipeline(cfg)
    jforward, jvjp, jpack, jspec = FG.build_fused_diff(jp, chunk=1024, interpret=True,
                                                       rng="input")
    tp = TorchPipeline(cfg, device="cpu")
    forward, vjp, pack, spec = fg.build_fused_diff(tp, rng="input", chunk=1024)
    params = params_from_jax(_tree(jp.params), device="cpu")
    key = jax.random.key(5)
    U = jax.random.uniform(key, (jspec["n_chunks"], jspec["n_draws"], 8, 128),
                           dtype=jnp.float32)
    U = torch.tensor(_np(U)).permute(1, 0, 2, 3).reshape(jspec["n_draws"], -1)
    assert spec["static"].n_draws == jspec["n_draws"]
    return {"name": request.param, "jforward": jforward, "jvjp": jvjp,
            "jpvec": jpack(jp.params), "key": key, "forward": forward, "vjp": vjp,
            "pvec": pack(params), "spec": spec,
            "U": U[:, :spec["n_total"]].contiguous()}


def _cotangents(spec, seed):
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=(nx, ny)).astype(np.float32)
            for name, nx, ny in spec["images"]}


def _flat(gs, spec, dtype):
    return torch.cat([torch.as_tensor(gs[n], dtype=dtype).reshape(-1)
                      for n, _, _ in spec["images"]])


def test_k5_generic_forward_matches_jax(grad_pair):
    p = grad_pair
    assert p["spec"]["static"].full_source
    np.testing.assert_array_equal(p["pvec"].numpy(), _np(p["jpvec"]))
    ref = _tree(p["jforward"](p["jpvec"], p["key"])["image"])
    out = p["forward"](p["pvec"], 0, uniforms=p["U"])["image"]
    for name, img in out.items():
        img = img.numpy()
        assert ref[name].sum() > 0
        np.testing.assert_allclose(img.sum(), ref[name].sum(), rtol=2e-4)
        np.testing.assert_allclose(img, ref[name], rtol=0,
                                   atol=1e-3 * np.abs(ref[name]).max())


def test_k5_generic_vjp_matches_jax_and_truth(grad_pair):
    p = grad_pair
    spec = p["spec"]
    gs = _cotangents(spec, 0)
    ref = _np(p["jvjp"](p["jpvec"], p["key"], gs))
    ours = p["vjp"](p["pvec"], 0, gs, uniforms=p["U"]).numpy()
    truth = fg.fused_grad_vjp_plain(spec["static"], p["pvec"].double(), spec["n_total"],
                                    spec["lam"], _flat(gs, spec, torch.float64),
                                    uniforms=p["U"]).numpy()
    scale = np.abs(truth).max()
    assert scale > 0
    if p["name"] == "uniform_wavelength":
        # Per-ray wavelengths across a 26 mA band: the crystal's origin-x
        # slot cancels to 1e-3 of the largest slot (-34.32 in float64), and
        # the two float32 sums land apart (the twin -33.13, JAX's kernel
        # -33.85); every other slot is inside the tight bound. Held to each
        # other at the JAX bound of test_fused_grad.py:250-259.
        np.testing.assert_allclose(ours, ref, rtol=2e-2, atol=5e-3 * scale)
    else:
        np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-5 * scale)
    np.testing.assert_allclose(ours, truth, rtol=2e-2, atol=5e-3 * scale)


def test_k5_generic_hand_adjoint_matches_autograd_float64(grad_pair):
    p = grad_pair
    spec = p["spec"]
    g = _flat(_cotangents(spec, 1), spec, torch.float64)
    pvec = p["pvec"].double().requires_grad_(True)
    images = fg.fused_grad_forward_plain(spec["static"], pvec, spec["n_total"],
                                         spec["lam"], uniforms=p["U"])
    (images * g).sum().backward()
    auto = pvec.grad.numpy()
    hand = fg.fused_grad_vjp_plain(spec["static"], pvec.detach(), spec["n_total"],
                                   spec["lam"], g, uniforms=p["U"]).numpy()
    scale = np.abs(auto).max()
    assert scale > 0
    np.testing.assert_allclose(hand, auto, rtol=1e-9, atol=1e-10 * scale)
