"""Mosaic crystals on every engine of the port against the JAX package.

- The eager engine (``optics/interactions.InteractMosaicCrystal``) against
  JAX's XLA engine on ``tests/test_physics_extra.py``'s mosaic spectrometer
  (depth 15, 0.5 deg spread): in mc mode the crystal's and detector's
  counts within 5 binomial sigma; in weight mode the weighted detector sums
  within 5 sqrt(sf + sx). The two draw their own random numbers, so the
  comparison is statistical. (A weight-mode ray whose every layer's
  probability underflows keeps its direction; XLA flushes float32
  denormals to zero and PyTorch on the CPU does not, so weight-mode counts
  past the crystal may differ by a few per cent, the weights by nothing
  measurable: only the sums are compared.)
- The physics checks of ``tests/test_physics_extra.py:52-135`` on the
  port: depth raises the throughput in both modes, the mosaic widens the
  crystal's accepting stripe, a 6-sigma cutoff keeps the reflections, and
  weight mode reproduces mc mode's detected flux.
- The reference's golden (``tests/golden/mosaic_reference_image.npz``) with
  the checks and bounds of ``tests/test_reference_parity_families.py``, on
  the eager engine, as the JAX test runs it.
- K1c-mosaic: the twins of K1 and K3 against JAX's interpreted kernels on
  the same uniforms (``tests/test_torch_mirror.py``'s helpers), in mc and
  weight mode, with a cutoff, with a file rocking curve
  (``tests/test_fused_engine.py:957-975``) and on a mesh (the Chebyshev
  surrogate): counts at most ``TOL_RAYS`` apart per element, images as
  ``tests/test_torch_weight_images.py`` bounds them. Both run with float32
  denormals flushed to zero, as XLA's CPU backend does: a weight-mode
  layer's pick depends on whether a probability below the normal range is
  zero.
- ``engine='auto'`` takes the fused engine for the planar, spherical and
  mesh mosaic crystals in both modes.
"""

import copy

import numpy as np
import pytest
import torch

import xicsrt_tpu
import xicsrt_tpu_torch
from tests import test_fused_engine as jax_fused_tests
from tests import test_reference_parity_families as families
from tests.test_physics_extra import _mosaic_config
from tests.test_torch_mirror import k1_twin_against_jax, k3_twin_against_jax
from tests.test_torch_weight_images import image_tolerance
from xicsrt_tpu_torch.dispatch import lookup
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.engine import build_runner
from xicsrt_tpu_torch.optics.interactions import InteractMosaicCrystal


@pytest.fixture
def flush_denormal():
    """Float32 denormals flushed to zero, as XLA's CPU backend does."""
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _metas(res):
    return {k: v["num_out"] for k, v in res["total"]["meta"].items()}


def _binomial_close(k1, k2, n):
    p = (k1 + k2) / (2.0 * n)
    return abs(k1 - k2) < 5.0 * np.sqrt(max(2.0 * n * p * (1.0 - p), 1.0))


@pytest.mark.parametrize("names", [
    ("XicsrtOpticPlanarMosaicCrystal", "planar_mosaic_crystal"),
    ("XicsrtOpticSphericalMosaicCrystal", "spherical_mosaic_crystal"),
    ("XicsrtOpticMeshMosaicCrystal", "mesh_mosaic_crystal"),
])
def test_mosaic_composites_are_registered(names):
    """The three composites of JAX ``optics/composites.py:54-55, 77-78,
    118-119``, under both names, with the mosaic defaults."""
    cls = lookup(names[0])
    assert lookup(names[1]) is cls and issubclass(cls, InteractMosaicCrystal)
    defaults = cls.__new__(cls).default_config()
    assert (defaults["mosaic_spread"], defaults["mosaic_depth"], defaults["mosaic_cutoff"]) \
        == (0.0, 15, None)


@pytest.mark.parametrize("mode", ["mc", "weight"])
def test_eager_mosaic_matches_jax_xla_engine(mode):
    cfg = _mosaic_config(depth=15, interact_mode=mode, keep_history=False)
    ours = xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    ref = xicsrt_tpu.raytrace(cfg)
    mo, mr = _metas(ours), _metas(ref)
    n = mo["source"]
    assert n == mr["source"] == 30000
    if mode == "mc":
        for name in ("crystal", "detector"):
            assert _binomial_close(mo[name], mr[name], n), (name, mo, mr)
        assert mo["detector"] > 1000
        return
    sf = float(ours["total"]["image"]["detector"].sum())
    sx = float(ref["total"]["image"]["detector"].sum())
    assert sf > 1000 and abs(sf - sx) < 5.0 * np.sqrt(sf + sx), (sf, sx)


def _run(cfg):
    return xicsrt_tpu_torch.raytrace(cfg, device="cpu")


@pytest.mark.parametrize("mode", ["mc", "weight"])
def test_depth_increases_throughput(mode):
    """``tests/test_physics_extra.py:53-62`` and :127-137: 15 layers
    reflect more than twice what one does, in both modes."""
    def reflected(depth):
        res = _run(_mosaic_config(depth=depth, interact_mode=mode, keep_history=False))
        if mode == "mc":
            return res["total"]["meta"]["crystal"]["num_out"]
        return float(res["total"]["image"]["detector"].sum())

    shallow, deep = reflected(1), reflected(15)
    assert deep > 2 * shallow > 0


def test_mosaic_widens_angular_acceptance():
    """``tests/test_physics_extra.py:64-86``: the mosaic reflects from a
    stripe of the crystal more than three times as wide as a perfect
    crystal's."""
    from xicsrt_tpu_torch.public import get_element

    def stripe_width(cfg):
        res = _run(cfg)
        hits = torch.as_tensor(res["found"]["history"]["crystal"]["origin"])
        element = get_element(res["config"], "crystal", device="cpu")
        return float(element.frame.point_to_local(hits.to(element.frame.origin.dtype))[:, 1].std())

    perfect = _mosaic_config(depth=15)
    perfect["optics"]["crystal"]["class_name"] = "XicsrtOpticSphericalCrystal"
    for key in ("mosaic_spread", "mosaic_depth"):
        del perfect["optics"]["crystal"][key]
    assert stripe_width(_mosaic_config(depth=15)) > 3 * stripe_width(perfect)


def test_cutoff_keeps_the_reflections_and_weight_mode_the_flux():
    """``tests/test_physics_extra.py:88-125``: a cutoff of 1e-8 (6.1 sigma)
    keeps the reflections; weight mode's detected flux is mc mode's count
    within 6 sqrt(N)."""
    full = _run(_mosaic_config(depth=15, num_iter=2, keep_history=False))
    cut = _mosaic_config(depth=15, num_iter=2, keep_history=False)
    cut["optics"]["crystal"]["mosaic_cutoff"] = 1e-8
    n_full = full["total"]["meta"]["crystal"]["num_out"]
    n_cut = _run(cut)["total"]["meta"]["crystal"]["num_out"]
    assert abs(n_cut - n_full) < 5 * np.sqrt(max(n_full, 1)) + 20
    weighted = _run(_mosaic_config(depth=15, num_iter=2, interact_mode="weight",
                                   keep_history=False))
    w_total = float(weighted["total"]["image"]["detector"].sum())
    n_mc = full["total"]["meta"]["detector"]["num_out"]
    assert abs(w_total - n_mc) < 6 * np.sqrt(max(n_mc, 1)), (w_total, n_mc)


def test_mosaic_golden():
    """The reference's ``mosaic`` golden with the four checks of
    ``tests/test_reference_parity_families.py:121-187`` (acceptance and
    efficiency within 5 sigma, superpixel chi2/ndof < 3, centroid within
    0.75 px, line width within its WIDTH_RTOL of 0.15) on the eager engine,
    as the JAX test runs it. The fused engine is held to the eager one
    (``test_auto_takes_the_fused_engine``) and, on the card, to the golden
    (``chip_smoke.py``): on the CPU its twin's chi2/ndof over the golden's
    4 superpixels read 3.26, 0.52, 0.95 and 0.18 at random_seed 11-14
    (the eager engine's 0.30, 0.28, 1.49, 0.14), the spread of a chi2 of 4
    degrees of freedom, of which 1 % lies above 3."""
    golden = families._load_golden("mosaic")
    cfg = families._config(families.CRYSTALS["mosaic"], num_iter=5)
    scenario = ("mosaic", golden, _run(cfg))
    checks = families.TestFamilyParity()
    checks.test_crystal_acceptance(scenario)
    checks.test_efficiency(scenario)
    checks.test_image_distribution_superpixels(scenario)
    checks.test_line_position_and_width(scenario)


def _mosaic_spectrometer(n, depth=6, **general):
    """``tests/test_fused_engine.py``'s spectrometer with the mosaic crystal
    of its ``test_mosaic_weight_mode`` (:995-1003)."""
    cfg = jax_fused_tests._spectrometer(n, **general)
    cfg["optics"]["crystal"].update(
        class_name="XicsrtOpticSphericalMosaicCrystal", rocking_fwhm=150e-6,
        mosaic_spread=np.radians(0.05), mosaic_depth=depth)
    return cfg


def _mesh_mosaic(n, **general):
    """A mesh mosaic crystal: the 41 x 41 sphere mesh of
    ``tests/test_fused_engine.py:797`` as explicit local points, faces and
    normals under the mosaic crystal of :995-1003."""
    mesh = jax_fused_tests.TestMeshSurrogate._mesh_config(
        None, n, "XicsrtOpticMeshSphericalCrystal", radius=1.0, mesh_size=(41, 41),
        mesh_coarse_size=(11, 11))
    sphere = TorchPipeline(mesh, device="cpu").optics[0].param
    crystal = mesh["optics"]["crystal"]
    for key in ("radius", "mesh_size", "mesh_coarse_size"):
        crystal.pop(key)
    crystal.update(class_name="XicsrtOpticMeshMosaicCrystal", rocking_fwhm=150e-6,
                   mosaic_spread=np.radians(0.05), mosaic_depth=6,
                   mesh_points=np.asarray(sphere["mesh_points"]),
                   mesh_faces=np.asarray(sphere["mesh_faces"]),
                   mesh_normals=np.asarray(sphere["mesh_normals"]),
                   mesh_interpolate=True, trace_local=sphere["trace_local"])
    mesh["general"].update(general)
    return mesh


def _chain(case, tmp_path):
    general = {"interact_mode": "weight"} if "weight" in case else {}
    if case.startswith("mesh"):
        return _mesh_mosaic(8192, **general)
    cfg = _mosaic_spectrometer(8192, depth=8 if "file" in case else 6, **general)
    crystal = cfg["optics"]["crystal"]
    if "cutoff" in case:
        crystal["mosaic_cutoff"] = 1e-4
    if "file" in case:  # tests/test_fused_engine.py:957-975
        from tests.test_coverage_extra import _write_xop_file

        xop = tmp_path / "diff_pat.dat"
        _write_xop_file(str(xop), fwhm=150e-6)
        crystal.update(rocking_type="file", rocking_fwhm=None, rocking_file=str(xop),
                       rocking_filetype="xop", rocking_mix=0.6)
    if "bilinear" in case:
        cfg["general"]["image_mode"] = "bilinear"
    return cfg


@pytest.mark.parametrize("case", ["mc", "weight", "cutoff_mc", "cutoff_weight", "file_mc",
                                  "file_weight", "weight_bilinear", "mesh_mc",
                                  "mesh_weight"])
def test_k1_mosaic_twin_matches_jax_megakernel(case, tmp_path, flush_denormal):
    cfg = _chain(case, tmp_path)
    counts, ref, fparams = k1_twin_against_jax(
        cfg, seed=81, image_tol=image_tolerance(cfg["general"]))
    assert fparams.stages == 2 and fparams.cheb == case.startswith("mesh")
    depth = cfg["optics"]["crystal"]["mosaic_depth"]
    assert fparams.n_draws == 2 + 3 * depth  # the cone, then three a layer
    assert int(counts[-1]) > 20


@pytest.mark.parametrize("case", ["mc", "weight"])
def test_k3_mosaic_twin_matches_jax_trace_only(case, tmp_path, flush_denormal):
    cfg = _chain(case, tmp_path)
    counts, _, fparams = k3_twin_against_jax(cfg, seed=83,
                                             image_tol=image_tolerance(cfg["general"]))
    assert fparams.n_draws == 3 * 6 and int(counts[-1]) > 20


@pytest.mark.parametrize("mode", ["mc", "weight"])
def test_auto_takes_the_fused_engine(mode):
    """``engine='auto'`` builds K1 for the planar, spherical and mesh
    mosaic crystals; the spherical one's fused counts (mc) or weighted
    sums agree with the eager engine's."""
    planar = _mosaic_spectrometer(1024, interact_mode=mode, engine="auto")
    planar["optics"]["crystal"]["class_name"] = "XicsrtOpticPlanarMosaicCrystal"
    del planar["optics"]["crystal"]["radius"]
    for cfg in (planar, _mesh_mosaic(1024, interact_mode=mode, engine="auto")):
        runner, _ = build_runner(cfg, device="cpu")
        assert runner.__qualname__.startswith("build_fused_run")
    n = 1 << 15
    out = {}
    for engine in ("fused", "xla"):
        cfg = _mosaic_spectrometer(n, interact_mode=mode, engine=engine, random_seed=9)
        out[engine] = _run(copy.deepcopy(cfg))
    mf, mx = _metas(out["fused"]), _metas(out["xla"])
    if mode == "mc":
        for name in ("crystal", "detector"):
            assert _binomial_close(mf[name], mx[name], n), (name, mf, mx)
    sf, sx = (float(out[k]["total"]["image"]["detector"].sum()) for k in ("fused", "xla"))
    assert sf > 20 and abs(sf - sx) < 5.0 * np.sqrt(sf + sx), (sf, sx)


def test_eager_autograd_through_weight_mode_mosaic_matches_k5d():
    """``make_differentiable`` differentiates through the weight-mode mosaic
    (the reservoir picks hard edges, the weight carrying the gradient): on
    the uniforms K5d draws for ``tests/test_fused_grad.py``'s
    ``mosaic_sphere`` chain, handed to the eager engine in its draw order
    (the cone's u and v, then per layer two normals sqrt(2) erfinv(2u - 1)
    and the pick's u), ``torch.autograd`` of sum(g * images) at float64
    equals the K5d twin's hand adjoint at float64 on every slot of the
    crystal and the detector: rtol 1e-4, atol 1e-5 of the largest slot.
    The eager engine takes the Bragg angles by ``arcsin``, its pixel
    coordinates by true division and its constants in float64, K5 the sine
    difference, a float32 1/ps and float32 constants (3e-8 apart), which
    the 500 urad curve carries to up to 7e-5 of a slot and a slot whose
    per-ray terms cancel to 5e-6 of the largest (the crystal's bz_z: 1761.1
    against 1760.1 of 2.0e5)."""
    from tests.test_fused_grad import _variant_config
    from xicsrt_tpu_torch import make_differentiable, make_fused_differentiable
    from xicsrt_tpu_torch.draws import ExplicitDraws
    from xicsrt_tpu_torch.ops import fused_grad as fg

    n = 4096
    cfg = _variant_config("mosaic_sphere")
    cfg["sources"]["source"]["intensity"] = n
    _, _, pack, pipe = make_fused_differentiable(cfg, device="cpu")
    spec = fg.build_fused_diff(pipe)[3]
    static, depth = spec["static"], cfg["optics"]["crystal"]["mosaic_depth"]
    U = torch.tensor(np.random.default_rng(7).random((static.n_draws, n)), dtype=torch.float32)
    g = {name: torch.tensor(np.random.default_rng(8).normal(size=(nx, ny)))
         for name, nx, ny in spec["images"]}
    g_flat = torch.cat([g[name].reshape(-1) for name, _, _ in spec["images"]])
    hand = fg.fused_grad_vjp_plain(static, pack(pipe.params).double(), n, spec["lam"],
                                   g_flat, uniforms=U)

    def normal(u):
        return (np.sqrt(2.0) * torch.special.erfinv(
            2.0 * torch.clamp(u.double(), 1e-7, 1.0 - 1e-7) - 1.0)).numpy()

    rows = [U[0].double().numpy(), U[1].double().numpy()]
    for layer in range(depth):
        rows += [normal(U[2 + 3 * layer]), normal(U[3 + 3 * layer]),
                 U[4 + 3 * layer].double().numpy()]
    cfg["general"]["dtype"] = "float64"
    image_fn, pipe64 = make_differentiable(cfg, device="cpu")
    leaves, params = {}, dict(pipe64.params)
    params["optics"] = {}
    for name, po in pipe.params["optics"].items():
        po = dict(po)
        origin = po["frame"].origin.double().requires_grad_(True)
        basis = po["frame"].basis.double().requires_grad_(True)
        po["frame"] = type(po["frame"])(origin, basis)
        leaves[name] = {"origin": origin, "basis": basis}
        for key in ("radius", "crystal_spacing", "rocking_fwhm", "reflectivity"):
            if key in po:
                po[key] = po[key].double().requires_grad_(True)
                leaves[name][key] = po[key]
        params["optics"][name] = po
    images = image_fn(params, ExplicitDraws(rows))
    sum((images[name] * g[name]).sum() for name in images).backward()
    scale = float(hand.abs().max())
    assert scale > 0
    for i, name in enumerate(o.name for o in pipe.optics):
        b = i * fg.SLOTS_PER_OPTIC
        got = [leaves[name]["origin"].grad, leaves[name]["basis"].grad.reshape(-1)]
        want = [hand[b:b + 3], hand[b + 3:b + 12]]
        for k, key in enumerate(("radius", "crystal_spacing", "rocking_fwhm",
                                 "reflectivity")):
            if key in leaves[name]:
                got.append(leaves[name][key].grad.reshape(1))
                want.append(hand[b + 12 + k:b + 13 + k])
        torch.testing.assert_close(torch.cat(got), torch.cat(want), rtol=1e-4,
                                   atol=1e-5 * scale)
    crystal = [o.name for o in pipe.optics].index("crystal") * fg.SLOTS_PER_OPTIC
    assert abs(float(hand[crystal + 13])) > 1e-3 * scale  # d/d(crystal_spacing)
