"""The port's engines end to end on the CPU.

- The eager engine on the example_01 geometry against the reference golden
  image (``tests/test_reference_parity.py``): efficiency and crystal
  acceptance within 5 sigma, superpixel chi2/ndof < 3, line centroid
  within 0.5 pixel.
- The verify recipe's efficiency, 4.187e-2 +- 2e-4 at 1e6 rays, within
  5 sigma.
- The eager engine and the fused engine's twin agree binomially.
- Entry-point contract: the device is explicit, 'fused' raises outside its
  subset, the package never imports JAX.
"""

import ast
import math
import os

import numpy as np
import pytest
import torch

import xicsrt_tpu_torch
from __graft_entry__ import _spectrometer_config
from xicsrt_tpu_torch.engine import build_runner
from xicsrt_tpu_torch.ops.fused_trace import FusedUnsupported

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "example01_reference_image.npz")
PACKAGE = os.path.dirname(xicsrt_tpu_torch.__file__)


def _example01(intensity=1e5, num_iter=10, pixel_size=0.004, **general):
    g = {"number_of_iter": num_iter, "random_seed": 7, "print_results": False,
         "keep_history": False}
    g.update(general)
    detector = {
        "class_name": "XicsrtOpticDetector",
        "origin": [0.0, 0.76871290, 0.56904832],
        "zaxis": [0.0, -0.95641806, 0.29200084],
        "xsize": 0.4, "ysize": 0.2,
    }
    if pixel_size is not None:
        detector["pixel_size"] = pixel_size
    return {
        "general": g,
        "sources": {"source": {
            "class_name": "XicsrtSourceDirected", "intensity": intensity,
            "wavelength": 3.9492, "spread": np.radians(10.0)}},
        "optics": {
            "crystal": {
                "class_name": "XicsrtOpticSphericalCrystal",
                "origin": [0.0, 0.0, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151],
                "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
                "crystal_spacing": 2.45676,
                "rocking_type": "gaussian", "rocking_fwhm": 48.070e-6},
            "detector": detector,
        },
    }


@pytest.fixture(scope="module")
def golden():
    data = np.load(GOLDEN)
    return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def eager_example01():
    return xicsrt_tpu_torch.raytrace(_example01(), device="cpu")


def _meta(result):
    return {k: v["num_out"] for k, v in result["total"]["meta"].items()}


def test_golden_efficiency_and_acceptance(golden, eager_example01):
    meta = _meta(eager_example01)
    n_gen, n_ref = meta["source"], float(golden["n_generated"])
    assert n_gen == 10**6
    for name in ("detector", "crystal"):
        ours = meta[name] / n_gen
        ref = float(golden[f"meta_{name}"]) / n_ref
        sigma = math.sqrt(ref / n_gen + ref / n_ref)
        assert abs(ours - ref) < 5 * sigma, (name, ours, ref)


def test_golden_image_distribution(golden, eager_example01):
    ref = golden["image"].astype(np.float64)
    img = eager_example01["total"]["image"]["detector"].astype(np.float64)
    assert img.shape == ref.shape
    assert img.sum() == _meta(eager_example01)["detector"]

    def superpixels(a):
        return a.reshape(10, 10, 5, 10).sum(axis=(1, 3))

    R, O = superpixels(ref), superpixels(img)
    O = O * (R.sum() / O.sum())
    keep = (R + O) > 50
    chi2 = ((O[keep] - R[keep]) ** 2 / (R[keep] + O[keep])).sum()
    assert chi2 / keep.sum() < 3.0, chi2 / keep.sum()

    ys = np.arange(ref.shape[1])

    def centroid(p):
        p = p.sum(axis=0)
        return (p * ys).sum() / p.sum()

    assert abs(centroid(img) - centroid(ref)) < 0.5


def test_verify_recipe_efficiency():
    """The verify recipe's geometry (default pixel size); the CPU reference
    measures 4.187e-2 +- 2e-4 at 1e6 rays."""
    res = xicsrt_tpu_torch.raytrace(
        _example01(intensity=2.5e5, num_iter=4, pixel_size=None, random_seed=0),
        device="cpu")
    meta = _meta(res)
    eff = meta["detector"] / meta["source"]
    sigma = math.sqrt(0.04187 * (1 - 0.04187) / meta["source"] + 2e-4**2)
    assert abs(eff - 0.04187) < 5 * sigma, eff


def _binomial_agree(a, b, n_sigma=5.0):
    p1, n1 = a["detector"] / a["source"], a["source"]
    p2, n2 = b["detector"] / b["source"], b["source"]
    p = (a["detector"] + b["detector"]) / (n1 + n2)
    sigma = math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    return abs(p1 - p2) < n_sigma * sigma


def test_eager_and_fused_twin_agree():
    """Different random streams, same physics: binomial agreement within
    5 sigma, and each image sums to its element's count."""
    results = {}
    for engine, binning in (("xla", "xla"), ("fused", "xla"), ("xla", "pallas")):
        res = xicsrt_tpu_torch.raytrace(
            _spectrometer_config(intensity=2**17, num_iter=2, engine=engine,
                                 binning=binning), device="cpu")
        meta = _meta(res)
        assert meta["source"] == 2**18
        for name, img in res["total"]["image"].items():
            assert img.sum() == meta[name]
        results[(engine, binning)] = meta
    assert _binomial_agree(results[("xla", "xla")], results[("fused", "xla")])
    # The same eager stream binned two ways: identical counts.
    assert results[("xla", "xla")] == results[("xla", "pallas")]


def test_engine_selection():
    cfg = _spectrometer_config(intensity=4096, engine="fused")
    cfg["sources"]["source"]["xsize"] = 0.01  # extended: inside since K1b
    runner, _ = build_runner(cfg, device="cpu")
    assert runner.__qualname__.startswith("build_fused_run")
    cfg["general"]["dtype"] = "float64"  # outside the fused subset
    with pytest.raises(FusedUnsupported):
        xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    cfg["general"]["engine"] = "auto"
    res = xicsrt_tpu_torch.raytrace(cfg, device="cpu")  # falls back to eager
    assert _meta(res)["source"] == 4096
    cfg = _spectrometer_config(intensity=4096, engine="fused", keep_history=True)
    with pytest.raises(NotImplementedError):
        xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    cfg["general"]["keep_history"] = "found"  # the reservoir K1e (its twin here)
    res = xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    assert 0 < len(res["found"]["history"]["detector"]["origin"]) <= 8 * 8192
    cfg["general"]["dtype"] = "float64"
    with pytest.raises(FusedUnsupported):
        xicsrt_tpu_torch.raytrace(cfg, device="cpu")


def test_history_runs_and_seeds():
    cfg = _spectrometer_config(intensity=3000, num_iter=2, keep_history=True,
                               number_of_runs=2, history_max_lost=100)
    res = xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    meta = _meta(res)
    assert meta["source"] == 12000
    found = res["found"]["history"]
    assert list(found) == ["source", "aperture", "crystal", "detector"]
    assert res["found"]["meta"]["detector"]["num_out"] == meta["detector"]
    assert len(found["detector"]["origin"]) == meta["detector"]
    assert res["lost"]["meta"]["source"]["num_out"] == 200  # 100 per run
    again = xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    assert _meta(again) == meta  # random_seed fixes every run


def test_device_is_explicit(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        xicsrt_tpu_torch.raytrace(_spectrometer_config(intensity=100))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        xicsrt_tpu_torch.Pipeline(_spectrometer_config(intensity=100))


def test_elements_default_to_cuda(monkeypatch):
    """``dispatch.instantiate``, ``dispatch.build_section`` and an element
    built by its class take CUDA when no device is given, and raise without
    it, as ``raytrace`` does; ``device='cpu'`` builds them on the CPU."""
    from xicsrt_tpu_torch import dispatch

    config = _spectrometer_config(intensity=100)
    detector = config["optics"]["detector"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dispatch.instantiate("detector", detector, config["general"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dispatch.build_section(config, "optics")
    cls = dispatch.lookup(detector["class_name"])
    cfg = {k: v for k, v in detector.items() if k != "class_name"}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(cfg, name="detector", general=config["general"])
    on_cpu = dispatch.build_section(config, "optics", device="cpu")
    assert [o.device.type for o in on_cpu] == ["cpu"] * len(config["optics"])


def test_params_from_jax_defaults_to_cuda(monkeypatch):
    """``params_from_jax`` puts the converted tree on CUDA when no device is
    given and raises without it, as every entry point of the port does;
    ``device='cpu'`` converts on the CPU."""
    tree = {"crystal": {"radius": np.float32(1.0), "origin": np.zeros(3, np.float32)}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        xicsrt_tpu_torch.params_from_jax(tree)
    on_cpu = xicsrt_tpu_torch.params_from_jax(tree, device="cpu")
    assert on_cpu["crystal"]["origin"].device.type == "cpu"
    assert float(on_cpu["crystal"]["radius"]) == 1.0


def test_frame_from_config_defaults_to_cuda(monkeypatch):
    """``geometry.frame_from_config`` takes CUDA when no device is given and
    raises without it, naming ``device='cpu'``, as every entry point of the
    port does; ``device='cpu'`` builds the frame on the CPU, equal to JAX's
    ``frame_from_config`` of the same entries."""
    from xicsrt_tpu import geometry as jgeometry
    from xicsrt_tpu_torch import geometry

    origin, zaxis, xaxis = [0.0, 0.76871290, 0.56904832], [0.0, -0.95641806, 0.29200084], None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available; pass device='cpu'"):
        geometry.frame_from_config(origin, zaxis, xaxis)
    frame = geometry.frame_from_config(origin, zaxis, xaxis, device="cpu")
    ref = jgeometry.frame_from_config(origin, zaxis, xaxis)
    assert frame.origin.device.type == frame.basis.device.type == "cpu"
    assert frame.origin.dtype == frame.basis.dtype == torch.float32
    np.testing.assert_array_equal(frame.origin.numpy(), np.asarray(ref.origin))
    np.testing.assert_array_equal(frame.basis.numpy(), np.asarray(ref.basis))


@pytest.mark.parametrize("aim", [[0.0, 0.59497864, -0.80374151], [1.0, -2.0, 0.5]])
def test_aim_zaxis_matches_jax(aim):
    """``geometry.aim_zaxis`` (the unit vector from an origin towards an aim
    point, float64 on the host) equals JAX's bit for bit."""
    from xicsrt_tpu import geometry as jgeometry
    from xicsrt_tpu_torch import geometry

    origin = [0.0, 0.0, 0.80374151]
    z = geometry.aim_zaxis(origin, aim)
    assert z.dtype == np.float64
    np.testing.assert_array_equal(z, jgeometry.aim_zaxis(origin, aim))
    assert abs(np.linalg.norm(z) - 1.0) < 1e-15


def test_zero_rays_matches_jax_and_defaults_to_cuda(monkeypatch):
    """``rays.zero_rays(n, dtype, device)``: an all-dead bundle equal to
    JAX's ``zero_rays`` field by field (weights 1, masks False), on CUDA
    unless the caller asks for the CPU, raising without CUDA as every entry
    point of the port does."""
    from xicsrt_tpu import rays as jrays
    from xicsrt_tpu_torch import rays

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available; pass device='cpu'"):
        rays.zero_rays(4)
    for dtype, jdtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        out = rays.zero_rays(5, dtype, device="cpu")
        ref = jrays.zero_rays(5, jdtype)
        assert out.n == 5 and out.dtype == dtype and out.device.type == "cpu"
        assert out.mask.dtype == torch.bool and int(out.num_alive()) == 0
        for name, value in out.to_dict().items():
            np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(ref, name)))


def test_io_not_ported_raises(tmp_path):
    """IO is ported (``tests/test_torch_io_cli.py``); what raises is an
    output path that does not exist without ``make_directories``, as in
    JAX. With it, the per-run and combined images appear."""
    out = str(tmp_path / "missing")
    cfg = _spectrometer_config(intensity=100, save_images=True, output_path=out)
    with pytest.raises(FileNotFoundError):
        xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    cfg["general"]["make_directories"] = True
    xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    assert {"xicsrt_detector_0000.tif", "xicsrt_detector.tif"} <= set(os.listdir(out))


def _jax_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names
                      if a.name.split(".")[0] in ("jax", "xicsrt_tpu")]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module.split(".")[0] in ("jax", "xicsrt_tpu"):
                found.append(node.module)
    return found


def test_package_never_imports_jax():
    """Parsed, not imported: JAX is already loaded in this process."""
    files = [os.path.join(root, f) for root, _, names in os.walk(PACKAGE)
             for f in names if f.endswith(".py")]
    assert len(files) > 15
    offenders = {f: _jax_imports(f) for f in files}
    assert not {f: i for f, i in offenders.items() if i}
    chip_smoke = os.path.join(os.path.dirname(PACKAGE), "chip_smoke.py")
    assert not _jax_imports(chip_smoke)


def _example00_config(num_iter=2):
    """``examples/example_00_point_source.py``'s config, read with ``ast``
    (the script runs JAX), cut to ``num_iter`` iterations."""
    path = os.path.join(os.path.dirname(PACKAGE), "examples",
                        "example_00_point_source.py")
    namespace = {"np": np}
    for node in ast.parse(open(path).read(), filename=path).body:
        if isinstance(node, ast.Assign):
            base = node.targets[0]
            while isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Name) and base.id == "config":
                exec(compile(ast.Module(body=[node], type_ignores=[]), path, "exec"),
                     namespace)
    config = namespace["config"]
    config["general"]["number_of_iter"] = num_iter
    return config


def _ranks(tree):
    if isinstance(tree, dict):
        return {k: _ranks(v) for k, v in tree.items()}
    return np.ndim(tree)


def test_raytrace_mp_matches_jax_on_example00():
    """Both packages' ``raytrace_mp`` on example 00's config (2 iterations):
    the same result keys and array ranks, the detected counts within 5
    binomial sigma. JAX shards over its devices; the port runs one."""
    import xicsrt_tpu

    cfg = _example00_config()
    jr = xicsrt_tpu.raytrace_mp(cfg)
    tr = xicsrt_tpu_torch.raytrace_mp(cfg, device="cpu")
    assert set(tr) == set(jr)
    assert set(tr["total"]) == set(jr["total"])
    assert _ranks(tr["total"]["image"]) == _ranks(jr["total"]["image"])
    assert set(tr["found"]["history"]) == set(jr["found"]["history"])
    assert (_ranks(tr["found"]["history"]["detector"])
            == _ranks(jr["found"]["history"]["detector"]))
    jm, tm = _meta(jr), _meta(tr)
    assert set(tm) == set(jm)
    assert tm["source"] == jm["source"] == 2 * 10000
    p = jm["detector"] / jm["source"]
    sigma = math.sqrt(2 * jm["source"] * p * (1 - p))
    assert abs(tm["detector"] - jm["detector"]) <= 5 * sigma
    assert tr["total"]["image"]["detector"].sum() == tm["detector"]
    # Every ray of the 5 degree cone lands, so compare where: the mean
    # distance from the detector's centre within 5 standard errors.
    radii = [np.linalg.norm(np.asarray(r["found"]["history"]["detector"]["origin"])[:, :2],
                            axis=1) for r in (jr, tr)]
    se = math.sqrt(radii[0].var() / len(radii[0]) + radii[1].var() / len(radii[1]))
    assert abs(radii[0].mean() - radii[1].mean()) < 5 * se


def test_raytrace_mp_is_raytrace_on_one_device():
    cfg = _example00_config()
    assert (_meta(xicsrt_tpu_torch.raytrace_mp(cfg, device="cpu"))
            == _meta(xicsrt_tpu_torch.raytrace(cfg, device="cpu")))
    assert (_meta(xicsrt_tpu_torch.raytrace_mp(cfg, processes=1, device="cpu"))
            == _meta(xicsrt_tpu_torch.raytrace(cfg, device="cpu")))


def test_raytrace_mp_over_two_devices_raises(monkeypatch):
    """Over two shards it no longer raises: ``processes=2`` on the CPU is
    the ray-sharded run over two shards there (``parallel/mesh.py``), each
    tracing half of example 00's rays from a stream of its own: the same
    generated total as ``raytrace``, the detector within 5 binomial sigma,
    and other rays. On ``'cuda'`` it is cut to the CUDA devices there are,
    as JAX cuts it, and one device is exactly ``raytrace``."""
    cfg = _example00_config()
    one = xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    two = xicsrt_tpu_torch.raytrace_mp(cfg, processes=2, device="cpu")
    m1, m2 = _meta(one), _meta(two)
    assert m2["source"] == m1["source"] == 2 * 10000
    p = m1["detector"] / m1["source"]
    assert abs(m2["detector"] - m1["detector"]) <= 5 * math.sqrt(2 * m1["source"] * p * (1 - p))
    assert two["total"]["image"]["detector"].sum() == m2["detector"]
    assert not np.array_equal(two["found"]["history"]["detector"]["origin"][:100],
                              one["found"]["history"]["detector"]["origin"][:100])
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(xicsrt_tpu_torch.engine, "raytrace",
                        lambda config, device: calls.append((config, device)))
    xicsrt_tpu_torch.raytrace_mp(cfg, processes=2, device="cuda")
    assert calls == [(cfg, torch.device("cuda"))]


def test_registry_names_match_jax():
    """The sorted registry keys; the package's own elements are JAX's (a
    test run may have registered plugin elements in either registry)."""
    from xicsrt_tpu import dispatch as jax_dispatch
    from xicsrt_tpu_torch import dispatch

    def own(module, names, package):
        return [n for n in names
                if module._REGISTRY[n].__module__.split(".")[0] == package]

    names = dispatch.registry_names()
    assert names == sorted(dispatch._REGISTRY)
    ours = own(dispatch, names, "xicsrt_tpu_torch")
    assert len(ours) > 20
    assert ours == own(jax_dispatch, jax_dispatch.registry_names(), "xicsrt_tpu")
