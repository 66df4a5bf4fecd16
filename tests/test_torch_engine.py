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
    cfg["sources"]["source"]["xsize"] = 0.01  # extended: outside the subset
    with pytest.raises(FusedUnsupported):
        xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    cfg["general"]["engine"] = "auto"
    res = xicsrt_tpu_torch.raytrace(cfg, device="cpu")  # falls back to eager
    assert _meta(res)["source"] == 4096
    cfg = _spectrometer_config(intensity=4096, engine="fused", keep_history=True)
    with pytest.raises(NotImplementedError):
        xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    cfg["general"]["keep_history"] = "found"
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


def test_io_not_ported_raises():
    cfg = _spectrometer_config(intensity=100, save_images=True)
    with pytest.raises(NotImplementedError):
        xicsrt_tpu_torch.raytrace(cfg, device="cpu")


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
