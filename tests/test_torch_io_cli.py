"""The port's files and command line against the JAX package's
(``tests/test_visual_io.py``'s IO half): hdf5, zip, pickle and json
results, include/exclude filters, config round trips, TIF images, the
files of one package loaded by the other, saving through ``raytrace``,
``python -m xicsrt_tpu_torch`` (its ``run(argv)``, on the CPU here through
``raytrace(..., device='cpu')``), plugin element paths and docs."""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

import xicsrt_tpu
import xicsrt_tpu_torch
from xicsrt_tpu import io as jax_io
from xicsrt_tpu_torch import __main__ as cli
from xicsrt_tpu_torch import dispatch
from xicsrt_tpu_torch import io as xio


def _config(n=2000, **general):
    g = {"number_of_iter": 1, "random_seed": 0, "print_results": False}
    g.update(general)
    return {
        "general": g,
        "sources": {"source": {"class_name": "XicsrtSourceDirected", "intensity": n,
                               "wavelength": 3.9492, "spread": np.radians(5.0)}},
        "optics": {
            "aperture": {"class_name": "XicsrtOpticAperture", "origin": [0.0, 0.0, 0.5],
                         "zaxis": [0.0, 0.0, -1.0],
                         "aperture": [{"shape": "circle", "size": [0.04]}]},
            "detector": {"class_name": "XicsrtOpticDetector", "origin": [0.0, 0.0, 1.0],
                         "zaxis": [0.0, 0.0, -1.0], "xsize": 0.2, "ysize": 0.2},
        },
    }


@pytest.fixture(scope="module")
def results():
    return xicsrt_tpu_torch.raytrace(_config(), device="cpu")


def _assert_same(a, b, path=""):
    """Nested dicts of arrays, numbers and strings equal key for key."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (np.ndarray, list, tuple)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    else:
        assert a == b, path


def test_results_hdf5_roundtrip(results, tmp_path):
    path = str(tmp_path / "results.hdf5")
    xio.save_results(results, path)
    loaded = xio.load_results(path)
    np.testing.assert_array_equal(loaded["total"]["image"]["detector"],
                                  results["total"]["image"]["detector"])
    assert (loaded["total"]["meta"]["detector"]["num_out"]
            == results["total"]["meta"]["detector"]["num_out"])
    np.testing.assert_array_equal(loaded["found"]["history"]["detector"]["origin"],
                                  results["found"]["history"]["detector"]["origin"])


@pytest.mark.parametrize("ext", [".zip", ".pickle", ".json"])
def test_results_other_formats_roundtrip(results, tmp_path, ext):
    path = str(tmp_path / f"results{ext}")
    xio.save_results(results, path)
    assert os.path.exists(path)
    loaded = xio.load_results(path)
    np.testing.assert_array_equal(np.asarray(loaded["total"]["image"]["detector"]),
                                  results["total"]["image"]["detector"])
    assert (loaded["total"]["meta"]["source"]["num_out"]
            == results["total"]["meta"]["source"]["num_out"])


def test_results_exclude_and_include_filters(results, tmp_path):
    path = str(tmp_path / "nohist.hdf5")
    xio.save_results(results, path, exclude="history")
    loaded = xio.load_results(path)
    assert "history" not in loaded["found"] and "image" in loaded["total"]
    full = str(tmp_path / "full.hdf5")
    xio.save_results(results, full)
    assert os.path.getsize(path) < os.path.getsize(full)
    inc = str(tmp_path / "inc.hdf5")
    xio.save_results(results, inc, include=["total", "image", "meta", "detector",
                                            "num_out", "config", "general", "random_seed"])
    loaded = xio.load_results(inc)
    assert "found" not in loaded
    assert (loaded["total"]["meta"]["detector"]["num_out"]
            == results["total"]["meta"]["detector"]["num_out"])


def test_tensors_are_written_as_numpy(results, tmp_path):
    res = dict(results, total={"meta": results["total"]["meta"],
                               "image": {"detector": torch.ones(3, 2)}})
    for ext in (".hdf5", ".pickle"):
        path = str(tmp_path / f"tensor{ext}")
        xio.save_results(res, path)
        img = xio.load_results(path)["total"]["image"]["detector"]
        assert isinstance(img, np.ndarray) and img.shape == (3, 2) and img.sum() == 6
    with open(str(tmp_path / "tensor.pickle"), "rb") as fh:
        assert isinstance(pickle.load(fh)["total"]["image"]["detector"], np.ndarray)


def test_files_cross_between_the_packages(results, tmp_path):
    """The port's results and config load with the JAX package's io to the
    same keys and values, and the JAX package's into the port."""
    for ext in (".hdf5", ".pickle"):
        path = str(tmp_path / f"port{ext}")
        xio.save_results(results, path)
        loaded = jax_io.load_results(path)
        _assert_same(xio.load_results(path), loaded)
        for section in ("total", "found", "lost"):
            _assert_same(loaded[section], results[section], section)
    cfg_path = str(tmp_path / "port_config.json")
    xio.save_config(results["config"], cfg_path)
    _assert_same(xio.load_config(cfg_path), jax_io.load_config(cfg_path))

    jax_res = xicsrt_tpu.raytrace(_config(512))
    jpath = str(tmp_path / "jax.hdf5")
    jax_io.save_results(jax_res, jpath)
    loaded = xio.load_results(jpath)
    _assert_same(loaded, jax_io.load_results(jpath))
    assert set(loaded) == set(results)
    assert set(loaded["found"]["history"]["detector"]) == set(
        results["found"]["history"]["detector"])


def test_config_roundtrip_and_retrace(results, tmp_path):
    path = str(tmp_path / "config.json")
    xio.save_config(results["config"], path)
    loaded = xio.load_config(path)
    assert loaded["sources"]["source"]["class_name"] == "XicsrtSourceDirected"
    np.testing.assert_allclose(np.asarray(loaded["optics"]["detector"]["origin"]),
                               [0, 0, 1.0])
    again = xicsrt_tpu_torch.raytrace(loaded, device="cpu")
    _assert_same({k: v["num_out"] for k, v in again["total"]["meta"].items()},
                 {k: v["num_out"] for k, v in results["total"]["meta"].items()})


def test_save_images_tif(results, tmp_path):
    from PIL import Image

    res = dict(results, config={**results["config"], "general": {
        **results["config"]["general"], "output_path": str(tmp_path / "new"),
        "make_directories": True}})
    files = xio.save_images(res)
    assert files and all(f.endswith(".tif") for f in files)
    assert np.asarray(Image.open(files[-1])).sum() > 0
    res["config"]["general"]["make_directories"] = False
    res["config"]["general"]["output_path"] = str(tmp_path / "missing")
    with pytest.raises(FileNotFoundError):
        xio.save_images(res)


def test_raytrace_saves_as_the_jax_package_does(tmp_path):
    cfg = _config(1000, output_path=str(tmp_path), save_results=True, save_config=True,
                  save_images=True, output_suffix="run")
    res = xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    names = sorted(os.listdir(tmp_path))
    assert "xicsrt_results_run.hdf5" in names and "xicsrt_config_run.json" in names
    assert "xicsrt_detector_run_0000.tif" in names and "xicsrt_detector_run.tif" in names
    loaded = xio.load_results(str(tmp_path / "xicsrt_results_run.hdf5"))
    assert (loaded["total"]["meta"]["detector"]["num_out"]
            == res["total"]["meta"]["detector"]["num_out"])


@pytest.fixture
def cpu_cli(monkeypatch):
    """The CLI's ``raytrace`` on the CPU (it runs on the card otherwise)."""
    monkeypatch.setattr(xicsrt_tpu_torch, "raytrace",
                        functools.partial(xicsrt_tpu_torch.raytrace, device="cpu"))


def test_cli_version(capsys):
    assert cli.run(["--version"]) == 0
    assert capsys.readouterr().out.strip() == xicsrt_tpu_torch.__version__


def test_cli_save_and_images(tmp_path, cpu_cli):
    from __graft_entry__ import _spectrometer_config

    cfg = _spectrometer_config(4096, engine="fused", keep_history="found",
                               results_ext=".pickle")
    path = str(tmp_path / "cfg.json")
    xio.save_config(cfg, path)
    out = str(tmp_path / "out")
    os.makedirs(out)
    assert cli.run([path, "--save", "--images", "--numiter", "2", "--seed", "3",
                    "--path", out, "--suffix", "cli"]) == 0
    files = sorted(os.listdir(out))
    assert "xicsrt_results_cli.pickle" in files and "xicsrt_config_cli.json" in files
    assert "xicsrt_detector_cli.tif" in files
    saved = xio.load_results(os.path.join(out, "xicsrt_results_cli.pickle"))
    cfg["general"].update(number_of_iter=2, random_seed=3)
    ref = xicsrt_tpu_torch.raytrace(cfg)
    _assert_same(saved["total"]["meta"], ref["total"]["meta"])
    found = saved["found"]["history"]["detector"]
    assert 0 < found["origin"].shape[0] == ref["found"]["history"]["detector"]["origin"].shape[0]
    # --processes 2: the rays sharded over two shards (here both on the CPU),
    # each with a stream and a 'found' reservoir of its own.
    assert cli.run([path, "--save", "--numiter", "2", "--seed", "3", "--processes", "2",
                    "--path", out, "--suffix", "mp"]) == 0
    sharded = xio.load_results(os.path.join(out, "xicsrt_results_mp.pickle"))
    assert sharded["config"]["general"]["shard_rays"] is True
    meta, want = sharded["total"]["meta"], ref["total"]["meta"]
    assert meta["source"]["num_out"] == want["source"]["num_out"] == 2 * 4096
    n, k = want["source"]["num_out"], want["detector"]["num_out"]
    assert abs(meta["detector"]["num_out"] - k) <= 5 * (2 * k * (1 - k / n)) ** 0.5 + 1
    assert 0 < sharded["found"]["history"]["detector"]["origin"].shape[0]


PLUGIN = '''
from xicsrt_tpu_torch.optics.composites import OpticDetector


class MyPluginDetector(OpticDetector):
    """A detector from a plugin file."""

    def default_config(self):
        config = super().default_config()
        config["xsize"] = 0.5
        return config
'''


def test_plugin_paths_register_elements(tmp_path):
    (tmp_path / "xicsrt_myplugin.py").write_text(PLUGIN)
    loaded = dispatch.load_plugin_paths([str(tmp_path)])
    assert loaded == [str(tmp_path / "xicsrt_myplugin.py")]
    cls = dispatch.lookup("MyPluginDetector")
    assert cls.__name__ == "MyPluginDetector"
    assert dispatch.load_plugin_paths([str(tmp_path)]) == []  # imported once
    cfg = _config(256, pathlist=[str(tmp_path)])
    cfg["optics"]["detector"]["class_name"] = "MyPluginDetector"
    res = xicsrt_tpu_torch.raytrace(cfg, device="cpu")
    assert res["total"]["meta"]["detector"]["num_out"] > 0


def test_docs_are_harvested_and_versions_warn(caplog):
    from xicsrt_tpu_torch.utils.docs import describe

    text = describe("XicsrtOpticSphericalCrystal")
    assert "Configuration Options" in text
    assert "crystal_spacing" in text and "rocking_type" in text
    assert "crystal_spacing" in dispatch.lookup("XicsrtOpticSphericalCrystal").__doc__
    xicsrt_tpu_torch.warn_version(xicsrt_tpu_torch.__version__)
    assert not caplog.records
    xicsrt_tpu_torch.warn_version("99")
    assert any("written for version 99" in r.message for r in caplog.records)
