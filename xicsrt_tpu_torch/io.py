"""Saving/loading of configs, results and images (``xicsrt_tpu/io.py``).

Equivalent of ``xicsrt/xicsrt_io.py``: json configs, hdf5/pickle/json
results, per-optic image files with automatically generated
``prefix_name_suffix_run.ext`` filenames. The files are the JAX package's:
torch tensors in a results dict are written as numpy arrays, so either
package loads the other's files.
"""

from __future__ import annotations

import json
import logging
import os
import pickle

import numpy as np
import torch

from xicsrt_tpu_torch.config import config_from_numpy, refresh_config

log = logging.getLogger("xicsrt_tpu_torch")


# ---------------------------------------------------------------------------
# Filenames (cf. xicsrt_io.py:120-145).
# ---------------------------------------------------------------------------

def generate_filename(config, kind: str, name: str | None = None) -> str:
    g = config["general"]
    parts = [g.get("output_prefix") or "xicsrt"]
    if name:
        parts.append(name)
    if kind == "results":
        parts.append("results")
    if kind == "config":
        parts.append("config")
    if g.get("output_suffix"):
        parts.append(g["output_suffix"])
    if g.get("output_run_suffix"):
        parts.append(g["output_run_suffix"])
    ext = {
        "image": g.get("image_ext", ".tif"),
        "results": g.get("results_ext", ".hdf5"),
        "config": g.get("config_ext", ".json"),
    }[kind]
    path = g.get("output_path") or os.getcwd()
    return os.path.join(path, "_".join(parts) + ext)


def _ensure_dir(config):
    g = config["general"]
    path = g.get("output_path") or os.getcwd()
    if not os.path.isdir(path):
        if g.get("make_directories"):
            os.makedirs(path, exist_ok=True)
        else:
            raise FileNotFoundError(
                f"Output path does not exist: {path}. "
                "Set general.make_directories=True to create it."
            )
    return path


# ---------------------------------------------------------------------------
# Config save/load.
# ---------------------------------------------------------------------------

def save_config(config, filename: str | None = None) -> str:
    _ensure_dir(config)
    if filename is None:
        filename = generate_filename(config, "config")
    serializable = config_from_numpy(json.loads(json.dumps(config, default=_np_default)))
    with open(filename, "w") as fh:
        json.dump(serializable, fh, indent=2)
    log.info("Saved config: %s", filename)
    return filename


def load_config(filename: str, refresh: bool = True) -> dict:
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".json":
        with open(filename) as fh:
            config = json.load(fh)
    elif ext in (".pickle", ".pkl"):
        with open(filename, "rb") as fh:
            config = pickle.load(fh)
    elif ext in (".hdf5", ".h5"):
        from xicsrt_tpu_torch.utils import hdf5_dict

        config = hdf5_dict.load(filename)
    else:
        raise ValueError(f"Unknown config format: {ext}")
    if refresh:
        config = refresh_config(config)
    return config


def _np_default(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(f"Cannot serialize {type(obj)}")


# ---------------------------------------------------------------------------
# Results save/load (cf. xicsrt_io.py:148-200).
# ---------------------------------------------------------------------------

def save_results(results, filename: str | None = None,
                 include=None, exclude=None) -> str:
    """Save a results dict.

    ``include``/``exclude``: regex key filters applied at every nesting
    level of the HDF5 writer (cf. reference ``mirhdf5.py:333-366``) — e.g.
    ``exclude='history'`` drops the (large) ray histories from the file.
    A ``.zip`` filename writes a deflate-compressed archive
    (cf. ``mirhdf5.dictToHdf5Zip``).
    """
    config = results["config"]
    _ensure_dir(config)
    if filename is None:
        filename = generate_filename(config, "results")
    results = _to_numpy(results)
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".zip":
        from xicsrt_tpu_torch.utils import hdf5_dict

        hdf5_dict.save_zip(filename, results, include=include,
                           exclude=exclude)
    elif ext in (".hdf5", ".h5"):
        from xicsrt_tpu_torch.utils import hdf5_dict

        hdf5_dict.save(filename, results, include=include, exclude=exclude)
    elif ext in (".pickle", ".pkl"):
        with open(filename, "wb") as fh:
            pickle.dump(results, fh)
    elif ext == ".json":
        with open(filename, "w") as fh:
            json.dump(results, fh, default=_np_default)
    else:
        raise ValueError(f"Unknown results format: {ext}")
    log.info("Saved results: %s", filename)
    return filename


def _to_numpy(obj):
    """A copy of a nested dict with every torch tensor as a numpy array."""
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj


def load_results(filename: str) -> dict:
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".zip":
        from xicsrt_tpu_torch.utils import hdf5_dict

        return hdf5_dict.load_zip(filename)
    if ext in (".hdf5", ".h5"):
        from xicsrt_tpu_torch.utils import hdf5_dict

        return hdf5_dict.load(filename)
    if ext in (".pickle", ".pkl"):
        with open(filename, "rb") as fh:
            return pickle.load(fh)
    if ext == ".json":
        with open(filename) as fh:
            return json.load(fh)
    raise ValueError(f"Unknown results format: {ext}")


# ---------------------------------------------------------------------------
# Images (cf. xicsrt_io.py:92-117).
# ---------------------------------------------------------------------------

def save_images(results, rotate: bool = True) -> list:
    """Save per-optic intersection images (rot90 to match the reference's
    on-disk orientation)."""
    from PIL import Image

    config = results["config"]
    _ensure_dir(config)
    saved = []
    for name, image in results["total"]["image"].items():
        if image is None:
            continue
        filename = generate_filename(config, "image", name)
        arr = np.asarray(_to_numpy(image))
        if rotate:
            arr = np.rot90(arr)
        Image.fromarray(arr.astype(np.float32)).save(filename)
        saved.append(filename)
        log.info("Saved image: %s", filename)
    return saved
