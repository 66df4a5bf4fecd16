"""Config system: defaults, recursive merge, strict checking.

The nested-dict config *is* the public API contract of the reference
(``xicsrt/xicsrt_config.py``), so the semantics are preserved: sections
``general/sources/optics/filters/scenario``, elements keyed by user-chosen
name with a ``class_name``, recursive merge with strict unknown-key
detection, and class-defined defaults chained through inheritance.

The keys and values are those of ``xicsrt_tpu/config.py``, so one config
dict runs on both packages. In this package:

- ``engine``: 'xla' is the eager PyTorch engine, 'fused' the hand-written
  CUDA kernel (plain PyTorch twin on the CPU), 'auto' fused where the
  config is inside its subset;
- ``binning``: 'xla' scatters with ``index_put_``, 'pallas' names the
  hand-written CUDA binning kernel;
- ``binning_dtype`` and ``block_iterations`` are accepted and have no
  effect; ``shard_rays`` over more than one device is not ported yet.
"""

from __future__ import annotations

import numpy as np

from xicsrt_tpu_torch._version import __version__


def default_config() -> dict:
    """Top-level defaults, the same as ``xicsrt_tpu.config.default_config``."""
    config: dict = {}
    g: dict = {}
    config["general"] = g

    g["version"] = __version__
    g["number_of_iter"] = 1
    g["number_of_runs"] = 1
    g["random_seed"] = None
    g["pathlist"] = []
    g["strict_config_check"] = True

    g["output_path"] = None
    g["output_prefix"] = "xicsrt"
    g["output_suffix"] = None
    g["output_run_suffix"] = None
    g["image_ext"] = ".tif"
    g["results_ext"] = ".hdf5"
    g["config_ext"] = ".json"
    g["make_directories"] = False

    g["keep_meta"] = True
    g["keep_images"] = True
    # True (full history) or False; the fused engine's bounded reservoirs
    # ('found', 'sampled') are not ported yet.
    g["keep_history"] = True
    g["history_max_lost"] = 10000
    g["history_found_slots"] = 8

    g["save_config"] = False
    g["save_images"] = False
    g["save_results"] = False
    g["print_results"] = True

    # --- execution options (new in xicsrt_tpu) ---
    g["dtype"] = "float32"
    g["interact_mode"] = "mc"
    g["image_mode"] = "nearest"
    # Execution engine: 'xla' (eager), 'fused' (one CUDA kernel; raises on
    # configs outside its subset, see ops/fused_trace.py), or 'auto'.
    g["engine"] = "xla"
    # Binning backend: 'xla' (index_put_ scatter) or 'pallas' (the CUDA
    # binning kernel, ops/pallas_binning.py).
    g["binning"] = "xla"
    g["binning_dtype"] = None
    g["devices"] = None
    g["shard_rays"] = False
    # Directory for a torch.profiler trace of the run loop (None = off).
    g["profile_dir"] = None
    g["block_iterations"] = True

    config["sources"] = {}
    config["optics"] = {}
    config["filters"] = {}
    config["scenario"] = {}
    return config


def get_config(config_user: dict | None = None) -> dict:
    config = default_config()
    update_config(config, config_user, strict=False, update=True)
    return config


def update_config(config, config_new, strict=None, update=None, ignore_none=None):
    """Recursive merge of ``config_new`` into ``config``.

    Semantics identical to the reference (``xicsrt_config.py:294-364``):

    - ``strict`` (True): raise on unknown keys;
    - ``update`` (False): retain unknown keys when not strict;
    - ``ignore_none`` (False): skip None values in ``config_new``.
    """
    _update_config_dict(config, config_new, strict, update, ignore_none)
    return config


def _update_config_dict(config, config_new, strict, update, ignore_none):
    if strict is None:
        strict = True
    if update is None:
        update = False
    if ignore_none is None:
        ignore_none = False
    if config_new is None:
        return
    for key in config_new:
        if key not in config:
            if strict:
                raise KeyError(f"User option not recognized: {key}")
            if update:
                config[key] = config_new[key]
        else:
            if isinstance(config[key], dict) and isinstance(config_new[key], dict):
                _update_config_dict(
                    config[key], config_new[key], strict, update, ignore_none
                )
            else:
                if ignore_none and config_new[key] is None:
                    continue
                config[key] = config_new[key]


def config_to_numpy(obj):
    """Recursively convert lists of numbers to numpy arrays, in place."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, (dict,)):
                config_to_numpy(v)
            elif isinstance(v, (list, tuple)) and _is_numeric_seq(v):
                obj[k] = np.asarray(v)
    return obj


def _is_numeric_seq(v) -> bool:
    try:
        arr = np.asarray(v)
    except Exception:
        return False
    return arr.dtype.kind in "fiub"
