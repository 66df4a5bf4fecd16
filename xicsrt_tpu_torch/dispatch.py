"""Element registry and config lifecycle.

The counterpart of ``xicsrt_tpu/dispatch.py``: a decorator registry keyed
by the reference ``class_name``, and the reference lifecycle
``default_config -> update -> check_config -> param copy -> setup ->
check_param -> initialize``. An element then exports plain functions on
tensors plus a parameter dict (``build_params``) that the engine passes in.

Every element is built for one ``device``; its parameters are tensors
there.
"""

from __future__ import annotations

import copy
import logging

import numpy as np
import torch

from xicsrt_tpu_torch import geometry
from xicsrt_tpu_torch.config import config_to_numpy, update_config

_REGISTRY: dict = {}

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "f32": torch.float32,
    "f64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def register(*names):
    """Class decorator registering an element under one or more class_names."""

    def deco(cls):
        for n in names:
            key = n.lower()
            if key in _REGISTRY:
                raise ValueError(f"Duplicate element registration: {n}")
            _REGISTRY[key] = cls
        cls._registered_names = names
        # The "Configuration Options" docs from the MRO's default_config
        # docstrings (the reference's @dochelper pattern).
        from xicsrt_tpu_torch.utils.docs import attach_config_doc

        return attach_config_doc(cls)

    return deco


def contrib_pathlist() -> list:
    """Element directories of the optional ``xicsrt_contrib`` package
    (JAX ``dispatch.contrib_pathlist``; ``xicsrt_config._add_pathlist_contrib``
    :270-281): when the companion package is installed, its filters,
    sources and optics directories are searched for plugin element files."""
    import importlib.util
    import os

    spec = importlib.util.find_spec("xicsrt_contrib")
    if spec is None or not spec.origin:
        return []
    base = os.path.dirname(os.path.abspath(spec.origin))
    return [os.path.join(base, d) for d in ("filters", "sources", "optics")]


def load_plugin_paths(pathlist) -> list:
    """Import user element modules from a list of directories (JAX
    ``dispatch.load_plugin_paths``; the reference's file-glob discovery,
    ``_Dispatcher.py:63-95``): every ``_Xicsrt*.py`` / ``xicsrt_*.py`` file
    is imported once. Classes using ``@register`` register themselves; any
    other ``Element`` subclass the module defines is registered under its
    class name. Returns the files imported by this call."""
    import glob
    import importlib.util
    import os

    loaded = []
    for path in list(pathlist or []) + contrib_pathlist():
        patterns = [os.path.join(path, "_Xicsrt*.py"), os.path.join(path, "xicsrt_*.py")]
        for filename in sorted({f for pat in patterns for f in glob.glob(pat)}):
            modname = "xicsrt_tpu_torch_plugin_" + os.path.splitext(
                os.path.basename(filename))[0].lstrip("_")
            if modname in _LOADED_PLUGINS:
                continue
            spec = importlib.util.spec_from_file_location(modname, filename)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            _LOADED_PLUGINS[modname] = module
            for obj in vars(module).values():
                if (isinstance(obj, type) and issubclass(obj, Element)
                        and obj.__module__ == modname
                        and obj.__name__.lower() not in _REGISTRY):
                    _REGISTRY[obj.__name__.lower()] = obj
            loaded.append(filename)
    return loaded


_LOADED_PLUGINS: dict = {}


def lookup(class_name: str):
    cls = _REGISTRY.get(str(class_name).lower())
    if cls is None:
        known = sorted({c.__name__ for c in _REGISTRY.values()})
        raise KeyError(
            f'Element class "{class_name}" not found. Known classes: {known}'
        )
    return cls


def registry_names() -> list:
    """The registered class names, lower case and sorted."""
    return sorted(_REGISTRY.keys())


def default_device(device=None) -> torch.device:
    """``device``, or CUDA when it is None; never a silent CPU fall-back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU."
            )
        device = "cuda"
    return torch.device(device)


def instantiate(name: str, element_config: dict, general: dict | None = None,
                device=None):
    """Build one element object from its config section entry, on
    ``device`` (by default CUDA, raising without it)."""
    element_config = dict(element_config or {})
    class_name = element_config.pop("class_name", None)
    if class_name is None:
        raise KeyError(f'Element "{name}" has no class_name.')
    cls = lookup(class_name)
    return cls(element_config, name=name, general=general, device=device)


def build_section(config: dict, section: str, device=None) -> list:
    """Instantiate every element of a config section, in config order, on
    ``device`` (by default CUDA, raising without it)."""
    general = config.get("general", {})
    out = []
    for name, element_config in config.get(section, {}).items():
        cfg = dict(element_config)
        cfg.pop("enabled", None)
        if element_config.get("enabled", True) is False:
            continue
        out.append(instantiate(name, cfg, general, device))
    return out


class Element:
    """Base class: config lifecycle + dtype and device plumbing."""

    def __init__(self, config: dict | None = None, name: str | None = None,
                 general: dict | None = None, device=None):
        self.name = name or type(self).__name__
        self.general = dict(general or {})
        self.device = default_device(device)
        self.log = logging.getLogger(f"xicsrt_tpu_torch.{self.name}")
        self.dtype = _DTYPES[str(self.general.get("dtype", "float32")).lower()]
        self.interact_mode = str(self.general.get("interact_mode", "mc")).lower()

        cfg = self.default_config()
        strict = bool(self.general.get("strict_config_check", True))
        update_config(cfg, config, strict=strict, update=not strict)
        self.config = cfg
        self.check_config()
        self.param = config_to_numpy(copy.deepcopy(self.config))
        self.setup()
        self.check_param()
        self.initialize()

    # --- config lifecycle hooks -----------------------------------------
    def default_config(self) -> dict:
        return {"class_name": type(self).__name__}

    def check_config(self):
        pass

    def setup(self):
        pass

    def check_param(self):
        pass

    def initialize(self):
        pass

    # --- functional exports ---------------------------------------------
    def build_params(self) -> dict:
        """Parameter dict of tensors for this element."""
        return {}

    # --- helpers ---------------------------------------------------------
    def as_tensor(self, value, shape=None) -> torch.Tensor:
        arr = torch.as_tensor(np.asarray(value, dtype=np.float64),
                              dtype=self.dtype, device=self.device)
        if shape is not None:
            arr = arr.reshape(shape)
        return arr


class GeometryElement(Element):
    """Element with a pose (origin/zaxis/xaxis)."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["origin"] = np.array([0.0, 0.0, 0.0])
        config["zaxis"] = np.array([0.0, 0.0, 1.0])
        config["xaxis"] = None
        return config

    def check_config(self):
        super().check_config()
        if self.config.get("xaxis") is not None:
            z = np.asarray(self.config["zaxis"], dtype=np.float64)
            x = np.asarray(self.config["xaxis"], dtype=np.float64)
            if not np.isclose(np.dot(z, x), 0.0, atol=1e-8):
                raise ValueError(
                    f'Element "{self.name}": zaxis and xaxis are not orthogonal.'
                )

    def setup(self):
        super().setup()
        self.frame = geometry.frame_from_config(
            self.param["origin"],
            self.param["zaxis"],
            self.param.get("xaxis"),
            dtype=self.dtype,
            device=self.device,
        )

    def build_params(self) -> dict:
        params = super().build_params()
        params["frame"] = self.frame
        return params
