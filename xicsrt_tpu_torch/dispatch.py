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
        return cls

    return deco


def lookup(class_name: str):
    cls = _REGISTRY.get(str(class_name).lower())
    if cls is None:
        known = sorted({c.__name__ for c in _REGISTRY.values()})
        raise KeyError(
            f'Element class "{class_name}" not found. Known classes: {known}'
        )
    return cls


def instantiate(name: str, element_config: dict, general: dict | None = None,
                device="cpu"):
    """Build one element object from its config section entry."""
    element_config = dict(element_config or {})
    class_name = element_config.pop("class_name", None)
    if class_name is None:
        raise KeyError(f'Element "{name}" has no class_name.')
    cls = lookup(class_name)
    return cls(element_config, name=name, general=general, device=device)


def build_section(config: dict, section: str, device="cpu") -> list:
    """Instantiate every element of a config section, in config order."""
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
                 general: dict | None = None, device="cpu"):
        self.name = name or type(self).__name__
        self.general = dict(general or {})
        self.device = torch.device(device)
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
