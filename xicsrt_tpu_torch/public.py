"""Interactive element access (``xicsrt_tpu/public.py``)."""

from __future__ import annotations

from xicsrt_tpu_torch import dispatch
from xicsrt_tpu_torch.config import get_config


def get_element(config: dict, name: str, device="cpu"):
    """Build one fully-initialized element outside a raytrace, searching the
    optics/sources/filters sections for ``name``."""
    config = get_config(config)
    for section in ("optics", "sources", "filters"):
        if name in config.get(section, {}):
            return dispatch.instantiate(
                name, config[section][name], config["general"], device
            )
    raise KeyError(f'Element "{name}" not found in config.')
