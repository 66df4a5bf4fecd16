"""Interactive element access (``xicsrt_tpu/public.py``)."""

from __future__ import annotations

from xicsrt_tpu_torch import dispatch
from xicsrt_tpu_torch.config import get_config
from xicsrt_tpu_torch.dispatch import default_device


def get_element(config: dict, name: str, device=None):
    """Build one fully-initialized element outside a raytrace, searching the
    optics/sources/filters sections for ``name``. ``device`` defaults to
    CUDA and raises without it, as ``raytrace`` does."""
    device = default_device(device)
    config = get_config(config)
    for section in ("optics", "sources", "filters"):
        if name in config.get(section, {}):
            return dispatch.instantiate(
                name, config[section][name], config["general"], device
            )
    raise KeyError(f'Element "{name}" not found in config.')
