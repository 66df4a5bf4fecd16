"""Optics: shapes x interactions."""

from xicsrt_tpu_torch.optics import composites  # noqa: F401  (registers classes)
from xicsrt_tpu_torch.optics.base import TraceElement  # noqa: F401
from xicsrt_tpu_torch.optics.interactions import (  # noqa: F401
    InteractCrystal,
    InteractMirror,
    InteractNone,
)
from xicsrt_tpu_torch.optics.shapes import ShapePlane, ShapeSphere  # noqa: F401
