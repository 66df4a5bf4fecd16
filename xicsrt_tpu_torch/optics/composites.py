"""Ready-made optics: Shape x Interact compositions
(``xicsrt_tpu/optics/composites.py``), registered under the reference
``class_name``. Ported: every composite of a plane or a sphere with no
interaction, a mirror or a crystal."""

from __future__ import annotations

from xicsrt_tpu_torch.dispatch import register
from xicsrt_tpu_torch.optics.interactions import (
    InteractCrystal,
    InteractMirror,
    InteractNone,
)
from xicsrt_tpu_torch.optics.shapes import ShapePlane, ShapeSphere


@register("XicsrtOpticDetector", "detector")
class OpticDetector(InteractNone, ShapePlane):
    """Planar detector (cf. ``optics/_XicsrtOpticDetector.py:16``)."""


@register("XicsrtOpticAperture", "aperture")
class OpticAperture(InteractNone, ShapePlane):
    """Planar aperture surface (cf. ``optics/_XicsrtOpticAperture.py:15``)."""


@register("XicsrtOpticPlanarMirror", "planar_mirror")
class OpticPlanarMirror(InteractMirror, ShapePlane):
    pass


@register("XicsrtOpticPlanarCrystal", "planar_crystal")
class OpticPlanarCrystal(InteractCrystal, ShapePlane):
    pass


@register("XicsrtOpticSphericalMirror", "spherical_mirror")
class OpticSphericalMirror(InteractMirror, ShapeSphere):
    pass


@register(
    "XicsrtOpticSphericalCrystal",
    "spherical_crystal",
    "XicsrtOpticCrystalSpherical",
)
class OpticSphericalCrystal(InteractCrystal, ShapeSphere):
    pass
