"""Ready-made optics: Shape x Interact compositions
(``xicsrt_tpu/optics/composites.py``), registered under the reference
``class_name``: every composite of a plane, a sphere, a cylinder, a torus or
a mesh with no interaction, a mirror or a crystal, and the planar,
spherical and mesh mosaic crystals."""

from __future__ import annotations

from xicsrt_tpu_torch.dispatch import register
from xicsrt_tpu_torch.optics.interactions import (
    InteractCrystal,
    InteractMirror,
    InteractMosaicCrystal,
    InteractNone,
)
from xicsrt_tpu_torch.optics.mesh_shapes import (
    ShapeMesh,
    ShapeMeshCylinder,
    ShapeMeshSphere,
    ShapeMeshTorus,
)
from xicsrt_tpu_torch.optics.shapes import (
    ShapeCylinder,
    ShapePlane,
    ShapeSphere,
    ShapeTorus,
)


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


@register("XicsrtOpticPlanarMosaicCrystal", "planar_mosaic_crystal")
class OpticPlanarMosaicCrystal(InteractMosaicCrystal, ShapePlane):
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


@register("XicsrtOpticSphericalMosaicCrystal", "spherical_mosaic_crystal")
class OpticSphericalMosaicCrystal(InteractMosaicCrystal, ShapeSphere):
    pass


@register("XicsrtOpticCylindricalMirror", "cylindrical_mirror")
class OpticCylindricalMirror(InteractMirror, ShapeCylinder):
    pass


@register("XicsrtOpticCylindricalCrystal", "cylindrical_crystal")
class OpticCylindricalCrystal(InteractCrystal, ShapeCylinder):
    pass


@register("XicsrtOpticToroidalCrystal", "toroidal_crystal")
class OpticToroidalCrystal(InteractCrystal, ShapeTorus):
    pass


@register("XicsrtOpticToroidalMirror", "toroidal_mirror")
class OpticToroidalMirror(InteractMirror, ShapeTorus):
    pass


@register("XicsrtOpticMeshMirror", "mesh_mirror")
class OpticMeshMirror(InteractMirror, ShapeMesh):
    pass


@register("XicsrtOpticMeshCrystal", "mesh_crystal")
class OpticMeshCrystal(InteractCrystal, ShapeMesh):
    pass


@register("XicsrtOpticMeshMosaicCrystal", "mesh_mosaic_crystal")
class OpticMeshMosaicCrystal(InteractMosaicCrystal, ShapeMesh):
    pass


@register("XicsrtOpticMeshSphericalCrystal", "mesh_spherical_crystal")
class OpticMeshSphericalCrystal(InteractCrystal, ShapeMeshSphere):
    pass


@register("XicsrtOpticMeshCylindricalCrystal", "mesh_cylindrical_crystal")
class OpticMeshCylindricalCrystal(InteractCrystal, ShapeMeshCylinder):
    pass


@register("XicsrtOpticMeshToroidalCrystal", "mesh_toroidal_crystal")
class OpticMeshToroidalCrystal(InteractCrystal, ShapeMeshTorus):
    pass
