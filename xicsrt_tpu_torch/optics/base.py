"""Optic base: frame + bounds + aperture + image grid (``xicsrt_tpu/optics/base.py``).

A concrete optic is a Shape mixin x Interact mixin, as in the reference
(``optics/_TraceObject.py:157-172``). It exports
``trace(params, rays, draws) -> (rays, x_local)``: intersect, bounds and
aperture, interaction, all in global coordinates on dense ``[N, 3]``
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from xicsrt_tpu_torch.dispatch import GeometryElement
from xicsrt_tpu_torch.ops.aperture import aperture_mask, normalize_aperture_spec
from xicsrt_tpu_torch.rays import Rays


class TraceElement(GeometryElement):
    """Base optic: bounds, apertures, pixel-image grid."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["xsize"] = None
        config["ysize"] = None
        config["zsize"] = None
        config["pixel_size"] = None
        config["trace_local"] = False
        config["check_size"] = True
        config["check_aperture"] = True
        config["aperture"] = None
        config["filters"] = []
        return config

    def initialize(self):
        super().initialize()
        xsize = self.param.get("xsize")
        ysize = self.param.get("ysize")
        if xsize and ysize:
            pixel_size = self.param.get("pixel_size")
            if pixel_size is None:
                pixel_size = xsize / 100.0
                self.param["pixel_size"] = pixel_size
            nx = xsize / pixel_size
            ny = ysize / pixel_size
            if not (
                np.isclose(nx, np.round(nx), atol=1e-6)
                and np.isclose(ny, np.round(ny), atol=1e-6)
            ):
                self.log.warning(
                    "Optic size (%0.4f x %0.4f) is not a multiple of pixel_size "
                    "(%0.4f); output image may be truncated.",
                    xsize, ysize, pixel_size,
                )
            self.param["pixel_xsize"] = int(np.round(nx))
            self.param["pixel_ysize"] = int(np.round(ny))
            self.param["enable_image"] = True
        else:
            self.param["enable_image"] = False
        self.aperture_spec = normalize_aperture_spec(self.param.get("aperture"))
        filters = self.param.get("filters")
        if filters is not None and len(filters):
            raise NotImplementedError(
                f'Optic "{self.name}": optic filters are not ported yet.')

    @property
    def enable_image(self) -> bool:
        return bool(self.param.get("enable_image"))

    @property
    def image_shape(self):
        if not self.enable_image:
            return None
        return (self.param["pixel_xsize"], self.param["pixel_ysize"])

    @property
    def pixel_size(self):
        return self.param.get("pixel_size")

    def check_bounds(self, x_local, mask):
        """Size and aperture tests (``_TraceObject.check_bounds`` :180-232)."""
        m = mask
        if self.param.get("check_size", True):
            for axis, key in enumerate(("xsize", "ysize", "zsize")):
                size = self.param.get(key)
                if size is not None:
                    m = m & (torch.abs(x_local[:, axis]) < size / 2.0)
        if self.param.get("check_aperture", True) and self.aperture_spec:
            m = aperture_mask(x_local, m, self.aperture_spec)
        return m

    # --- shape/interact contracts (provided by mixins) -------------------
    def intersect(self, params, rays: Rays):
        """Returns (dist [N], normal [N,3], m_int [N] alive & hitting)."""
        raise NotImplementedError

    def interact(self, params, rays: Rays, xloc, norm, mask, draws) -> Rays:
        raise NotImplementedError

    def trace(self, params, rays: Rays, draws):
        """Intersect -> bounds -> interact; returns (rays, x_local)."""
        frame = params["frame"]
        dist, norm, m_int = self.intersect(params, rays)
        xloc = torch.where(
            m_int[:, None],
            rays.origin + rays.direction * dist[:, None],
            rays.origin,
        )
        x_local = frame.point_to_local(xloc)
        mask = self.check_bounds(x_local, m_int)
        rays = self.interact(params, rays, xloc, norm, mask, draws)
        # Every intersecting ray moves to the surface; the others keep
        # their previous origin so the tensors stay finite.
        return rays.replace(origin=xloc), x_local
