"""Analytic shape mixins (``xicsrt_tpu/optics/shapes.py``).

Ported: plane (``_ShapePlane.py:32-62``) and sphere (``_ShapeSphere.py:52-106``;
concave picks the far root, convex the near root). Each provides
``intersect(params, rays) -> (dist, normal, mask)`` in global coordinates.
Cylinder and torus are not ported yet.
"""

from __future__ import annotations

import torch

from xicsrt_tpu_torch.ops import vector as vec
from xicsrt_tpu_torch.optics.base import TraceElement


class ShapePlane(TraceElement):
    """Infinite plane through the frame origin, normal = zaxis."""

    def intersect(self, params, rays):
        frame = params["frame"]
        normal = frame.zaxis
        denom = vec.dot(rays.direction, normal)
        numer = vec.dot(frame.origin[None, :] - rays.origin, normal)
        nonzero = torch.abs(denom) > 1e-30
        dist = numer / torch.where(nonzero, denom, torch.full_like(denom, 1e-30))
        m = rays.mask & (dist >= 0.0) & nonzero
        return dist, normal.expand(rays.origin.shape), m


class ShapeSphere(TraceElement):
    """Spherical cap; center at origin + sign * radius * zaxis."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["radius"] = 1.0
        config["convex"] = False
        return config

    def build_params(self) -> dict:
        params = super().build_params()
        params["radius"] = self.as_tensor(self.param["radius"])
        return params

    def intersect(self, params, rays):
        convex = bool(self.param["convex"])
        sign = -1.0 if convex else 1.0
        frame = params["frame"]
        radius = params["radius"]
        center = frame.origin + sign * radius * frame.zaxis
        L = center[None, :] - rays.origin
        t_ca = vec.dot(L, rays.direction)
        d2 = vec.dot(L, L) - t_ca * t_ca
        r2 = radius * radius
        t_hc = torch.sqrt(torch.clamp_min(r2 - d2, 0.0))
        dist = t_ca - t_hc if convex else t_ca + t_hc
        m = rays.mask & (d2 <= r2)
        xloc = rays.origin + rays.direction * dist[:, None]
        norm = vec.safe_normalize(center[None, :] - xloc)
        return dist, norm, m
