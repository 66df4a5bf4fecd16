"""Analytic shape mixins (``xicsrt_tpu/optics/shapes.py``).

Ported: plane (``_ShapePlane.py:32-62``), sphere (``_ShapeSphere.py:52-106``;
concave picks the far root, convex the near root), cylinder
(``_ShapeCylinder.py:52-133``: axis along the local x axis, the same root
choice) and torus (``_ShapeTorus.py:54-216``: the quartic in torus-centred
coordinates, axis along the local y axis; the ``convex`` pair sets the tube
and the centre). Each provides ``intersect(params, rays) -> (dist, normal,
mask)`` in global coordinates.
"""

from __future__ import annotations

import numpy as np
import torch

from xicsrt_tpu_torch.ops import polynomials as poly
from xicsrt_tpu_torch.ops import vector as vec
from xicsrt_tpu_torch.optics.base import TraceElement

# (convex in x, convex in y) -> (major_adjust, center_sign): the torus
# major radius is radius_major + major_adjust * radius_minor and its centre
# sits at origin + center_sign * radius_major * zaxis.
_TORUS_CONVEX = {
    (False, False): (-1.0, +1.0),
    (False, True): (+1.0, +1.0),
    (True, False): (+1.0, -1.0),
    (True, True): (-1.0, -1.0),
}


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


class _ShapeCurved(TraceElement):
    """The config of a curved shape of one radius (sphere, cylinder)."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["radius"] = 1.0
        config["convex"] = False
        return config

    def build_params(self) -> dict:
        params = super().build_params()
        params["radius"] = self.as_tensor(self.param["radius"])
        return params


class ShapeSphere(_ShapeCurved):
    """Spherical cap; center at origin + sign * radius * zaxis."""

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


class ShapeCylinder(_ShapeCurved):
    """Cylindrical surface; axis along the local xaxis, the axis displaced
    from the origin along +-zaxis by the radius (JAX ``optics/shapes.py:91``)."""

    def intersect(self, params, rays):
        convex = bool(self.param["convex"])
        sign = -1.0 if convex else 1.0
        frame = params["frame"]
        radius = params["radius"]
        center = frame.origin + sign * radius * frame.zaxis
        axis = frame.xaxis
        dp = rays.origin - center[None, :]
        d_ax = vec.dot(rays.direction, axis)
        p_ax = vec.dot(dp, axis)
        A1 = rays.direction - d_ax[:, None] * axis[None, :]
        B1 = dp - p_ax[:, None] * axis[None, :]
        a = vec.dot(A1, A1)
        b = 2.0 * vec.dot(A1, B1)
        c = vec.dot(B1, B1) - radius * radius
        t0, t1, valid = poly.solve_quadratic(a, b, c)
        dist = torch.minimum(t0, t1) if convex else torch.maximum(t0, t1)
        m = rays.mask & valid
        dist = torch.where(m, dist, torch.zeros_like(dist))
        xloc = rays.origin + rays.direction * dist[:, None]
        # The normal points from the surface towards the axis.
        to_center = center[None, :] - xloc
        along = vec.dot(to_center, axis)
        return dist, vec.safe_normalize(to_center - along[:, None] * axis[None, :]), m


class ShapeTorus(TraceElement):
    """Toroidal surface: ``radius_major`` is the radius of curvature in the
    local x direction, ``radius_minor`` in y; the root taken is the
    positive intersection with the smallest optic-local |z| (the patch
    through the frame origin)."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["radius_major"] = 1.0
        config["radius_minor"] = 0.2
        config["convex"] = [False, False]
        return config

    def check_config(self):
        super().check_config()
        if self.config["radius_minor"] >= self.config["radius_major"]:
            raise ValueError("Cannot construct torus with radius_major <= radius_minor.")

    def initialize(self):
        super().initialize()
        convex = [bool(v) for v in np.atleast_1d(self.param["convex"])]
        if len(convex) == 1:
            convex = convex * 2
        adjust, sign = _TORUS_CONVEX[tuple(convex)]
        self.param["major_adjust"] = adjust
        self.param["center_sign"] = sign

    def build_params(self) -> dict:
        params = super().build_params()
        params["radius_major"] = self.as_tensor(self.param["radius_major"])
        params["radius_minor"] = self.as_tensor(self.param["radius_minor"])
        return params

    def intersect(self, params, rays):
        frame = params["frame"]
        r_min = params["radius_minor"]
        r_maj = params["radius_major"] + self.param["major_adjust"] * r_min
        center = (frame.origin
                  + self.param["center_sign"] * params["radius_major"] * frame.zaxis)

        # Torus-centred local coordinates (torus axis = local y), each ray
        # origin shifted to its closest approach to the centre so the
        # float32 coefficients stay O(r^2).
        O = frame.vector_to_local(rays.origin - center[None, :])
        D = frame.vector_to_local(rays.direction)
        t_shift = -vec.dot(O, D)
        Os = O + t_shift[:, None] * D
        o2 = vec.dot(Os, Os)
        od = vec.dot(Os, D)
        r2 = r_maj * r_maj + r_min * r_min
        dy, oy = D[:, 1], Os[:, 1]
        c0 = torch.ones_like(o2)
        c1 = 4.0 * od
        c2 = 4.0 * od * od + 2.0 * o2 - 2.0 * r2 + 4.0 * r_maj**2 * dy * dy
        c3 = 4.0 * od * (o2 - r2) + 8.0 * r_maj**2 * dy * oy
        c4 = (o2 * o2 - 2.0 * r2 * o2 + 4.0 * r_maj**2 * oy * oy
              + (r_maj**2 - r_min**2) ** 2)
        cand = poly.solve_quartic(c0, c1, c2, c3, c4) + t_shift[:, None]

        # Of the positive real roots, the one with minimal optic-local |z|.
        z0 = vec.dot(rays.origin - frame.origin[None, :], frame.zaxis)
        zd = vec.dot(rays.direction, frame.zaxis)
        z_local = z0[:, None] + cand * zd[:, None]
        valid = torch.isfinite(cand) & (cand > 1e-6)
        score = torch.where(valid, torch.abs(z_local), torch.full_like(z_local, float("inf")))
        k = torch.argmin(score, dim=-1, keepdim=True)
        dist = torch.gather(cand, 1, k)[:, 0]
        m = rays.mask & torch.gather(valid, 1, k)[:, 0]
        dist = torch.where(m, dist, torch.zeros_like(dist))

        # Normal: from the tube centre (the hit projected onto the axis
        # circle) to the hit.
        xloc = rays.origin + rays.direction * dist[:, None]
        yaxis = frame.yaxis
        pt = xloc - center[None, :]
        pt_planar = pt - vec.dot(pt, yaxis)[:, None] * yaxis[None, :]
        q = center[None, :] + r_maj * vec.safe_normalize(pt_planar)
        return dist, vec.safe_normalize(xloc - q), m
