"""Vector math on ``[..., 3]`` tensors (``xicsrt_tpu/ops/vector.py``).

Batched over the leading ray axis and branch-free; normalizations can be
clamped away from zero so masked lanes stay finite.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product for [..., 3] tensors."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def magnitude(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize along the last axis; ``eps > 0`` clamps the norm."""
    n = magnitude(v)
    if eps:
        n = torch.clamp_min(n, eps)
    return v / n[..., None]


def safe_normalize(v: torch.Tensor) -> torch.Tensor:
    return normalize(v, eps=1e-30)


def reflect(direction: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Specular reflection D' = D - 2 (D.n) n."""
    return direction - 2.0 * dot(direction, normal)[..., None] * normal


def vector_rotate(a: torch.Tensor, b: torch.Tensor, theta) -> torch.Tensor:
    """Rodrigues rotation of vector(s) ``a`` about unit axis ``b`` by theta."""
    theta = torch.as_tensor(theta, dtype=a.dtype, device=a.device)
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    return a * c + cross(b, a) * s + b * dot(b, a)[..., None] * (1.0 - c)


def rotation_matrix(axis: torch.Tensor, theta) -> torch.Tensor:
    """Rotation matrix about a unit axis (quaternion-derived form)."""
    axis = normalize(axis, eps=1e-30)
    theta = torch.as_tensor(theta, dtype=axis.dtype, device=axis.device)
    a = torch.cos(theta / 2.0)
    bcd = -axis * torch.sin(theta / 2.0)
    b, c, d = bcd[0], bcd[1], bcd[2]
    rows = [
        [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
        [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
        [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def orthogonal_basis(normal: torch.Tensor, hint1: torch.Tensor,
                     hint2: torch.Tensor) -> torch.Tensor:
    """Per-ray orthonormal basis [N,3,3] with rows (o2, o1, normal), where
    ``o1 = cross(n, hint1) + cross(n, hint2)`` and ``o2 = cross(n, o1)``."""
    o1 = safe_normalize(cross(normal, hint1) + cross(normal, hint2))
    o2 = safe_normalize(cross(normal, o1))
    return torch.stack([o2, o1, normal], dim=-2)


def rotate_to_frame(local_dirs: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Map local [N,3] vectors through per-ray bases [N,3,3] (rows x,y,z)."""
    return torch.sum(local_dirs[:, :, None] * basis, dim=1)


def cylindrical_from_cartesian(p: torch.Tensor) -> torch.Tensor:
    """[..., 3] (x,y,z) -> (r, phi, z)."""
    r = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    phi = torch.atan2(p[..., 1], p[..., 0])
    return torch.stack([r, phi, p[..., 2]], dim=-1)


def cartesian_from_cylindrical(c: torch.Tensor) -> torch.Tensor:
    """[..., 3] (r, phi, z) -> (x,y,z)."""
    return torch.stack(
        [c[..., 0] * torch.cos(c[..., 1]), c[..., 0] * torch.sin(c[..., 1]),
         c[..., 2]],
        dim=-1,
    )


def toroidal_from_cartesian(p: torch.Tensor, major_radius) -> torch.Tensor:
    """(x,y,z) -> (minor radius rho, poloidal theta, toroidal phi) for a torus
    about the z-axis."""
    r = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    phi = torch.atan2(p[..., 1], p[..., 0])
    d = r - major_radius
    rho = torch.sqrt(d**2 + p[..., 2] ** 2)
    theta = torch.atan2(p[..., 2], d)
    return torch.stack([rho, theta, phi], dim=-1)


def cartesian_from_toroidal(t: torch.Tensor, major_radius) -> torch.Tensor:
    """(rho, theta, phi) -> (x,y,z); inverse of :func:`toroidal_from_cartesian`."""
    rho, theta, phi = t[..., 0], t[..., 1], t[..., 2]
    r = major_radius + rho * torch.cos(theta)
    z = rho * torch.sin(theta)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def sinusoidal_spiral(phi, b, r0, theta0):
    """Sinusoidal-spiral radius r(phi)."""
    return r0 * (torch.sin(theta0 + (b - 1) * phi) / torch.sin(theta0)) ** (
        1.0 / (b - 1)
    )


def point_in_triangle_2d(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor) -> torch.Tensor:
    """Barycentric inside-test for 2D points; p: [...,2], a/b/c: [2] or [...,2]."""

    def sign(p1, p2, p3):
        return (p1[..., 0] - p3[..., 0]) * (p2[..., 1] - p3[..., 1]) - (
            p2[..., 0] - p3[..., 0]
        ) * (p1[..., 1] - p3[..., 1])

    d1 = sign(p, a, b)
    d2 = sign(p, b, c)
    d3 = sign(p, c, a)
    has_neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
    has_pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
    return ~(has_neg & has_pos)
