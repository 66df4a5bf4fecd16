"""Coordinate frames for optical elements (``xicsrt_tpu/geometry.py``).

An element pose is ``origin`` plus a row-matrix ``basis`` whose rows are the
local x/y/z axes in global coordinates. The transforms are written as the
same broadcast multiplies and adds as the JAX package, so both round alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Frame:
    """Pose of an element: origin [3] and basis [3,3] (rows = x,y,z axes)."""

    origin: torch.Tensor
    basis: torch.Tensor

    @property
    def xaxis(self) -> torch.Tensor:
        return self.basis[0]

    @property
    def yaxis(self) -> torch.Tensor:
        return self.basis[1]

    @property
    def zaxis(self) -> torch.Tensor:
        return self.basis[2]

    def vector_to_external(self, v: torch.Tensor) -> torch.Tensor:
        """Local components -> global vector. v: [..., 3]."""
        return (
            v[..., 0:1] * self.basis[0]
            + v[..., 1:2] * self.basis[1]
            + v[..., 2:3] * self.basis[2]
        )

    def vector_to_local(self, v: torch.Tensor) -> torch.Tensor:
        """Global vector -> local components. v: [..., 3]."""
        return torch.stack(
            [
                torch.sum(v * self.basis[0], dim=-1),
                torch.sum(v * self.basis[1], dim=-1),
                torch.sum(v * self.basis[2], dim=-1),
            ],
            dim=-1,
        )

    def point_to_external(self, p: torch.Tensor) -> torch.Tensor:
        return self.vector_to_external(p) + self.origin

    def point_to_local(self, p: torch.Tensor) -> torch.Tensor:
        return self.vector_to_local(p - self.origin)


def default_xaxis(zaxis: np.ndarray) -> np.ndarray:
    """``cross([0,0,1], zaxis)`` normalized, or [1,0,0] for a vertical z-axis."""
    zaxis = np.asarray(zaxis, dtype=np.float64)
    xaxis = np.cross(np.array([0.0, 0.0, 1.0]), zaxis)
    norm = np.linalg.norm(xaxis)
    if norm < 1e-12:
        return np.array([1.0, 0.0, 0.0])
    return xaxis / norm


def frame_from_config(origin, zaxis, xaxis=None, dtype=torch.float32,
                      device="cpu") -> Frame:
    """Build a Frame from config entries, validating orthogonality.

    Computed in float64 on the host and rounded once to ``dtype``, as
    ``xicsrt_tpu.geometry.frame_from_config`` does; the y-axis is
    ``cross(zaxis, xaxis)``.
    """
    origin = np.asarray(origin, dtype=np.float64)
    zaxis = np.asarray(zaxis, dtype=np.float64)
    zn = np.linalg.norm(zaxis)
    if zn == 0:
        raise ValueError("zaxis must be a non-zero vector.")
    zaxis = zaxis / zn
    if xaxis is None:
        xaxis = default_xaxis(zaxis)
    else:
        xaxis = np.asarray(xaxis, dtype=np.float64)
        if not np.isclose(np.dot(zaxis, xaxis), 0.0, atol=1e-8):
            raise ValueError("zaxis and xaxis are not orthogonal.")
        xaxis = xaxis / np.linalg.norm(xaxis)
    yaxis = np.cross(zaxis, xaxis)
    basis = np.stack([xaxis, yaxis, zaxis], axis=0)
    return Frame(
        origin=torch.as_tensor(origin, dtype=dtype, device=device),
        basis=torch.as_tensor(basis, dtype=dtype, device=device),
    )
