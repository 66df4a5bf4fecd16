"""Ray bundles as a dataclass of tensors (``xicsrt_tpu/rays.py``).

Structure of arrays with a fixed leading dimension ``N``: dead rays are
masked, never compacted.
"""

from __future__ import annotations

import dataclasses

import torch

from xicsrt_tpu_torch.dispatch import default_device


@dataclasses.dataclass(frozen=True)
class Rays:
    """A bundle of N rays.

    origin [N, 3], direction [N, 3] (unit), wavelength [N] (Angstrom),
    weight [N] (1.0 in mc transport), mask [N] bool (True while alive).
    """

    origin: torch.Tensor
    direction: torch.Tensor
    wavelength: torch.Tensor
    weight: torch.Tensor
    mask: torch.Tensor

    @property
    def n(self) -> int:
        return self.origin.shape[0]

    @property
    def dtype(self):
        return self.origin.dtype

    @property
    def device(self):
        return self.origin.device

    def replace(self, **kwargs) -> "Rays":
        return dataclasses.replace(self, **kwargs)

    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.mask)

    def to_dict(self) -> dict:
        """Export to the reference dict-of-arrays layout."""
        return {
            "origin": self.origin,
            "direction": self.direction,
            "wavelength": self.wavelength,
            "weight": self.weight,
            "mask": self.mask,
        }


def zero_rays(n: int, dtype=torch.float32, device=None) -> Rays:
    """An all-dead bundle of ``n`` rays (``xicsrt_tpu.rays.zero_rays``,
    mirroring ``RayArray.zeros``), with the weight field present (ones).
    ``device``: by default CUDA, raising without it
    (``dispatch.default_device``)."""
    device = default_device(device)
    return Rays(
        origin=torch.zeros((n, 3), dtype=dtype, device=device),
        direction=torch.zeros((n, 3), dtype=dtype, device=device),
        wavelength=torch.zeros((n,), dtype=dtype, device=device),
        weight=torch.ones((n,), dtype=dtype, device=device),
        mask=torch.zeros((n,), dtype=torch.bool, device=device),
    )


def concatenate(bundles: list) -> Rays:
    """Concatenate bundles along the ray axis."""
    return Rays(
        origin=torch.cat([b.origin for b in bundles], dim=0),
        direction=torch.cat([b.direction for b in bundles], dim=0),
        wavelength=torch.cat([b.wavelength for b in bundles], dim=0),
        weight=torch.cat([b.weight for b in bundles], dim=0),
        mask=torch.cat([b.mask for b in bundles], dim=0),
    )
