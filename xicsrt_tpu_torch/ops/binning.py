"""Detector pixel binning (``xicsrt_tpu/ops/binning.py``), nearest mode.

Pixel convention of the reference (``_TraceObject.py:257-291``): local
coordinates are divided by ``pixel_size`` and shifted so that channel (0,0)
is centered on the bottom-left pixel; hits round half to even to the nearest
channel; out-of-grid hits are dropped.
"""

from __future__ import annotations

import numpy as np
import torch


def fused_multiply_add(x: torch.Tensor, scale: float, offset: float) -> torch.Tensor:
    """``x * scale + offset`` rounded once, as a fused multiply-add (CUDA
    ``fmaf``) rounds it. Float32 is evaluated in float64, where the product
    is exact, then rounded to float32."""
    if x.dtype == torch.float32:
        return (x.double() * scale + offset).float()
    return x * scale + offset


def pixel_coordinate(x: torch.Tensor, pixel_size: float, n: int) -> torch.Tensor:
    """Fractional pixel coordinate ``x / pixel_size + (n - 1) / 2``, as the
    JAX package computes it under ``jit``: XLA turns the division by a
    constant into a multiply by the reciprocal of the float32 pixel size,
    fused with the add (``binning.py:36``, ``pallas_binning.py:79``)."""
    inv = float(np.float32(1.0) / np.float32(pixel_size))
    return fused_multiply_add(x, inv, (n - 1) / 2.0)


def bin_image(x_local: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
              nx: int, ny: int, pixel_size: float) -> torch.Tensor:
    """Accumulate ray hits into an [nx, ny] image by ``index_put_``."""
    px = torch.round(pixel_coordinate(x_local[:, 0], pixel_size, nx))
    py = torch.round(pixel_coordinate(x_local[:, 1], pixel_size, ny))
    ok = mask & (px >= 0) & (px < nx) & (py >= 0) & (py < ny)
    # Masked-out rays scatter weight 0 into pixel (0, 0).
    zero = torch.zeros_like(px)
    idx = (torch.where(ok, px, zero).long() * ny
           + torch.where(ok, py, zero).long())
    w = torch.where(ok, weight, torch.zeros_like(weight)).to(x_local.dtype)
    flat = torch.zeros((nx * ny,), dtype=x_local.dtype, device=x_local.device)
    flat.index_put_((idx,), w, accumulate=True)
    return flat.reshape(nx, ny)


def bin_images_fused(items: list, image_mode: str = "nearest",
                     impl: str = "xla") -> list:
    """Bin several images over one ray axis.

    ``items``: list of (x_local, mask, weight, nx, ny, pixel_size).
    ``impl``: 'xla' scatters with :func:`bin_image`; 'pallas' calls the
    CUDA binning kernel (``ops/pallas_binning.bin_image_cuda``), which takes
    its plain twin for tensors on the CPU, as the JAX package bins by
    scatter on its CPU backend (``binning.py:307-308``).
    """
    if image_mode != "nearest":
        raise NotImplementedError(
            f"image_mode {image_mode!r} is not ported yet (nearest only).")
    if impl == "pallas":
        from xicsrt_tpu_torch.ops.pallas_binning import bin_image_cuda

        return [bin_image_cuda(*item) for item in items]
    return [bin_image(*item) for item in items]
