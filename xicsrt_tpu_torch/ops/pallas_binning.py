"""Nearest-pixel binning kernel K2 (counterpart of
``xicsrt_tpu/ops/pallas_binning.py``, whose TPU kernel ``_bin_kernel`` it
replaces).

``bin_image_cuda`` launches the hand-written CUDA kernel
``csrc/bin_image.cu`` (a shared-memory atomic histogram) for tensors on a
CUDA device, and takes its plain PyTorch twin :func:`bin_image_plain` for
tensors on the CPU. Both cast to float32 first and compute the pixel
coordinate as :func:`~xicsrt_tpu_torch.ops.binning.pixel_coordinate` does.
"""

from __future__ import annotations

import numpy as np
import torch

from xicsrt_tpu_torch.ops import native
from xicsrt_tpu_torch.ops.binning import pixel_coordinate


def bin_image_plain(x_local: torch.Tensor, mask: torch.Tensor,
                    weight: torch.Tensor, nx: int, ny: int,
                    pixel_size: float) -> torch.Tensor:
    """The kernel's plain twin: ``index_put_`` on the flat float32 image."""
    f32 = torch.float32
    px = torch.round(pixel_coordinate(x_local[:, 0].to(f32), pixel_size, nx))
    py = torch.round(pixel_coordinate(x_local[:, 1].to(f32), pixel_size, ny))
    ok = mask & (px >= 0) & (px < nx) & (py >= 0) & (py < ny)
    idx = px[ok].long() * ny + py[ok].long()
    flat = torch.zeros((nx * ny,), dtype=f32, device=x_local.device)
    flat.index_put_((idx,), weight[ok].to(f32), accumulate=True)
    return flat.reshape(nx, ny).to(x_local.dtype)


def bin_image_cuda(x_local: torch.Tensor, mask: torch.Tensor,
                   weight: torch.Tensor, nx: int, ny: int,
                   pixel_size: float) -> torch.Tensor:
    """Accumulate ray hits into an [nx, ny] image.

    ``x_local``: [N, 3] local hit coordinates; ``mask``: [N] bool;
    ``weight``: [N]. On a CUDA tensor this launches the kernel (or raises);
    on a CPU tensor it returns :func:`bin_image_plain`.
    """
    if x_local.device.type == "cpu":
        return bin_image_plain(x_local, mask, weight, nx, ny, pixel_size)
    if x_local.device.type != "cuda":
        raise ValueError(f"bin_image_cuda: unsupported device {x_local.device}")
    n = x_local.shape[0]
    if x_local.dim() != 2 or x_local.shape[1] != 3:
        raise ValueError(f"x_local must be [N, 3], got {tuple(x_local.shape)}")
    if mask.shape != (n,) or weight.shape != (n,):
        raise ValueError("mask and weight must be [N]")
    if mask.dtype != torch.bool:
        raise ValueError("mask must be bool")
    if not (mask.device == weight.device == x_local.device):
        raise ValueError("x_local, mask and weight must share one device")
    xl = x_local.to(torch.float32).contiguous()
    m = mask.contiguous()
    w = weight.to(torch.float32).contiguous()
    nx, ny = int(nx), int(ny)
    out = torch.zeros((nx, ny), dtype=torch.float32, device=x_local.device)
    if n == 0:
        return out.to(x_local.dtype)
    err = native.library().xrt_bin_image(
        xl.data_ptr(), m.data_ptr(), w.data_ptr(), n, nx, ny,
        float(np.float32(1.0) / np.float32(pixel_size)),
        (nx - 1) / 2.0, (ny - 1) / 2.0, out.data_ptr(),
        torch.cuda.current_stream(x_local.device).cuda_stream,
    )
    native.check(err, "xrt_bin_image")
    bin_image_cuda.launches += 1
    return out.to(x_local.dtype)


bin_image_cuda.launches = 0
