"""Nearest-pixel binning kernel K2 (counterpart of
``xicsrt_tpu/ops/pallas_binning.py``, whose TPU kernel ``_bin_kernel`` it
replaces).

``bin_images_cuda`` launches the hand-written CUDA kernel
``csrc/bin_image.cu`` (a shared-memory atomic histogram) once for several
images over one or more ray sets, packed as offsets into one output, for
tensors on a CUDA device, and takes its plain PyTorch twin
:func:`bin_images_plain` for tensors on the CPU. Both cast to float32
first and compute the pixel coordinate as
:func:`~xicsrt_tpu_torch.ops.binning.pixel_coordinate` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from xicsrt_tpu_torch.ops import native
from xicsrt_tpu_torch.ops.binning import pixel_coordinate

MAX_ITEMS = 8  # the images one launch bins (csrc/bin_image.cu XRT_BIN_MAX_ITEMS)


def bin_image_plain(x_local: torch.Tensor, mask: torch.Tensor,
                    weight: torch.Tensor, nx: int, ny: int,
                    pixel_size: float) -> torch.Tensor:
    """The kernel's plain twin for one image: ``index_put_`` on the flat
    float32 image."""
    f32 = torch.float32
    px = torch.round(pixel_coordinate(x_local[:, 0].to(f32), pixel_size, nx))
    py = torch.round(pixel_coordinate(x_local[:, 1].to(f32), pixel_size, ny))
    ok = mask & (px >= 0) & (px < nx) & (py >= 0) & (py < ny)
    idx = px[ok].long() * ny + py[ok].long()
    flat = torch.zeros((nx * ny,), dtype=f32, device=x_local.device)
    flat.index_put_((idx,), weight[ok].to(f32), accumulate=True)
    return flat.reshape(nx, ny).to(x_local.dtype)


@dataclasses.dataclass
class PackedItems:
    """Images packed for one launch: each item's float32 contiguous rays
    (x_local, mask, weight), its grid ``(nx, ny)`` and pixel size, and its
    image's ``offset`` into one flat float32 output of ``total`` pixels;
    ``dtypes``: the dtype each image is returned in (its ``x_local``'s)."""

    rays: list
    shapes: list
    pixel_sizes: list
    offsets: list
    total: int
    dtypes: list

    def split(self, flat: torch.Tensor) -> list:
        """Each item's [nx, ny] image of the packed output ``flat``."""
        return [flat[o:o + nx * ny].reshape(nx, ny).to(dt)
                for o, (nx, ny), dt in zip(self.offsets, self.shapes, self.dtypes)]


def pack_items(items: list) -> PackedItems:
    """Check ``items`` (x_local [N, 3], mask [N] bool, weight [N], nx, ny,
    pixel_size; one device, N per item) and pack them: float32 contiguous
    rays, each image at the running offset."""
    if not items:
        raise ValueError("pack_items: no images")
    device = items[0][0].device
    rays, shapes, sizes, offsets, dtypes, total = [], [], [], [], [], 0
    for x_local, mask, weight, nx, ny, pixel_size in items:
        n = x_local.shape[0]
        if x_local.dim() != 2 or x_local.shape[1] != 3:
            raise ValueError(f"x_local must be [N, 3], got {tuple(x_local.shape)}")
        if mask.shape != (n,) or weight.shape != (n,):
            raise ValueError("mask and weight must be [N]")
        if mask.dtype != torch.bool:
            raise ValueError("mask must be bool")
        if not (mask.device == weight.device == x_local.device == device):
            raise ValueError("every item's x_local, mask and weight must share one device")
        nx, ny = int(nx), int(ny)
        rays.append((x_local.to(torch.float32).contiguous(), mask.contiguous(),
                     weight.to(torch.float32).contiguous()))
        shapes.append((nx, ny))
        sizes.append(float(pixel_size))
        offsets.append(total)
        dtypes.append(x_local.dtype)
        total += nx * ny
    return PackedItems(rays, shapes, sizes, offsets, total, dtypes)


def bin_images_plain(items: list, unit_weights: bool = False) -> list:
    """The kernel's plain twin: each item binned by :func:`bin_image_plain`
    into its place of one packed output (:func:`pack_items`), ones for its
    weights where ``unit_weights`` says every weight is one."""
    packed = pack_items(items)
    flat = torch.zeros(packed.total, dtype=torch.float32, device=packed.rays[0][0].device)
    for (xl, m, w), (nx, ny), ps, o in zip(packed.rays, packed.shapes, packed.pixel_sizes,
                                           packed.offsets):
        w = torch.ones_like(w) if unit_weights else w
        flat[o:o + nx * ny] = bin_image_plain(xl, m, w, nx, ny, ps).reshape(-1)
    return packed.split(flat)


def bin_images_cuda(items: list, unit_weights: bool = False) -> list:
    """Accumulate the ray hits of each item into its [nx, ny] image, one
    kernel launch for at most :data:`MAX_ITEMS` images (more take a launch
    each further :data:`MAX_ITEMS`).

    ``items``: (x_local [N, 3], mask [N] bool, weight [N], nx, ny,
    pixel_size), N per item. ``unit_weights``: every weight is one (the
    kernel counts in integers and reads no weight). On CUDA tensors this
    launches the kernel (or raises); on CPU tensors it returns
    :func:`bin_images_plain`.
    """
    if not items:
        return []
    device = items[0][0].device
    if device.type == "cpu":
        return bin_images_plain(items, unit_weights)
    if device.type != "cuda":
        raise ValueError(f"bin_images_cuda: unsupported device {device}")
    if len(items) > MAX_ITEMS:
        return (bin_images_cuda(items[:MAX_ITEMS], unit_weights)
                + bin_images_cuda(items[MAX_ITEMS:], unit_weights))
    packed = pack_items(items)
    out = torch.zeros(packed.total, dtype=torch.float32, device=device)
    k = len(items)
    ptrs = np.array([[xl.data_ptr(), m.data_ptr(), 0 if unit_weights else w.data_ptr()]
                     for xl, m, w in packed.rays], dtype=np.uint64)
    n = np.array([xl.shape[0] for xl, _, _ in packed.rays], dtype=np.int64)
    shape = np.array([(nx, ny, o) for (nx, ny), o in zip(packed.shapes, packed.offsets)],
                     dtype=np.int32)
    scale = np.array([(np.float32(1.0) / np.float32(ps), (nx - 1) / 2.0, (ny - 1) / 2.0)
                      for ps, (nx, ny) in zip(packed.pixel_sizes, packed.shapes)],
                     dtype=np.float32)
    if n.max() > 0:
        err = native.library().xrt_bin_images(
            ptrs.ctypes.data, n.ctypes.data, shape.ctypes.data, scale.ctypes.data, k,
            int(unit_weights), out.data_ptr(), packed.total,
            torch.cuda.current_stream(device).cuda_stream)
        native.check(err, "xrt_bin_images")
        bin_images_cuda.launches += 1
    return packed.split(out)


bin_images_cuda.launches = 0
