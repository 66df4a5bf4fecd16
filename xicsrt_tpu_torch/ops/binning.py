"""Detector pixel binning (``xicsrt_tpu/ops/binning.py``).

Pixel convention of the reference (``_TraceObject.py:257-291``): local
coordinates are divided by ``pixel_size`` and shifted so that channel (0,0)
is centered on the bottom-left pixel. ``nearest`` rounds half to even to the
nearest channel; ``bilinear`` splats each hit onto its four neighbouring
channels, so the image is piecewise linear in the hit position and
differentiable. Out-of-grid hits (or corners) are dropped.
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
    # Only rays on the grid scatter: sending the rest to one pixel with
    # weight 0 serialises index_put's accumulation on CUDA.
    idx = px[ok].long() * ny + py[ok].long()
    flat = torch.zeros((nx * ny,), dtype=x_local.dtype, device=x_local.device)
    flat.index_put_((idx,), weight[ok].to(x_local.dtype), accumulate=True)
    return flat.reshape(nx, ny)


def bilinear_coordinate(x: torch.Tensor, pixel_size: float, n: int) -> torch.Tensor:
    """Fractional pixel coordinate of the bilinear splat, as the JAX package
    computes ``x / pixel_size + (n - 1) / 2`` (``binning.py:439``) under
    ``jit``: in float32 the fused multiply-add of :func:`pixel_coordinate`;
    in float64 the true division (XLA's float64 result is within one ulp)."""
    if x.dtype == torch.float32:
        return pixel_coordinate(x, pixel_size, n)
    return x / pixel_size + (n - 1) / 2.0


def corners(p: torch.Tensor):
    """The two grid neighbours of fractional coordinates ``p``:
    ((index, tent value, tent slope), ...) as float tensors.

    The tent ``max(0, 1 - |p - i|)`` has slope ``-sign(p - i)`` on its open
    support and 0 at the kinks and the apex (``binning.py:153-160``), so an
    integer ``p`` takes slope 0 at both neighbours."""
    p0 = torch.floor(p)
    f = p - p0
    moving = (f > 0).to(p.dtype)
    return ((p0, 1.0 - f, -moving), (p0 + 1.0, f, moving))


def corner_index(cx, cy, nx: int, ny: int):
    """Flat index of corner (cx, cy) and whether it lies on the grid; NaN
    fails the test, and off-grid corners index pixel 0."""
    ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
    zero = torch.zeros_like(cx)
    idx = torch.where(ok, cx, zero).long() * ny + torch.where(ok, cy, zero).long()
    return idx, ok


def splat_bilinear(px: torch.Tensor, py: torch.Tensor, w: torch.Tensor,
                   nx: int, ny: int) -> torch.Tensor:
    """``image[i, j] = sum_r w[r] tent(px[r] - i) tent(py[r] - j)`` over the
    four corners of each ray, by ``index_put``; differentiable in ``w``
    (and in ``px``, ``py`` through the corner fractions)."""
    flat = torch.zeros((nx * ny,), dtype=w.dtype, device=w.device)
    for cx, tx, _ in corners(px):
        for cy, ty, _ in corners(py):
            idx, ok = corner_index(cx, cy, nx, ny)
            # Only on-grid corners scatter: sending the rest to pixel 0 with
            # weight 0 serialises index_put's accumulation on CUDA.
            flat = flat.index_put((idx[ok],), (w * tx * ty)[ok], accumulate=True)
    return flat.reshape(nx, ny)


def bin_image_bilinear(x_local: torch.Tensor, mask: torch.Tensor,
                       weight: torch.Tensor, nx: int, ny: int,
                       pixel_size: float) -> torch.Tensor:
    """Bilinear splat of each hit onto its four neighbouring pixels
    (``binning.py:422-457``); autograd differentiates it as written."""
    px = bilinear_coordinate(x_local[:, 0], pixel_size, nx)
    py = bilinear_coordinate(x_local[:, 1], pixel_size, ny)
    w = torch.where(mask, weight, torch.zeros_like(weight)).to(x_local.dtype)
    return splat_bilinear(px, py, w, nx, ny)


def tent_transpose(px, py, w, g, nx: int, ny: int):
    """Cotangents (dpx, dpy, dw) of ``sum(g * splat_bilinear(px, py, w))``,
    gathered from the four corner cotangents of each ray: ``dw = TX g TY^T``,
    ``dpx = w (TX' g TY^T)``, ``dpy = w (TX g TY'^T)`` (``binning.py:170-275``).
    O(N) work and memory; no tent matrix is formed."""
    g = g.reshape(-1).to(w.dtype)
    dw = torch.zeros_like(w)
    sx = torch.zeros_like(w)
    sy = torch.zeros_like(w)
    for cx, tx, dtx in corners(px):
        for cy, ty, dty in corners(py):
            idx, ok = corner_index(cx, cy, nx, ny)
            gc = torch.where(ok, g[idx], 0.0)
            dw = dw + tx * ty * gc
            sx = sx + dtx * ty * gc
            sy = sy + tx * dty * gc
    return w * sx, w * sy, dw


class TentImages(torch.autograd.Function):
    """Several bilinear images over one ray axis, with the tent-transpose
    backward of ``_tent_images`` (``binning.py:170-275``): it keeps the O(N)
    residuals (px, py, w) and recomputes the corners.

    ``apply(shapes, px_0, py_0, w_0, px_1, ...)`` with ``shapes`` a tuple of
    (nx, ny); returns the tuple of [nx, ny] images.
    """

    @staticmethod
    def forward(ctx, shapes, *tensors):
        ctx.shapes = shapes
        ctx.save_for_backward(*tensors)
        return tuple(splat_bilinear(*tensors[3 * k:3 * k + 3], nx, ny)
                     for k, (nx, ny) in enumerate(shapes))

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        out = [None]
        for k, (nx, ny) in enumerate(ctx.shapes):
            px, py, w = tensors[3 * k:3 * k + 3]
            out.extend(tent_transpose(px, py, w, grads[k], nx, ny))
        return tuple(out)


def bin_images_fused(items: list, image_mode: str = "nearest",
                     impl: str = "xla", unit_weights: bool = False) -> list:
    """Bin several images over one ray axis.

    ``items``: list of (x_local, mask, weight, nx, ny, pixel_size).
    ``image_mode='bilinear'`` splats through :class:`TentImages` (plain
    PyTorch: the JAX package's bilinear path is XLA, not a Pallas kernel).
    For ``'nearest'``, ``impl``: 'xla' scatters with :func:`bin_image`;
    'pallas' calls the CUDA binning kernel once for every image
    (``ops/pallas_binning.bin_images_cuda``; ``unit_weights``: every weight
    is one, as in mc transport), which takes its plain twin for tensors on
    the CPU, as the JAX package bins by scatter on its CPU backend
    (``binning.py:307-308``).
    """
    if image_mode == "bilinear":
        if not items:
            return []
        shapes, tensors = [], []
        for x_local, mask, weight, nx, ny, pixel_size in items:
            shapes.append((int(nx), int(ny)))
            tensors += [bilinear_coordinate(x_local[:, 0], pixel_size, nx),
                        bilinear_coordinate(x_local[:, 1], pixel_size, ny),
                        torch.where(mask, weight, torch.zeros_like(weight))
                        .to(x_local.dtype)]
        return list(TentImages.apply(tuple(shapes), *tensors))
    if image_mode != "nearest":
        raise ValueError(f"Unknown image_mode: {image_mode}")
    if impl == "pallas":
        from xicsrt_tpu_torch.ops.pallas_binning import bin_images_cuda

        return bin_images_cuda(items, unit_weights)
    return [bin_image(*item) for item in items]
