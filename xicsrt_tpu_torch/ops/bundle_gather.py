"""Interval-indexed bundle gather K4 (counterpart of
``xicsrt_tpu/ops/bundle_gather.py``, whose TPU kernel ``interval_gather``
it replaces).

Plasma sources assign ray ``r`` to the bundle ``b`` whose cumulative-count
interval ``cum[b-1] <= r < cum[b]`` holds it and read the bundle's
attributes (origin, cone half-angle, temperature, velocity). Rays at or past
``cum[-1]`` get all-zero rows.

``interval_gather_cuda`` launches the hand-written CUDA kernel
``csrc/bundle_gather.cu`` (a warp's 32 rays search their bundles together,
then store their rows lane-contiguous) for tensors on a CUDA device, and takes the plain twin :func:`interval_gather_plain` (the
indexed gather of ``interval_gather_xla``) for tensors on the CPU. The
result is a copy of table rows, so kernel and twin agree bit for bit. On the
card, a table that requires grad goes through the kernel forward and a plain
scatter-add backward (the TPU kernel had no backward of its own).
"""

from __future__ import annotations

import torch

from xicsrt_tpu_torch.ops import native

_K = 8


def bundle_rows(cum: torch.Tensor, table: torch.Tensor, idx: torch.Tensor):
    """``table[b(idx)]`` for int ray indices ``idx``, zero rows where
    ``idx >= cum[-1]``."""
    b = torch.searchsorted(cum, idx.to(cum.dtype), right=True)
    rows = table[torch.clamp_max(b, table.shape[0] - 1)]
    valid = (idx < cum[-1])[:, None]
    return torch.where(valid, rows, rows.new_zeros(()))


def interval_gather_plain(cum: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's plain twin: ``searchsorted(right)``, clip, gather, and
    zero rows at or past ``cum[-1]`` (``interval_gather_xla``, JAX
    ``bundle_gather.py:128-136``). ``cum``: (B,) int32; ``table``: (B, K)."""
    return bundle_rows(cum, table, torch.arange(n, dtype=torch.int64, device=cum.device))


def _launch(cum: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
    B, K = table.shape
    t8 = table.detach().to(torch.float32)
    if K < _K:
        t8 = torch.nn.functional.pad(t8, (0, _K - K))
    t8 = t8.contiguous()
    c = cum.contiguous()
    out = torch.empty((n, _K), dtype=torch.float32, device=table.device)
    if n == 0:
        return out[:, :K]
    err = native.library().xrt_bundle_gather(
        c.data_ptr(), t8.data_ptr(), B, n, out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    native.check(err, "xrt_bundle_gather")
    interval_gather_cuda.launches += 1
    return out[:, :K]


class _GatherWithGrad(torch.autograd.Function):
    """K4 forward; the backward scatters row gradients into the table."""

    @staticmethod
    def forward(ctx, cum, table, n):
        ctx.save_for_backward(cum)
        ctx.n_bundles = table.shape[0]
        return _launch(cum, table, n)

    @staticmethod
    def backward(ctx, grad):
        (cum,) = ctx.saved_tensors
        idx = torch.arange(grad.shape[0], device=grad.device)
        b = torch.clamp_max(torch.searchsorted(cum, idx.to(cum.dtype), right=True),
                            ctx.n_bundles - 1)
        valid = idx < cum[-1]
        out = grad.new_zeros((ctx.n_bundles, grad.shape[1]))
        return None, out.index_add_(0, b[valid], grad[valid]), None


def interval_gather_cuda(cum: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
    """``attrs[r] = table[b(r)]`` for rays ``0 <= r < n``.

    ``cum``: (B,) int32 inclusive cumulative counts; ``table``: (B, K<=8)
    float32. Returns (n, K) float32. CUDA tensors launch kernel K4 (or
    raise); CPU tensors take :func:`interval_gather_plain`.
    """
    if table.device.type == "cpu":
        return interval_gather_plain(cum, table, n)
    if table.device.type != "cuda":
        raise ValueError(f"interval_gather_cuda: unsupported device {table.device}")
    if cum.device != table.device:
        raise ValueError("interval_gather_cuda: cum and table must share one device")
    if cum.dtype != torch.int32 or cum.dim() != 1 or cum.numel() < 1:
        raise ValueError("interval_gather_cuda: cum must be a non-empty (B,) int32 tensor")
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] != cum.numel():
        raise ValueError("interval_gather_cuda: table must be (B, K) float32")
    if table.shape[1] > _K:
        raise ValueError("interval_gather_cuda supports at most 8 attributes")
    if not 0 <= n < 2**31:
        raise ValueError("interval_gather_cuda: n must be in [0, 2^31)")
    if table.requires_grad and torch.is_grad_enabled():
        return _GatherWithGrad.apply(cum, table, n)
    return _launch(cum, table, n)


interval_gather_cuda.launches = 0
