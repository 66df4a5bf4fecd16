"""Class-rate probes R1 and R2 of the roofline tool (counterparts of the TPU
kernels ``elem_rate.kernel`` and ``mm_kernel`` in ``tools/roofline.py``'s
``microbench_rates``, which they replace).

R1 (:func:`elem_rate_cuda`, ``csrc/roofline_probes.cu``) measures an
elementwise class's rate: every element of an (n_chunks, 8, sub) grid runs
``streams`` independent chains of ``K`` steps of one body, and the row sums
of the chains' totals land in an (8, 128) output, each column holding its
row's sum. The bodies (:data:`BODIES`) are the TPU kernel's, as the port's
kernels write them: ``rsqrt`` is ``1 / sqrt``. R2 (:func:`mma_rate_cuda`)
measures the tensor cores' bf16 MAC rate: per grid step ``K_mm`` products
``acc += A B^T`` with the value feedback ``A <- bf16(A (1 + acc[0,0]
1e-20))``, summed over the grid into a (128, 128) output. Both make their
inputs from the grid index and a scalar seed, so no input buffer is read.

The wrappers take the seed as a (1,) float32 tensor: on a CUDA device they
launch the kernels (or raise); on the CPU they take the plain versions
:func:`elem_rate_plain` and :func:`mma_rate_plain`, which compute the same
outputs with PyTorch in float32 in another summation order. Defaults are
the TPU tool's sizes.
"""

from __future__ import annotations

import torch

from xicsrt_tpu_torch.ops import native

f32 = torch.float32

# The TPU tool's sizes (tools/roofline.py:242-342): sub 1024 lanes, K 128
# steps; 512 grid steps of 4 streams for the exp and rsqrt bodies, 4096 of
# 8 for the simple one; R2 64 products a step over 8192 steps.
SUB = 1024
K_STEPS = 128
ELEM_SIZES = {"trans": (512, 4), "sqrtdiv": (512, 4), "simple": (4096, 8)}
K_MM = 64
N_MM = 8192
MM_ROWS = 128
MM_STEPS_PER_BATCH = 256  # the grid steps mma_rate_plain runs at a time
MM_SUB_STEP = 64  # R2's kernel takes its k slices of 16 four at a time

_BODY_CODE = {"trans": 0, "sqrtdiv": 1, "simple": 2}
_ELEM_THREADS = 256


def _trans(y):
    return torch.exp(y * -0.9)


def _sqrtdiv(y):
    return torch.reciprocal(torch.sqrt(torch.abs(y) + 1.0))


def _simple(y):
    return torch.where(y > 0.1, y * 0.9999 + 1e-6, y + 1e-3)


# R1's bodies (tools/roofline.py:330-334), one step of one chain each.
BODIES = {"trans": _trans, "sqrtdiv": _sqrtdiv, "simple": _simple}


def _elem_sizes(body: str, n_chunks, streams) -> tuple:
    if body not in BODIES:
        raise ValueError(f"body must be one of {sorted(BODIES)}, got {body!r}")
    default_chunks, default_streams = ELEM_SIZES[body]
    return (default_chunks if n_chunks is None else int(n_chunks),
            default_streams if streams is None else int(streams))


def _check_seed(seed: torch.Tensor, name: str) -> None:
    if seed.dtype != f32 or tuple(seed.shape) != (1,):
        raise ValueError(f"{name}: seed must be a (1,) float32 tensor")


def elem_steps(body: str, n_chunks=None, K: int = K_STEPS, streams=None,
               sub: int = SUB) -> int:
    """Body steps one R1 call runs: elements x streams x K."""
    n_chunks, streams = _elem_sizes(body, n_chunks, streams)
    return n_chunks * 8 * sub * streams * K


def elem_chains_plain(seed: torch.Tensor, body: str, n_chunks=None, K: int = K_STEPS,
                      streams=None, sub: int = SUB) -> torch.Tensor:
    """R1's chains in float32: the (n_chunks, 8, sub) totals of each
    element's streams. Step ``i``'s element ``(r, l)`` starts stream ``s``
    at ``(l + 7919 i) 1e-6 + seed (1 + 0.1 s)`` (the scale rounded once to
    float32) and takes ``K`` steps of the body; the streams' values are
    added in stream order, as the kernel adds them."""
    n_chunks, streams = _elem_sizes(body, n_chunks, streams)
    step = BODIES[body]
    dev = seed.device
    i = torch.arange(n_chunks, device=dev)[:, None, None]
    lane = torch.arange(sub, device=dev)
    base = ((lane + 7919 * i).to(f32) * 1e-6).expand(n_chunks, 8, sub)
    scale = torch.tensor([1.0 + 0.1 * s for s in range(streams)], dtype=f32, device=dev)
    y = base + (seed * scale)[:, None, None, None]
    for _ in range(K):
        y = step(y)
    tot = y[0]
    for s in range(1, streams):
        tot = tot + y[s]
    return tot


def elem_rate_plain(seed: torch.Tensor, body: str, n_chunks=None, K: int = K_STEPS,
                    streams=None, sub: int = SUB) -> torch.Tensor:
    """R1's plain version: the (8, 128) float32 output, the chains
    (:func:`elem_chains_plain`) summed over the lanes and the steps."""
    rows = elem_chains_plain(seed, body, n_chunks, K, streams, sub).sum(dim=2).sum(dim=0)
    return rows[:, None].expand(8, 128).clone()


def elem_rate_cuda(seed: torch.Tensor, body: str, n_chunks=None, K: int = K_STEPS,
                   streams=None, sub: int = SUB) -> torch.Tensor:
    """R1: the (8, 128) float32 output of ``body`` ('trans', 'sqrtdiv' or
    'simple') on the (n_chunks, 8, sub) grid. A seed on a CUDA device
    launches the kernel (or raises); on the CPU it takes
    :func:`elem_rate_plain`. ``streams`` is 1, 2, 4 or 8, ``sub`` a multiple
    of 256."""
    n_chunks, streams = _elem_sizes(body, n_chunks, streams)
    _check_seed(seed, "elem_rate_cuda")
    if seed.device.type == "cpu":
        return elem_rate_plain(seed, body, n_chunks, K, streams, sub)
    if seed.device.type != "cuda":
        raise ValueError(f"elem_rate_cuda: unsupported device {seed.device}")
    if streams not in (1, 2, 4, 8):
        raise ValueError("elem_rate_cuda: streams must be 1, 2, 4 or 8")
    if sub <= 0 or sub % _ELEM_THREADS:
        raise ValueError("elem_rate_cuda: sub must be a positive multiple of 256")
    if n_chunks <= 0 or K < 0 or 7919 * (n_chunks - 1) + sub >= 2**31:
        raise ValueError("elem_rate_cuda: n_chunks >= 1, K >= 0 and int32 start indices")
    seed = seed.contiguous()
    partial = torch.empty(n_chunks * 8 * sub // _ELEM_THREADS, dtype=f32, device=seed.device)
    out = torch.empty((8, 128), dtype=f32, device=seed.device)
    err = native.library().xrt_elem_rate(
        _BODY_CODE[body], streams, seed.data_ptr(), n_chunks, sub, K, partial.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(seed.device).cuda_stream)
    native.check(err, "xrt_elem_rate")
    elem_rate_cuda.launches += 1
    elem_rate_cuda.body_launches[body] += 1
    return out


elem_rate_cuda.launches = 0
elem_rate_cuda.body_launches = {body: 0 for body in BODIES}


def mma_macs(n_mm: int = N_MM, K_mm: int = K_MM, sub: int = SUB) -> int:
    """MACs one R2 call does: n_mm x K_mm products of (128, sub) x (sub, 128)."""
    return n_mm * K_mm * MM_ROWS * 128 * sub


def mma_rate_plain(seed: torch.Tensor, n_mm: int = N_MM, K_mm: int = K_MM,
                   sub: int = SUB) -> torch.Tensor:
    """R2's plain version: the (128, 128) float32 output. Step ``i``'s A
    (128, sub) is ``bf16((c + i) 1e-6 + seed)``, B (128, sub) ``bf16(q
    1e-4)``; ``K_mm`` times ``acc += A B^T`` in float32 on the bf16 values,
    each followed by ``A <- bf16(A (1 + acc[0, 0] 1e-20))``; the steps'
    ``acc`` summed. The products of bf16 values are exact in float32; only
    the summation order differs from the kernel's. Steps run
    ``MM_STEPS_PER_BATCH`` at a time, to bound the memory."""
    dev = seed.device
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("mma_rate_plain: needs float32 matmuls, not TF32")
    bf16 = torch.bfloat16
    c = torch.arange(sub, device=dev)
    bt = (torch.arange(128, device=dev).to(f32) * 1e-4).to(bf16)[None, :].expand(sub, 128)
    bt = bt.to(f32)
    out = torch.zeros((MM_ROWS, 128), dtype=f32, device=dev)
    for start in range(0, n_mm, MM_STEPS_PER_BATCH):
        i = torch.arange(start, min(start + MM_STEPS_PER_BATCH, n_mm), device=dev)
        a = ((c[None, :] + i[:, None]).to(f32) * 1e-6 + seed).to(bf16)
        a = a[:, None, :].expand(i.numel(), MM_ROWS, sub)
        acc = torch.zeros((i.numel(), MM_ROWS, 128), dtype=f32, device=dev)
        for _ in range(K_mm):
            acc = acc + torch.matmul(a.to(f32), bt)
            a = (a.to(f32) * (1.0 + acc[:, :1, :1] * 1e-20)).to(bf16)
        out = out + acc.sum(dim=0)
    return out


def mma_rate_cuda(seed: torch.Tensor, n_mm: int = N_MM, K_mm: int = K_MM,
                  sub: int = SUB) -> torch.Tensor:
    """R2: the (128, 128) float32 output on the tensor cores (wgmma bf16
    m64n128k16). A seed on a CUDA device launches the kernel (or raises); on
    the CPU it takes :func:`mma_rate_plain`. ``sub`` is a multiple of 64, at
    most 16384."""
    _check_seed(seed, "mma_rate_cuda")
    if seed.device.type == "cpu":
        return mma_rate_plain(seed, n_mm, K_mm, sub)
    if seed.device.type != "cuda":
        raise ValueError(f"mma_rate_cuda: unsupported device {seed.device}")
    if n_mm <= 0 or K_mm < 0 or sub <= 0 or sub % MM_SUB_STEP or sub > 16384:
        raise ValueError(f"mma_rate_cuda: n_mm >= 1, K_mm >= 0, sub a multiple of "
                         f"{MM_SUB_STEP} up to 16384")
    lib = native.library()
    blocks = lib.xrt_mma_rate_blocks(n_mm)
    seed = seed.contiguous()
    partial = torch.empty((blocks, MM_ROWS, 128), dtype=f32, device=seed.device)
    out = torch.empty((MM_ROWS, 128), dtype=f32, device=seed.device)
    err = lib.xrt_mma_rate(seed.data_ptr(), n_mm, K_mm, sub, partial.data_ptr(), blocks,
                           out.data_ptr(), torch.cuda.current_stream(seed.device).cuda_stream)
    native.check(err, "xrt_mma_rate")
    mma_rate_cuda.launches += 1
    return out


mma_rate_cuda.launches = 0
