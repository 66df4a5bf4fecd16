"""K1's least time a call, from its own element counts.

The bound of a call is the larger of its float32 operations over the
card's peak and its bytes over the memory rate (``roofline/peaks.json``).
Its operations are the source's per ray for every ray the source emits,
then each optic's per ray for the rays alive into it (the element before
it: the call's own counts), as ``roofline/<config>.json`` freezes them;
its bytes are each launch's packed buffers, images and counters, and a
plasma's bundle tables of each iteration, read once.
"""

from __future__ import annotations

import os
import re

from harness import spec, traffic


def peaks() -> dict:
    return spec.load_json(os.path.join(spec.BENCH_DIR, "roofline", "peaks.json"))


def call_bound_s(census: dict, peak: dict, counts: dict, launches: int,
                 iterations: int) -> float:
    """Seconds a call of element ``counts`` (source first, then the optics
    in chain order) takes at least on a card of ``peak`` rates, over
    ``launches`` launches of ``iterations`` iterations each."""
    names = list(counts)
    ops = census["source_ops_per_ray"] * counts[names[0]]
    for prev, name in zip(names, names[1:]):
        ops += census["optic_ops_per_ray"][name] * counts[prev]
    n_bytes = launches * (census["bytes_per_launch"]
                          + census["bytes_per_launch_per_iteration"] * iterations)
    return max(ops / peak["fp32_ops_per_s"], n_bytes / peak["hbm_bytes_per_s"])


def kernel_name(op_name: str) -> str:
    """A device operation's function name: no return type, namespaces,
    template arguments or parameters."""
    name = re.sub(r"^void\s+", "", op_name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()


def is_kernel(census: dict, op_name: str) -> bool:
    return any(kernel_name(op_name).startswith(p) for p in census["kernels"])


def bound_total_s(ctx) -> float:
    """The bound of every call of the window, summed."""
    iterations = int(ctx.cell.config["config"]["general"].get("number_of_iter", 1))
    peak = peaks()
    launches = traffic.shards(ctx.cell)  # K1 launches a call: one a shard
    return sum(call_bound_s(ctx.cell.roofline, peak, c["counts"], launches, iterations)
               for c in ctx.calls)


def k5_bound_total_s(ctx, census: dict) -> float:
    """K5's bound of every fit step of the window, summed: each step's rays
    once through K5f and once through K5b, at the float32 peak."""
    ops = census["forward_ops_per_ray"] + census["vjp_ops_per_ray"]
    return sum(c["rays"] for c in ctx.calls) * ops / peaks()["fp32_ops_per_s"]


def share_of_peak(ctx, bound_s: float) -> float:
    """A bound of the window's work over the window's seconds times the
    devices, in percent: the whole call's or step's share of the peak."""
    return 100.0 * bound_s / ((ctx.window[1] - ctx.window[0]) * len(ctx.devices))
