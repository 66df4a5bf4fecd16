"""Milliseconds of a fit step in which no device operation runs: each
step's time less the device time the trace shows inside it, the mean over
the traced window's steps."""

from harness import devtrace


def read(ctx):
    if ctx.ops is None or not ctx.calls:
        return None
    busy = devtrace.busy(ctx.ops, ctx.window)
    host = [(c["t1"] - c["t0"]) - devtrace.covered(busy, c["t0"], c["t1"]) for c in ctx.calls]
    return sum(host) / len(host) * 1e3
