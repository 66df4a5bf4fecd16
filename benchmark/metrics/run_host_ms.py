"""Milliseconds of the program's ``raytrace_run`` region a call in which no
device operation runs (the region less the device time the trace shows
inside it), the mean over the traced window's calls."""

from harness import devtrace


def read(ctx):
    if ctx.spans is None or ctx.ops is None:
        return None
    busy = devtrace.busy(ctx.ops, ctx.window)
    host = [(e - s) - devtrace.covered(busy, s, e)
            for name, s, e in ctx.spans if name == "raytrace_run"]
    return sum(host) / len(host) * 1e3 if host else None
