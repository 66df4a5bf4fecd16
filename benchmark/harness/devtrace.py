"""The traced run's readings: the program's spans and the device's trace.

Spans: the port's ``utils.profiler`` names its host regions
(``build_runner``, ``pipeline_build``, ``raytrace_run``, ``sort_history``,
``combine_raytrace``) but keeps only their totals; :class:`SpanRecorder`
switches it on for the window and keeps each region's start and end on
the host clock (``time.perf_counter``).

Device: ``torch.profiler`` with CUDA activity alone (CUPTI: kernels,
copies and sets, no host operators, so the host's work is not slowed by
the trace), exported as a Chrome trace and read back as intervals. A
``torch.cuda._sleep`` marker launched at a known host time before the
window and after it maps the trace's clock onto the host's.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class SpanRecorder:
    """While entered, the program's profiler records, and every region it
    starts and stops is kept as ``(name, start, end)`` in :attr:`spans`."""

    def __init__(self, prof):
        self.prof = prof
        self.spans = []
        self._open = {}

    def _start(self, name):
        self._open[name] = time.perf_counter()
        type(self.prof).start(self.prof, name)

    def _stop(self, name):
        type(self.prof).stop(self.prof, name)
        t0 = self._open.pop(name, None)
        if t0 is not None:
            self.spans.append((name, t0, time.perf_counter()))

    def __enter__(self):
        self.prof.reset()
        self.prof.enable()
        self.prof.start, self.prof.stop = self._start, self._stop
        return self

    def __exit__(self, *exc):
        del self.prof.start, self.prof.stop
        self.prof.disable()
        self.prof.reset()


def _marker(torch, device) -> float:
    """Launch the marker kernel on an idle ``device``; its host launch time."""
    torch.cuda.synchronize(device)
    with torch.cuda.device(device):
        t = time.perf_counter()
        torch.cuda._sleep(1000)
    torch.cuda.synchronize(device)
    return t


@contextlib.contextmanager
def device_trace(devices: list):
    """Trace the enclosed region's device work. Yields a dict that holds,
    once the region is left, ``ops``: ``(name, device index, start, end)``
    of every kernel, copy and set, on the host clock, sorted by start."""
    import torch

    out = {"ops": []}
    first = torch.device(devices[0])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t_in = _marker(torch, first)
        yield out
        t_out = _marker(torch, first)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    ops = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    markers = sorted((e for e in ops if "sleep" in e["name"] or "spin" in e["name"]),
                     key=lambda e: e["ts"])
    if len(markers) < 2:
        raise RuntimeError("the device trace holds no marker kernels: it saw no device work")
    # Host time = a + trace microseconds * 1e-6, from the two markers.
    scale = (t_out - t_in) / ((markers[-1]["ts"] - markers[0]["ts"]) * 1e-6)
    a = t_in - markers[0]["ts"] * 1e-6 * scale
    keep = [e for e in ops if e is not markers[0] and e is not markers[-1]]
    out["ops"] = sorted(
        ((e["name"], int(e.get("args", {}).get("device", 0)),
          a + e["ts"] * 1e-6 * scale, a + (e["ts"] + e["dur"]) * 1e-6 * scale) for e in keep),
        key=lambda op: op[2])


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals, as sorted disjoint intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def covered(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the disjoint ``intervals`` cover."""
    return sum(e - s for s, e in clip(intervals, lo, hi))


def busy(ops, window: tuple, device=None) -> list:
    """Disjoint intervals in ``window`` in which an operation ran on
    ``device`` (any device where None)."""
    return clip(union((s, e) for _, d, s, e in ops if device is None or d == device),
                *window)


def gaps(intervals, window: tuple) -> list:
    """The idle ``(start, end)`` intervals of ``window`` between the
    disjoint ``intervals``."""
    out, t = [], window[0]
    for s, e in intervals:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if window[1] > t:
        out.append((t, window[1]))
    return out


def innermost(spans, t: float) -> str:
    """The name of the shortest span that holds host time ``t``, else
    ``"harness"`` (the benchmark's loop between calls)."""
    holding = [(e - s, name) for name, s, e in spans if s <= t <= e]
    return min(holding)[1] if holding else "harness"


def dominant(spans, start: float, end: float) -> str:
    """What the host was doing for most of [start, end]: the innermost span
    (:func:`innermost`) at each moment, weighted by time."""
    cuts = sorted({start, end} | {t for _, s, e in spans for t in (s, e) if start < t < end})
    weight = {}
    for lo, hi in zip(cuts, cuts[1:]):
        name = innermost(spans, (lo + hi) / 2.0)
        weight[name] = weight.get(name, 0.0) + (hi - lo)
    return max(weight.items(), key=lambda kv: kv[1])[0] if weight else "harness"


def idle_pct(ctx):
    """The share of the traced window in which no kernel, copy or set runs
    on a device, in percent, the mean over the cell's devices; None
    without a trace."""
    if ctx.ops is None:
        return None
    length = ctx.window[1] - ctx.window[0]
    idle = [1.0 - covered(busy(ctx.ops, ctx.window, k), *ctx.window) / length
            for k in range(len(ctx.devices))]
    return 100.0 * sum(idle) / len(idle)
