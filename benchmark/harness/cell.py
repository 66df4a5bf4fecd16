"""One run of one cell: set-up, the measured window, its metrics, the check.

The window is a closed loop with one caller. In a raytrace mix
(:class:`Calls`) each call is a fresh config of the mix
(``traffic.call_config``) sent once the previous call has returned, timed
on the host clock from the call to its returned results dict, which holds
the counts and the images on the host (the program waits for the device
inside the call); a fit mix's steps (``fit.Steps``) are timed alike. The
window closes with the first call that ends ``seconds`` or more after the
first call began; its length runs to that call's end. A traced run's window is at most
``TRACE_SECONDS``: a 51 s trace of ``plasma.frames`` came back without its
end marker (``devtrace``), and reading a long trace took a minute. Set-up
(``setup_s``) is everything before the first timed call: imports, the
CUDA context, the kernel library (built on a checkout's first run, loaded
from ``build/`` after), and the mix's warm-up calls, which run the
window's path at the window's sizes.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback

import numpy as np

from harness import check, devtrace, fit, spec, traffic

SHOW_NAME = 160  # characters of a device operation's name in the breakdown
TRACE_SECONDS = 10.0


@dataclasses.dataclass
class Context:
    """What a metric reader reads (``metrics/<name>.py``: ``read(ctx)``,
    None where it finds nothing to read)."""

    cell: spec.Cell
    setup_s: float
    window: tuple                 # (start, end), host seconds
    calls: list                   # {"index", "t0", "t1", "rays"} of each call or step,
                                  # and a call's element "counts"
    devices: list
    spans: list | None = None     # (name, start, end) of the program's regions and
                                  # the fit loop's forward, vjp and update
    ops: list | None = None       # (name, device index, start, end) on the device


def rays_per_s(ctx):
    """Rays of every call or step completed in the window, over the
    window's seconds (host clock); None where none completed."""
    if not ctx.calls:
        return None
    return sum(c["rays"] for c in ctx.calls) / (ctx.window[1] - ctx.window[0])


class Calls:
    """The raytrace mixes' loop of one run: ``call(config)`` is the mix's
    entry point (``traffic.entry``), or a test's planted fault."""

    def __init__(self, cell, seed: int, devices: list, call=None):
        self.cell, self.seed = cell, seed
        self.call = call or traffic.entry(cell, "cuda" if devices[0].startswith("cuda")
                                          else devices[0])
        self.kept = []

    def warm(self) -> None:
        for k in range(int(self.cell.traffic.get("warmup_calls", 1))):
            self.call(traffic.call_config(self.cell, self.seed, traffic.WARMUP, k))

    def window(self, seconds: float, spans=None) -> tuple:
        """Run the closed loop; returns (calls, failed, (start, end)): each
        returned call's index, times and element counts. Keeps the (config,
        results) of ``check_calls`` of them, a uniform sample drawn from the
        run's seed as the calls come (reservoir sampling), so that a run
        holds no more than that."""
        cell, seed = self.cell, self.seed
        k = int(cell.traffic.get("check_calls", 1))
        rng = np.random.default_rng([traffic.seed_words(seed), traffic.SAMPLE])
        calls, kept, failed = [], self.kept, 0
        start = time.perf_counter()
        index = 0
        while True:
            config = traffic.call_config(cell, seed, traffic.WINDOW, index)
            t0 = time.perf_counter()
            try:
                result = self.call(config)
            except Exception:  # a failed call counts against the run and the loop goes on
                traceback.print_exc(file=sys.stderr)
                failed, result = failed + 1, None
            t1 = time.perf_counter()
            if result is not None:
                counts = {n: int(v["num_out"]) for n, v in result["total"]["meta"].items()}
                calls.append({"index": index, "t0": t0, "t1": t1, "counts": counts,
                              "rays": next(iter(counts.values()))})
                slot = len(calls) - 1 if len(calls) <= k else int(rng.integers(0, len(calls)))
                if slot < k:
                    kept[slot:slot + 1] = [(config, result)]
            index += 1
            if t1 - start >= seconds:
                return calls, failed, (start, t1)

    def free(self) -> None:
        self.call = None

    def check(self, devices: list) -> dict:
        """The sampled calls' numbers against the cell's reference's."""
        if not self.kept:
            return {}
        shards = [devices[k % len(devices)] for k in range(traffic.shards(self.cell))]
        refs = [self.cell.reference.trace(config, shards) for config, _ in self.kept]
        return check.numbers([r for _, r in self.kept], refs)


def breakdown(ops: list, spans: list, window_: tuple) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the devices, each named by the program region the host was in
    for most of it."""
    by_name = {}
    for name, _, s, e in ops:
        by_name[name[:SHOW_NAME]] = by_name.get(name[:SHOW_NAME], 0.0) + (e - s)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = devtrace.gaps(devtrace.busy(ops, window_), window_)
    idle = sorted(idle, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, t] for n, t in device_ops],
            "idle_gaps": [[devtrace.dominant(spans, s, e), e - s] for s, e in idle]}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, devices: list,
        t_start: float, call=None) -> dict:
    """Run ``cell`` once on ``devices`` ('cuda:k', or 'cpu' in the tests);
    ``t_start`` is the process's start on the host clock. ``call`` is a
    test's planted fault: a raytrace mix's entry point, or a fit mix's
    ``plant()``. Returns the result line as a dict, ``checks`` last."""
    import torch

    from xicsrt_tpu_torch.utils.profiler import profiler

    cuda = devices[0].startswith("cuda")
    work = (fit.Steps if cell.traffic.get("entry") == "fit" else Calls)(cell, seed, devices, call)
    work.warm()
    if cuda:
        for d in devices:
            torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")

    spans = ops = None
    if trace:
        own = []
        with devtrace.SpanRecorder(profiler) as recorder, devtrace.device_trace(devices) as dt:
            calls, failed, win = work.window(min(seconds, TRACE_SECONDS), own)
        spans, ops = recorder.spans + own, dt["ops"]
    else:
        calls, failed, win = work.window(seconds)

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": len(devices),
              "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in devices)
              if cuda else 0}
    ctx = Context(cell=cell, setup_s=setup_s, window=win, calls=calls, devices=devices,
                  spans=spans, ops=ops)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    extra = {}
    if trace:
        device["busy_s"] = sum(devtrace.covered(devtrace.busy(ops, win, k), *win)
                               for k in range(len(devices))) / len(devices)
        device["window_s"] = win[1] - win[0]
        extra["breakdown"] = breakdown(ops, spans, win)
    log(f"{len(calls) + failed} calls, {failed} failed, window {win[1] - win[0]:.3f} s")

    # The check: after the window, with the program's state freed.
    work.free()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check.judged(work.check(devices), cell.limits)
    log(f"reference in {time.perf_counter() - t_check:.3f} s")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return {"correct": failed == 0 and check.passes(checks),
            "attempted": len(calls) + failed, "failed": failed, "metrics": metrics,
            "device": device, **extra, "checks": checks}
