"""Named-region wall-time profiler (``xicsrt_tpu/utils/profiler.py``).

Opt-in global region timers with call counts and a sorted report. Regions
measure host wall time; the engine synchronises the device before it stops
a region that wraps device work. ``device_trace`` wraps ``torch.profiler``
(config ``general.profile_dir`` turns it on for a whole raytrace).
"""

from __future__ import annotations

import contextlib
import os
import time


class Profiler:
    def __init__(self):
        self._enabled = False
        self._regions: dict = {}

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    def reset(self):
        self._regions.clear()

    def start(self, name: str):
        if not self._enabled:
            return
        entry = self._regions.setdefault(
            name, {"time_total": 0.0, "time_start": None, "num_calls": 0}
        )
        entry["time_start"] = time.perf_counter()

    def stop(self, name: str):
        if not self._enabled:
            return
        entry = self._regions.get(name)
        if entry is None or entry["time_start"] is None:
            return
        entry["time_total"] += time.perf_counter() - entry["time_start"]
        entry["time_start"] = None
        entry["num_calls"] += 1

    @contextlib.contextmanager
    def span(self, name: str):
        """Context-manager form of start/stop."""
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    @contextlib.contextmanager
    def device_trace(self, logdir: str | None):
        """Record a ``torch.profiler`` trace (CPU, and CUDA when present) of
        the enclosed region into ``logdir/trace.json``. No-op when
        ``logdir`` is falsy."""
        if not logdir:
            yield
            return
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            yield
        os.makedirs(str(logdir), exist_ok=True)
        prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))

    def report(self) -> str:
        lines = ["{:>12s} {:>8s}  {}".format("total [s]", "calls", "region")]
        for name, e in sorted(
            self._regions.items(), key=lambda kv: -kv[1]["time_total"]
        ):
            lines.append(
                "{:12.4f} {:8d}  {}".format(e["time_total"], e["num_calls"], name)
            )
        text = "\n".join(lines)
        print(text)
        return text


profiler = Profiler()
