"""Shared set-up of the benchmark's tests: the harness and the reference
on ``sys.path``, and cells cut to a size the CPU traces in a moment."""

import importlib
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)

from harness import cell as cell_run  # noqa: E402
from harness import spec  # noqa: E402

# The cells' loads cut to some thousands of rays a call on the CPU.
CPU_SCALE = {"flagship.scan": 2.0**-13, "plasma.frames": 2.0**-15,
             "flagship.scan_4chip": 2.0**-15, "flagship.fit": 2.0**-12}
# Cells whose configuration and mix the benchmark keeps but BENCHMARK.json
# does not hold yet (PERF.md, Open questions): (config, mix, chips, the
# limits their checks would take, the cell whose metrics they report).
QUEUED = {"plasma.frames": ("plasma", "frames", 1,
                            {"count_diff": 0, "image_diff": 0, "photon_z": 20.0}, "flagship.scan"),
          "flagship.scan_4chip": ("flagship", "scan_4chip", 4,
                                  {"count_diff": 0, "image_diff": 0}, "flagship.scan")}


def queued_cell(name: str) -> spec.Cell:
    config_name, mix, chips, limits, like = QUEUED[name]
    metrics = spec.resolve(spec.load_spec(), like)
    traffic = spec.load_json(os.path.join(BENCH_DIR, "traffic", mix + ".json"))
    return spec.Cell(
        name=name, chips=chips, config_name=config_name,
        config=spec.load_json(os.path.join(BENCH_DIR, "configs", config_name + ".json")),
        traffic_name=mix, traffic=traffic,
        reference=importlib.import_module("reference." + traffic["reference"]), limits=limits,
        roofline=spec.load_json(os.path.join(BENCH_DIR, "roofline", config_name + ".json")),
        end_to_end=metrics.end_to_end, per_layer=metrics.per_layer)


def tiny_cell(name: str) -> spec.Cell:
    cell = queued_cell(name) if name in QUEUED else spec.resolve(spec.load_spec(), name)
    cell.traffic["intensity_scale"] = cell.traffic.get("intensity_scale", 1.0) * CPU_SCALE[name]
    return cell


def cpu_run(cell: spec.Cell, seed: int, call=None, seconds: float = 0.3) -> dict:
    """One run of ``cell`` on the CPU, its window ``seconds`` long."""
    import torch

    torch.set_num_threads(1)  # elementwise CPU kernels round alike only on one thread
    return cell_run.run(cell, seed, seconds, False, ["cpu"], time.perf_counter(), call=call)
