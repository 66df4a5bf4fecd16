"""``BENCHMARK.json`` and the files each of its names resolves to.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the harness reads them from ``configs/<config>.json`` and
``traffic/<traffic>.json``, the plain reference its check runs from
``reference/<name>.py`` (the mix's ``reference``), the limits of its
correctness check from ``limits/<cell>.json``, K1's operation census from
``roofline/<config>.json``, and each metric from ``metrics/<name>.py``. A
later cell, mix, reference or metric is new files and new entries: no file
here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """One cell of the benchmark and everything it reads."""

    name: str
    chips: int
    config_name: str
    config: dict          # the configuration file: source, reduced, assumed, config
    traffic_name: str
    traffic: dict
    reference: object     # the module ``reference/<traffic["reference"]>.py``
    limits: dict          # {number: limit} of the correctness check
    roofline: dict | None
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` list,
    or every cell where it has none."""
    return cell in metric.get("workloads", [cell])


def resolve(spec: dict, workload: str) -> Cell:
    """The cell named ``workload`` with its files loaded; KeyError for a
    name ``BENCHMARK.json`` lacks, OSError for a missing file."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config_entry = configs[w["config"]]
    roofline_path = os.path.join(BENCH_DIR, "roofline", w["config"] + ".json")
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=load_json(os.path.join(ROOT, config_entry["file"])),
        traffic_name=w["traffic"],
        traffic=traffic,
        reference=importlib.import_module("reference." + traffic["reference"]),
        limits=load_json(os.path.join(BENCH_DIR, "limits", workload + ".json")),
        roofline=load_json(roofline_path) if os.path.exists(roofline_path) else None,
        end_to_end=[m for m in spec["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if reports(m, workload)],
    )


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    module_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    module_spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read
