"""BENCHMARK.json against its contract, and every name in it resolved to
its files; a cell and a metric added as new files only."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchhelp import BENCH_DIR, ROOT, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = spec.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    for x in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(x), x
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in SPEC["configs"]] + [c["source"] for c in SPEC["configs"]]
                 + [w["why"] for w in SPEC["workloads"]] + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_run_length_fit_the_check():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    cells = 24  # later PRs may fill the benchmark up to 24 cells at this length
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = spec.resolve(SPEC, name)
    assert cell.config["config"]["sources"] and cell.config["config"]["optics"]
    assert cell.traffic["entry"] in ("raytrace", "raytrace_mp", "fit")
    assert cell.reference.__name__ == "reference." + cell.traffic["reference"]
    if cell.traffic["entry"] == "fit":
        assert set(cell.limits) == {"loss_gap", "grad_gap", "median_change_gap", "last_loss_gap",
                                    "last_grad_gap"}
        assert os.path.exists(f"{BENCH_DIR}/roofline/{cell.config_name}.k5.json")
        assert callable(cell.reference.follow) and callable(cell.reference.pack)
    else:
        assert set(cell.limits) >= {"count_diff", "image_diff"}
        assert cell.roofline is not None and callable(cell.reference.trace)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_configs_and_per_layer_metrics():
    for c in SPEC["configs"]:
        data = spec.load_json(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/configs/") and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    e2e = SPEC["end_to_end"]
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = next(x for x in e2e if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in {m["layer"] for m in SPEC["per_layer"]}:
        assert layer in perf


DUMMY_METRIC = '''"""Calls of the window (a dummy reader)."""


def read(ctx):
    return float(len(ctx.calls))
'''


DUMMY_REFERENCE = '''"""The raytrace reference, saying that it ran (a dummy reference)."""

import sys

from reference import raytrace


def trace(config, shards, **kwargs):
    print("the dummy reference ran", file=sys.stderr)
    return raytrace.trace(config, shards, **kwargs)
'''


def test_a_cell_and_a_metric_added_as_files_only(tmp_path):
    """A copy of the benchmark gains a mix, the reference it names, a
    cell's limits, a metric and their entries; no file of the copy
    changes, and a CPU run of the new cell checks with the new reference
    and reports the new metric."""
    copy_dir = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, copy_dir / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (copy_dir / "benchmark").rglob("*") if p.is_file()}
    (copy_dir / "benchmark" / "traffic" / "dummy.json").write_text(json.dumps(
        {"entry": "raytrace", "reference": "dummy", "intensity_scale": 2.0**-14,
         "warmup_calls": 1, "check_calls": 1}))
    (copy_dir / "benchmark" / "reference" / "dummy.py").write_text(DUMMY_REFERENCE)
    (copy_dir / "benchmark" / "limits" / "flagship.dummy.json").write_text(
        json.dumps({"count_diff": 0, "image_diff": 0}))
    (copy_dir / "benchmark" / "metrics" / "dummy_calls.py").write_text(DUMMY_METRIC)
    data = json.loads(json.dumps(SPEC))
    data["workloads"].append({"name": "flagship.dummy", "config": "flagship",
                              "traffic": "dummy", "chips": 1, "why": "a test"})
    next(m for m in data["end_to_end"] if m["name"] == "rays_per_s")["workloads"].append(
        "flagship.dummy")
    data["per_layer"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "entry and build",
                              "moves": "rays_per_s", "workloads": ["flagship.dummy"]})
    (copy_dir / "BENCHMARK.json").write_text(json.dumps(data))
    assert all(p.read_bytes() == b for p, b in before.items())
    script = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(copy_dir / 'benchmark')!r}, {ROOT!r}]\n"
        "import torch; torch.set_num_threads(1)\n"
        "from harness import spec, cell\n"
        "c = spec.resolve(spec.load_spec(), 'flagship.dummy')\n"
        "c.per_layer, c.end_to_end = c.per_layer, c.per_layer\n"
        "print(json.dumps(cell.run(c, 7, 0.2, False, ['cpu'], time.perf_counter())))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=copy_dir)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "the dummy reference ran" in out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["dummy_calls"]["value"] == line["attempted"]
    assert math.isfinite(line["metrics"]["dummy_calls"]["value"])
