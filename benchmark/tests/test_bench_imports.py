"""No module the harness or the reference loads is JAX or the JAX package,
and the reference loads nothing of the port: checked in fresh processes,
by whole top-level names."""

import json
import subprocess
import sys

import pytest

from benchhelp import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "xicsrt_tpu"}

PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
before = set(sys.modules)
{body}
added = {{m.split(".")[0] for m in set(sys.modules) - before}}
print(json.dumps(sorted(added)))
"""


def _added(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(bench=BENCH_DIR, root=ROOT,
                                                             body=body)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_jax_and_nothing_of_the_port():
    added = _added("import reference.raytrace, reference.fit, control")
    assert not added & (FORBIDDEN | {"xicsrt_tpu_torch"})


@pytest.mark.parametrize("cell_name", ["flagship.scan", "flagship.fit", "plasma.frames",
                                       "flagship.scan_4chip"])
def test_a_whole_run_loads_no_jax(cell_name):
    """The harness, its metric readers and a whole CPU run of a cell (the
    port included), then the check ``run.py`` makes before it prints."""
    body = (
        "import time, torch\n"
        "torch.set_num_threads(1)\n"
        "sys.path.insert(0, " + repr(BENCH_DIR + "/tests") + ")\n"
        "import run\n"
        "from benchhelp import tiny_cell, cpu_run\n"
        "from harness import spec\n"
        f"cell = tiny_cell({cell_name!r})\n"
        "[spec.metric_reader(m['name']) for m in cell.end_to_end + cell.per_layer]\n"
        "assert cpu_run(cell, 3)['correct']\n"
        "assert run.forbidden_modules() == []\n")
    added = _added(body)
    assert "xicsrt_tpu_torch" in added
    assert not added & FORBIDDEN
