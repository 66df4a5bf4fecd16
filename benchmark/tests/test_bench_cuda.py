"""On the card: one short run of each cell through ``run.py``, at
the cell's own sizes, comes out correct with its metrics, and the trace
reads device time. Run with ``python -m pytest -m cuda benchmark/tests``."""

import json
import subprocess
import sys

import pytest

from benchhelp import ROOT


@pytest.fixture
def cuda_device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["flagship.scan", "flagship.fit"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cuda_device, cell_name, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell_name,
                          "--seed", str(2**33 + 11), "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    roofline = "k5_roofline" if cell_name.endswith("fit") else "k1_roofline"
    rate = "grad_rays_per_s" if cell_name.endswith("fit") else "rays_per_s"
    if trace:
        assert 0.0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert 0.0 < line["metrics"][roofline]["value"] <= 100.0
    else:
        assert line["metrics"][rate]["value"] > 0.0
