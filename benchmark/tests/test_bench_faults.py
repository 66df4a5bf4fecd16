"""Whole runs of the harness on the CPU, its look for a chip skipped: a
sound run comes out correct, and a run whose timed path is broken
underneath comes out not correct, once for each fault a cell can have,
in the cells of BENCHMARK.json and in those the benchmark keeps for later
(``benchhelp.QUEUED``)."""

import copy

import pytest

from benchhelp import cpu_run, tiny_cell  # first: it puts the harness on sys.path
import control  # isort: skip
from harness import traffic

CELLS = ["flagship.scan", "plasma.frames", "flagship.scan_4chip"]
FIT = "flagship.fit"


def _entry(cell):
    return traffic.entry(cell, "cpu")


def stale(cell, monkeypatch):
    """Every call returns the first call's results: the state unchanged."""
    real, first = _entry(cell), []

    def call(config):
        if not first:
            first.append(real(config))
        return first[0]

    return call


def half_batch(cell, monkeypatch):
    """Half of each call's rays traced and the results doubled, so the
    totals look whole."""
    real = _entry(cell)

    def call(config):
        config = copy.deepcopy(config)
        for source in config["sources"].values():
            source["intensity_scale"] = float(source.get("intensity_scale", 1.0)) * 0.5
        out = real(config)
        for meta in out["total"]["meta"].values():
            meta["num_out"] *= 2
        out["total"]["image"] = {k: 2 * v for k, v in out["total"]["image"].items()}
        return out

    return call


def altered(cell, monkeypatch):
    """One photon added to the fullest pixel where the trace kernel's
    launcher returns its image."""
    from xicsrt_tpu_torch.ops import fused_trace

    real = fused_trace.fused_run_cuda

    def launch(*args, **kwargs):
        counts, image, *rest = real(*args, **kwargs)
        image = image.clone()
        image[int(image.argmax())] += 1.0
        return (counts, image, *rest)

    monkeypatch.setattr(fused_trace, "fused_run_cuda", launch)
    return None


def no_exchange(cell, monkeypatch):
    """The sum over the shards left out: the first shard's results stand
    for the mesh's."""
    from xicsrt_tpu_torch.parallel import mesh

    real = mesh.combine_shards
    monkeypatch.setattr(mesh, "combine_shards",
                        lambda outs, mesh_, device: real(outs[:1], mesh_, device))
    return None


FAULTS = [(c, f) for c in CELLS for f in (stale, half_batch, altered)]
FAULTS.append(("flagship.scan_4chip", no_exchange))


@pytest.mark.parametrize("cell_name", CELLS + [FIT])
def test_a_sound_run_is_correct(cell_name):
    cell = tiny_cell(cell_name)
    result = cpu_run(cell, 2**32 + 1)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("cell_name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell_name, fault, monkeypatch):
    cell = tiny_cell(cell_name)
    result = cpu_run(cell, 77, call=fault(cell, monkeypatch))
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("fault", sorted(control.FIT_FAULTS))
def test_a_broken_fit_step_is_not_correct(fault, monkeypatch):
    """The fit's faults, planted in the program's K5 launchers (on the CPU
    their plain twins) before set-up: each fails a number."""
    result = cpu_run(tiny_cell(FIT), 77,
                     call=lambda: control.FIT_FAULTS[fault](monkeypatch.setattr))
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_a_fit_step_broken_in_the_window_alone_is_not_correct(monkeypatch):
    """A fault that starts after set-up's steps (the forward's fullest
    pixel doubled from the tenth K5f launch on) leaves the first steps
    sound; the window's last step catches it."""
    def plant():
        fg = control._fused_grad()
        real, launches = fg.fused_grad_forward_cuda, []

        def forward(*a, **k):
            launches.append(1)
            image = real(*a, **k)
            if len(launches) >= 10:
                image = image.clone()
                image[int(image.argmax())] *= 2.0
            return image

        monkeypatch.setattr(fg, "fused_grad_forward_cuda", control._launcher(forward))

    result = cpu_run(tiny_cell(FIT), 77, call=plant, seconds=1.0)
    checks = result["checks"]
    assert result["attempted"] >= 6 and result["correct"] is False
    assert all(checks[k]["value"] <= checks[k]["limit"]
               for k in ("loss_gap", "grad_gap", "median_change_gap"))
    assert checks["last_loss_gap"]["value"] > checks["last_loss_gap"]["limit"]


def test_a_failing_call_is_counted():
    cell = tiny_cell("flagship.scan")
    real = _entry(cell)
    calls = []

    def call(config):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("a planted failure")
        return real(config)

    result = cpu_run(cell, 5, call=call)
    assert result["failed"] == 1 and result["correct"] is False
