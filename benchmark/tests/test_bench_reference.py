"""The plain reference: against itself in other slices, its packed
constants against the port's, its answers against the port's CPU path
exactly, and its lower-precision control failing the cells' checks."""

import copy

import numpy as np
import pytest
import torch

from benchhelp import CPU_SCALE, tiny_cell
from harness import check, traffic
from reference import raytrace as reference

CELLS = ["flagship.scan", "plasma.frames", "flagship.scan_4chip"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # CPU elementwise kernels round alike only on one thread
    yield
    torch.set_num_threads(threads)


def _config(cell_name, seed=2**40 + 3):
    return traffic.call_config(tiny_cell(cell_name), seed, traffic.WINDOW, 0)


def _shards(cell_name):
    return ["cpu"] * (4 if cell_name.endswith("4chip") else 1)


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_against_itself_in_other_slices(cell_name):
    config = _config(cell_name)
    whole = reference.trace(copy.deepcopy(config), _shards(cell_name), slice_rays=1 << 20)
    sliced = reference.trace(copy.deepcopy(config), _shards(cell_name), slice_rays=777)
    assert whole["counts"] == sliced["counts"]
    assert whole["counts"][next(iter(whole["counts"]))] > 0
    for name, im in whole["images"].items():
        assert np.array_equal(im, sliced["images"][name])


@pytest.mark.parametrize("config_name", ["flagship", "plasma"])
def test_packed_constants_equal_the_ports(config_name):
    from xicsrt_tpu_torch.engine import Pipeline
    from xicsrt_tpu_torch.tools.roofline import k1_pack

    config = _config("flagship.scan" if config_name == "flagship" else "plasma.frames")
    ours = reference.build(copy.deepcopy(config))
    port = k1_pack(Pipeline(copy.deepcopy(config), device="cpu"))
    assert ours["F"] == [float(x) for x in port.fp.tolist()]
    assert ours["I"][:8] == [int(x) for x in port.ip.tolist()][:8]
    assert ours["I"][18:] == [int(x) for x in port.ip.tolist()][18:]


@pytest.mark.parametrize("seed", [0, 2**33 + 5])
@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_equals_the_ports_cpu_path(cell_name, seed):
    import xicsrt_tpu_torch as program

    config = _config(cell_name, seed)
    if cell_name.endswith("4chip"):
        prog = program.raytrace_mp(copy.deepcopy(config), processes=4, device="cpu")
    else:
        prog = program.raytrace(copy.deepcopy(config), device="cpu")
    ref = reference.trace(copy.deepcopy(config), _shards(cell_name))
    numbers = check.numbers([prog], [ref])
    assert numbers["count_diff"] == 0 and numbers["image_diff"] == 0.0
    if "photon_z" in numbers:
        assert numbers["photon_z"] < 5.0


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_the_check(cell_name):
    """The reference in bfloat16 in the program's place fails the cell's
    limits, at the CPU's size (the chip's runs read it at the cell's)."""
    import control

    lines = control.readings(tiny_cell(cell_name), [1, 2**35 + 9], 1, ["cpu"], torch.bfloat16)
    limits = tiny_cell(cell_name).limits
    for line in lines:
        assert line["count_diff"] > limits["count_diff"]
        assert line["image_diff"] > limits["image_diff"]
    assert CPU_SCALE[cell_name] < 1.0


def _fit_run(seed=2**40 + 5):
    from harness import fit

    cell = tiny_cell("flagship.fit")
    config = fit.grad_config(cell, seed)
    return cell, config


def test_fit_reference_against_itself_in_other_slices():
    from reference import fit as ref_fit

    _, config = _fit_run()
    run, pvec = ref_fit.static(config), ref_fit.pack(config)
    words = ref_fit.seed_words(123456789)
    whole = ref_fit.forward(run, pvec, words, torch.float32, 1 << 20)
    sliced = ref_fit.forward(run, pvec, words, torch.float32, 777)
    g = {k: torch.linspace(-1.0, 1.0, v.numel()).reshape(v.shape) for k, v in whole.items()}
    for name, im in whole.items():
        assert float(im.sum()) > 0.0
        assert torch.allclose(im, sliced[name], rtol=1e-5, atol=1e-5)
    a = ref_fit.gradient(run, pvec, words, g, torch.float32, 1 << 20)
    b = ref_fit.gradient(run, pvec, words, g, torch.float32, 777)
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-6 * float(a.abs().max()))


@pytest.mark.parametrize("seed", [3, 2**33 + 7])
def test_fit_reference_equals_the_ports_cpu_path(seed):
    """Its parameter vector and images equal the port's exactly, its
    gradient the port's hand adjoint to float32 rounding."""
    import xicsrt_tpu_torch as program
    from reference import fit as ref_fit

    _, config = _fit_run(seed)
    forward, vjp, pack, pipeline = program.make_fused_differentiable(copy.deepcopy(config),
                                                                      device="cpu")
    pvec = pack(pipeline.params).detach()
    assert torch.equal(pvec, ref_fit.pack(config))
    run = ref_fit.static(config)
    images = forward(pvec, seed)["image"]
    ours = ref_fit.forward(run, pvec, ref_fit.seed_words(seed), torch.float32, 1 << 22)
    assert set(images) == set(ours)
    for name, im in images.items():
        assert torch.equal(im, ours[name])
    g = {k: torch.linspace(-1.0, 1.0, v.numel()).reshape(v.shape) for k, v in images.items()}
    port = vjp(pvec, seed, g).double()
    mine = ref_fit.gradient(run, pvec, ref_fit.seed_words(seed), g, torch.float32, 1 << 22)
    assert float((port - mine).abs().max()) <= 1e-5 * float(mine.abs().max())


def test_fit_control_fails_the_check():
    """The fit reference in bfloat16 in the program's place fails one of
    the cell's numbers at the CPU's size."""
    import control

    cell = tiny_cell("flagship.fit")
    for line in control.readings(cell, [1, 2**35 + 9], 1, ["cpu"], torch.bfloat16):
        assert any(line[k] > limit for k, limit in cell.limits.items())
