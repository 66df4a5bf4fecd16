"""The roofline tool of the port (``xicsrt_tpu_torch/tools/roofline.py``)
and its probes R1 and R2 (``xicsrt_tpu_torch/ops/roofline_probes.py``) on
the CPU.

- R1's and R2's plain versions against the JAX tool's probe kernels
  (``tools/roofline.py``'s nested ``elem_rate`` and ``mm_kernel``, read with
  ``ast`` and run in Pallas's TPU interpret mode), at tiny sizes.
- ``count_ops``'s classes on toy functions, exactly.
- The census of K1's twin per ray, stable across chunk sizes, and each
  probe rate's numerator equal to the census of its plain body.
- The measuring entry points raise without CUDA; the scenario configs are
  the JAX side's.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import xicsrt_tpu_torch
from xicsrt_tpu_torch.ops import roofline_probes as rp
from xicsrt_tpu_torch.tools import bench_scenarios as BS
from xicsrt_tpu_torch.tools import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "roofline.py")


def _jax_probe(name: str, namespace: dict):
    """The function ``name`` nested in the JAX tool's ``microbench_rates``,
    compiled in ``namespace`` (the tool's module itself runs on a TPU)."""
    tree = ast.parse(open(JAX_TOOL).read(), filename=JAX_TOOL)
    outer = next(n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name == "microbench_rates")
    node = next(n for n in outer.body if isinstance(n, ast.FunctionDef) and n.name == name)
    exec(compile(ast.Module(body=[node], type_ignores=[]), JAX_TOOL, "exec"), namespace)
    return namespace[name]


def _jax_elem_rate(body: str, n_chunks: int, K: int, dep: float) -> tuple:
    """(sin(sum * 1e-9), the (8, 128) output) of the JAX tool's R1 on
    ``body``, one call of its jitted function: ``timed`` is replaced by one
    that calls it once at ``dep``."""
    calls = {}

    def timed(jitted, work):
        calls["jitted"] = jitted
        return jitted(jnp.float32(dep))

    namespace = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, np=np, f32=jnp.float32,
                     sub=rp.SUB, timed=timed)
    elem_rate = _jax_probe("elem_rate", namespace)
    bodies = {"trans": (lambda y: jnp.exp(y * -0.9), 1),
              "sqrtdiv": (lambda y: jax.lax.rsqrt(jnp.abs(y) + 1.0), 1),
              "simple": (lambda y: jnp.where(y > 0.1, y * 0.9999 + 1e-6, y + 1e-3), 4)}
    fn, ops = bodies[body]
    streams = rp.ELEM_SIZES[body][1]
    with pltpu.force_tpu_interpret_mode():
        value = float(elem_rate(fn, ops, n_chunks=n_chunks, K=K, streams=streams))
        closure = calls["jitted"].__wrapped__
        call = dict(zip(closure.__code__.co_freevars,
                        (c.cell_contents for c in closure.__closure__)))["call"]
        out = np.asarray(call(jnp.stack([jnp.float32(0.5 + 0.125 * dep)])))
    return value, out


@pytest.mark.parametrize("body", ["trans", "sqrtdiv", "simple"])
def test_elem_rate_plain_matches_jax_kernel(body):
    """R1's plain version against the interpreted JAX kernel at 2 grid steps
    of K = 4. Both take the same float32 steps (``1/sqrt`` is the correctly
    rounded ``rsqrt``); only the sum's order differs, so rtol 1e-5."""
    dep = 0.5
    value, out = _jax_elem_rate(body, n_chunks=2, K=4, dep=dep)
    seed = torch.tensor([0.5 + 0.125 * dep], dtype=torch.float32)
    plain = rp.elem_rate_plain(seed, body, n_chunks=2, K=4)
    np.testing.assert_allclose(plain.numpy(), out, rtol=1e-5)
    ours = float(torch.sin(plain.sum() * 1e-9))
    np.testing.assert_allclose(ours, value, rtol=1e-5)


def test_mma_rate_plain_matches_jax_kernel():
    """R2's plain version against the interpreted JAX ``mm_kernel`` at grid
    2, K_mm 3, sub 256: float32 sums of exact bf16 products, in another
    order, so rtol 1e-5 of the largest element."""
    n_mm, K_mm, sub, seed = 2, 3, 256, 0.011
    namespace = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, np=np, f32=jnp.float32,
                     sub=sub, R=rp.MM_ROWS, K_mm=K_mm)
    mm_kernel = _jax_probe("mm_kernel", namespace)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            mm_kernel, grid=(n_mm,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
            out_specs=pl.BlockSpec((rp.MM_ROWS, 128), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((rp.MM_ROWS, 128), jnp.float32))
        ref = np.asarray(call(jnp.asarray([seed], jnp.float32)))
    plain = rp.mma_rate_plain(torch.tensor([seed], dtype=torch.float32), n_mm=n_mm,
                              K_mm=K_mm, sub=sub).numpy()
    assert ref.max() > 0
    np.testing.assert_allclose(plain, ref, rtol=0, atol=1e-5 * float(ref.max()))


def test_probe_wrappers_take_the_plain_version_on_the_cpu():
    seed = torch.tensor([0.75], dtype=torch.float32)
    for body in rp.BODIES:
        assert torch.equal(rp.elem_rate_cuda(seed, body, n_chunks=1, K=3),
                           rp.elem_rate_plain(seed, body, n_chunks=1, K=3))
    assert torch.equal(rp.mma_rate_cuda(seed, n_mm=1, K_mm=2, sub=64),
                       rp.mma_rate_plain(seed, n_mm=1, K_mm=2, sub=64))
    with pytest.raises(ValueError):
        rp.elem_rate_cuda(seed.to("meta"), "trans")
    with pytest.raises(ValueError):
        rp.mma_rate_cuda(torch.tensor([0.5]).double())
    with pytest.raises(ValueError):
        rp.elem_rate_cuda(seed, "log")


def test_count_ops_classes():
    x = torch.rand(10) + 0.5
    y = torch.rand(10)
    c = roofline.count_ops

    def counts(**kw):
        return dict(dict.fromkeys(roofline.CLASSES, 0.0), **kw)

    assert c(torch.exp, x) == counts(trans=10)
    assert c(lambda: torch.where(x > 1.0, x, y)) == counts(simple=20)
    # 1.0 / t dispatches reciprocal, then a multiply by 1.0.
    assert c(lambda: 1.0 / torch.sqrt(x)) == counts(sqrtdiv=20, simple=10)
    assert c(lambda: torch.reciprocal(torch.sqrt(x))) == counts(sqrtdiv=20)
    assert c(lambda: x / y) == counts(sqrtdiv=10)
    assert c(torch.matmul, torch.rand(3, 4), torch.rand(4, 5)) == counts(mxu_macs=60)
    assert c(torch.matmul, torch.rand(2, 3, 4), torch.rand(4, 5)) == counts(mxu_macs=120)
    mask = x > 1.0
    assert c(lambda: (x.reshape(2, 5).T, x[mask], x.expand(3, 10), x[2:7],
                      torch.zeros(7), torch.stack([x, y]), x.clone())) == counts()
    assert c(torch.searchsorted, torch.arange(8.0), x) == counts(simple=30)
    assert c(lambda: x ** 2) == counts(simple=20)
    assert c(lambda: x ** 2.5) == counts(trans=10)
    assert c(lambda: x.sum()) == counts(simple=10)
    assert c(lambda: x.double()) == counts(simple=10)
    z = torch.zeros(4)
    idx = torch.tensor([0, 1, 1])
    assert c(lambda: z.add_(1.0)) == counts(simple=4)
    assert c(lambda: z.index_put_((idx,), torch.ones(3), accumulate=True)) == counts(simple=3)
    assert c(lambda: z.index_put_((idx,), torch.ones(3))) == counts()
    assert c(lambda: z.index_add_(0, idx, torch.ones(3))) == counts(simple=3)


def test_chain_census_is_per_ray():
    """The flagship's census per ray at chunks 1024 and 4096 within 1 %
    class by class: the counts scale with the rays, not the chunk."""
    config, _ = roofline.scenario_config("flagship")
    small, _ = roofline.chain_ops_per_ray(config, chunk=1024)
    large, _ = roofline.chain_ops_per_ray(config, chunk=4096)
    for cls in roofline.CLASSES:
        assert small[cls] == pytest.approx(large[cls], rel=1e-2, abs=1e-9)
    assert small["mxu_macs"] == 0.0  # the port bins by atomics, not one-hot matmuls
    assert small["simple"] > 100


def test_k1b_census_is_per_ray_and_adds_the_sampler():
    """Phase 24's source (K1b's timed chain: a focused gaussian box, an
    isotropic cone, an exact Voigt line and a flow) on the flagship's
    optics: its census per ray at chunks 1024 and 4096 within 1 % class by
    class, and above K1a's (the flagship's point source) by the generic
    sampler's classes: an erfinv for each of the box's three sizes and for
    the Doppler normal, a tan for the natural width."""
    import chip_smoke

    config = chip_smoke.source_matrix_config(1 << 22, 1, "fused")
    small, _ = roofline.chain_ops_per_ray(config, chunk=1024)
    large, _ = roofline.chain_ops_per_ray(config, chunk=4096)
    for cls in roofline.CLASSES:
        assert small[cls] == pytest.approx(large[cls], rel=1e-2, abs=1e-9)
    k1b_ops = roofline._chain_census(config, 1024)[1]
    k1a_ops = roofline._chain_census(chip_smoke.flagship(1 << 22, 1, engine="fused"), 1024)[1]
    for op, extra in (("erfinv", 4), ("tan", 1)):
        assert (k1b_ops[("trans", op)] - k1a_ops.get(("trans", op), 0)) / 1024 == extra
    k1a, _ = roofline.chain_ops_per_ray(chip_smoke.flagship(1 << 22, 1, engine="fused"),
                                        chunk=1024)
    assert small["trans"] >= k1a["trans"] + 5 and small["simple"] > k1a["simple"]


def test_cylinder_census_counts_its_stage():
    """K1c-cylinder's census (phase 45's ``cylinder`` entry,
    ``chain_ops_per_ray`` of ``chip_smoke.cylinder_config``) is finite and
    positive, and its crystal's element, the chain's census less that of
    the chain without it, holds the cylinder's stage: the hit's stable
    quadratic (a square root, two divisions), the normal's reciprocal
    square root (a square root, a reciprocal), the Bragg deviation's square
    root and the gaussian rocking curve's division and exp."""
    import copy

    import chip_smoke

    config = chip_smoke.cylinder_config(1 << 22, 1, "fused")
    counts, _ = roofline.chain_ops_per_ray(config, chunk=1024)
    assert all(np.isfinite(counts[c]) for c in roofline.CLASSES)
    assert counts["trans"] > 0 and counts["sqrtdiv"] > 0 and counts["simple"] > 0
    without = copy.deepcopy(config)
    del without["optics"]["crystal"]
    full = roofline._chain_census(config, 1024)[1]
    less = roofline._chain_census(without, 1024)[1]
    stage = {op: (full.get(op, 0) - less.get(op, 0)) / 1024
             for op in (("sqrtdiv", "sqrt"), ("sqrtdiv", "div"), ("sqrtdiv", "reciprocal"),
                        ("trans", "exp"))}
    assert stage == {("sqrtdiv", "sqrt"): 3.0, ("sqrtdiv", "div"): 3.0,
                     ("sqrtdiv", "reciprocal"): 1.0, ("trans", "exp"): 1.0}


def _k5_chain(name):
    """A K5 chain of ``chip_smoke.py``'s gradient phases (2^22 rays; the
    census takes its own chunk)."""
    import chip_smoke

    if name == "flagship":
        return chip_smoke.grad_flagship(1 << 22, 1)
    if name in ("torus", "cylinder"):
        return chip_smoke.grad_timing_configs()[name]
    return chip_smoke.grad_variant(name, 1 << 22)


@pytest.mark.parametrize("name", ["flagship", "plasma_cubic"])
def test_k5_census_is_per_ray(name):
    """K5's census (``k5_ops_per_ray``) grows with the rays and not the
    chunk: from chunks 1024 to 2048 and 2048 to 4096 the totals grow by the
    same operations a ray within 1 % class by class (a few counts follow the
    rays' hits), and the census per ray at 4096 passes that by at most the
    work of one call (the images' sums: the image floats and a few scalars)
    over the chunk; K5b's census holds K5f's, class by class, with more
    square roots and divisions."""
    from xicsrt_tpu_torch.engine import Pipeline
    from xicsrt_tpu_torch.ops import fused_grad as fg

    config = _k5_chain(name)
    img_total = fg.build_fused_diff(Pipeline(config, device="cpu"), num_iter=1)[3][
        "static"].img_total
    for backward in (False, True):
        totals = [{k: v * chunk for k, v in roofline.k5_ops_per_ray(
            config, backward, chunk=chunk)[0].items()} for chunk in (1024, 2048, 4096)]
        for cls in roofline.CLASSES:
            a, b, c = (t[cls] for t in totals)
            per_ray = (c - b) / 2048
            assert (b - a) / 1024 == pytest.approx(per_ray, rel=1e-2, abs=1e-9)
            assert -1e-2 * per_ray <= c / 4096 - per_ray <= 1e-2 * per_ray + (
                img_total + 64) / 4096
    forward, _ = roofline.k5_ops_per_ray(config, False, chunk=2048)
    backward, _ = roofline.k5_ops_per_ray(config, True, chunk=2048)
    for cls in roofline.CLASSES:
        assert backward[cls] >= forward[cls]
    assert backward["sqrtdiv"] > forward["sqrtdiv"] and forward["mxu_macs"] == 0.0


@pytest.mark.parametrize("name", ["flagship", "torus", "plasma_cubic", "file_rocking"])
def test_k5_hand_count_against_the_census(name):
    """``k5_ops``, the hand count of K5's flat bound, against the census of
    its twins (trans, sqrt-division and simple together): the census is
    1-1.75 times the hand count for K5f, whose twin spends index arithmetic
    and clamps on the bilinear splat that the hand count prices at 24, and
    1-1.3 times for K5b (forward and adjoint)."""
    from xicsrt_tpu_torch.ops import fused_grad as fg

    for backward, high in ((False, 1.75), (True, 1.3)):
        counts, pipe = roofline.k5_ops_per_ray(_k5_chain(name), backward, chunk=2048)
        static = fg.build_fused_diff(pipe, num_iter=1)[3]["static"]
        census = sum(counts[c] for c in ("trans", "sqrtdiv", "simple"))
        ratio = census / roofline.k5_ops(static, backward)
        assert 1.0 <= ratio <= high, (backward, ratio)


def test_mosaic_census_counts_every_layer():
    """The twin evaluates all 15 layers of ``mosaic15`` for every ray: two
    erfinv and one exp a layer, beside the source's one sin. One layer's
    census, the census at depth 15 less that at depth 14: 3 trans, 4
    sqrtdiv (two square roots, a reciprocal and a division) and 66 simple
    operations."""
    config, _ = roofline.scenario_config("mosaic15")
    counts, _ = roofline.chain_ops_per_ray(config, chunk=1024)
    assert counts["trans"] == pytest.approx(1 + 3 * 15)
    crystal = next(o for o in config["optics"].values() if "mosaic_depth" in o)
    assert crystal["mosaic_depth"] == 15
    crystal["mosaic_depth"] = 14
    fewer, _ = roofline.chain_ops_per_ray(config, chunk=1024)
    layer = {c: counts[c] - fewer[c] for c in roofline.CLASSES}
    assert layer["mxu_macs"] == 0.0
    assert layer["trans"] == pytest.approx(3.0)
    assert layer["sqrtdiv"] == pytest.approx(4.0)
    assert layer["simple"] == pytest.approx(66.0, abs=0.5)


def _k3_chain(name):
    """A K3 chain of ``chip_smoke.py``'s K3 timings at a small budget (the
    census takes its own chunk of rays)."""
    import chip_smoke

    if name == "plasma_torus":
        return chip_smoke.plasma_config(1 << 14, 1)
    return chip_smoke.flagship(1 << 14, 1, engine="fused",
                               interact_mode="weight" if name == "weight" else "mc")


@pytest.mark.parametrize("name", ["flagship", "weight", "plasma_torus"])
def test_k3_census_is_the_chain_alone(name):
    """K3's census (``k3_ops_per_ray``, its twin on eager rays) per ray at
    chunks 1024 and 4096 within 1 % class by class; 29 bytes a ray read,
    33 in weight mode; 1-1.5 times the chain's hand count; below K1's
    census of the same chain by the source's work (the flagship: its one
    sine and its square roots and divisions); a torus's four Newton steps
    take at least 16 square roots and divisions."""
    config = _k3_chain(name)
    small, per_ray, pipe = roofline.k3_ops_per_ray(config, chunk=1024)
    large, _, _ = roofline.k3_ops_per_ray(config, chunk=4096)
    for cls in roofline.CLASSES:
        assert small[cls] == pytest.approx(large[cls], rel=1e-2, abs=1e-9)
    assert per_ray == (33 if name == "weight" else 29)
    census = sum(large[c] for c in ("trans", "sqrtdiv", "simple"))
    assert 1.0 <= census / roofline.chain_k1_ops(roofline.k3_pack(pipe)) <= 1.5
    assert large["mxu_macs"] == 0.0
    if name == "plasma_torus":
        assert large["sqrtdiv"] >= 16
    else:
        k1, _ = roofline.chain_ops_per_ray(config, chunk=1024)
        assert k1["trans"] - large["trans"] == pytest.approx(1.0)
        assert k1["sqrtdiv"] > large["sqrtdiv"] and k1["simple"] > large["simple"]


def test_mosaic_ops_as_run_against_a_hand_count():
    """``mosaic_ops_as_run`` on ``mosaic15`` cut to depth 3, for a run of
    1000 rays that evaluates 1250 layers: the twin's census less 1.75
    unused layers a ray, each 3 trans, 4 sqrtdiv and 66 simple operations
    (``test_mosaic_census_counts_every_layer``): trans 1 + 3 x 1.25 by hand
    (the source's sine and three a layer); and its class-rate serial and
    overlap bounds, with and without bytes, by hand."""
    config, _ = roofline.scenario_config("mosaic15")
    crystal = next(o for o in config["optics"].values() if "mosaic_depth" in o)
    crystal["mosaic_depth"] = 3
    work = {"depth": 3, "layers": 1250, "entering": 500, "accepted": None}
    as_run = roofline.mosaic_ops_as_run(config, work, 1000, chunk=1024)
    full, _ = roofline.chain_ops_per_ray(config, chunk=1024)
    assert as_run["trans"] == pytest.approx(1.0 + 3.0 * 1.25)
    assert as_run["sqrtdiv"] == pytest.approx(full["sqrtdiv"] - 4.0 * 1.75)
    assert as_run["simple"] == pytest.approx(full["simple"] - 66.0 * 1.75, abs=1.0)
    rates = {"mxu_macs_per_s": 1e14, "trans_per_s": 1e12, "sqrtdiv_per_s": 2e12,
             "simple_per_s": 4e13}
    counts = {"mxu_macs": 0.0, "trans": 2.0, "sqrtdiv": 4.0, "simple": 40.0}
    assert roofline.serial_ms(counts, rates, 1000) == pytest.approx(
        1000 * (2 / 1e12 + 4 / 2e12 + 40 / 4e13) * 1e3)
    assert roofline.serial_ms(counts, rates, 1000, 3.35e6) == pytest.approx(
        roofline.serial_ms(counts, rates, 1000) + 1e-3)
    assert roofline.overlap_ms(counts, rates, 1000) == pytest.approx(2e-6)
    assert roofline.overlap_ms(counts, rates, 1000, 3.35e7) == pytest.approx(1e-2)
    crystal["mosaic_depth"] = 4
    with pytest.raises(ValueError):
        roofline.mosaic_ops_as_run(config, work, 1000, chunk=1024)


def test_mosaic_schedule_by_hand():
    """``mosaic_schedule`` on one warp whose rays need 1, 15 and 9 of 15
    layers (the rest do not enter): a ray a lane, 15 layer steps. Spread
    over the warp, chunks of 4 layers a lane: in groups of 4 lanes (16
    layers a ray and round) one round of 4 steps; in groups of 2 (8 layers)
    two rounds, 8 steps; in chunks of 1 and groups of 8 (the rays take
    layers 0-7, then the last two 8-15), 2 steps; in weight mode ceil(3 x 4
    / 32) = 1 round, 4 steps. A warp of 32 rays that all need 15: in groups
    of 4, 4 rounds (8 rays a round), 16 steps, one more than a ray a lane,
    and as many in weight mode."""
    w = np.zeros(32, dtype=np.int64)
    w[:3] = [1, 15, 9]
    assert roofline.mosaic_schedule(w, 15, 4, False) == {
        "layers": 25, "serial": 32 * 15, "cooperative": 32 * 4}
    assert roofline.mosaic_schedule(w, 15, 2, False)["cooperative"] == 32 * 8
    assert roofline.mosaic_schedule(w, 15, 8, False, chunk=1)["cooperative"] == 32 * 2
    assert roofline.mosaic_schedule(w, 15, 4, True)["cooperative"] == 32 * 4
    full = np.full(32, 15)
    assert roofline.mosaic_schedule(full, 15, 4, False)["cooperative"] == 32 * 16
    assert roofline.mosaic_schedule(full, 15, 4, False)["serial"] == 32 * 15
    assert roofline.mosaic_schedule(full, 15, 4, True)["cooperative"] == 32 * 16
    none = np.zeros(64, dtype=np.int64)
    assert roofline.mosaic_schedule(none, 15, 4, False) == {
        "layers": 0, "serial": 0, "cooperative": 0}


@pytest.mark.parametrize("weight", [False, True])
def test_mosaic_needed_follows_the_run(weight):
    """``mosaic_needed`` draws each ray's needed layers from a run's
    ``mosaic_work``: as many zeros as rays that do not enter, the layers'
    sum the run's layers, in mc mode A(l) - A(l - 1) rays needing l (and
    the rays no layer accepts the depth); every schedule of them uses at
    least the layers it needs."""
    n, depth = 4096, 5
    accepted = [0, 100, 180, 240, 290, 320]
    entering = 1500
    layers = entering * depth if weight else sum(entering - a for a in accepted[:-1])
    work = {"depth": depth, "entering": entering, "layers": layers,
            "accepted": None if weight else accepted}
    needed = roofline.mosaic_needed(work, n)
    assert needed.shape == (n,) and int((needed == 0).sum()) == n - entering
    assert int(needed.sum()) == layers
    if not weight:
        for l in range(1, depth):
            assert int((needed == l).sum()) == accepted[l] - accepted[l - 1]
    for group in (2, 4):
        slots = roofline.mosaic_schedule(needed, depth, group, weight)
        assert slots["layers"] == layers
        assert layers <= slots["cooperative"] and layers <= slots["serial"]


@pytest.mark.parametrize("body", ["trans", "sqrtdiv", "simple"])
def test_rate_numerator_is_the_census_of_its_body(body):
    """The K-dependent census of R1's plain version, in the body's class,
    is the numerator the tool divides by the time: the steps times
    ``body_ops``. R2's is its plain version's MACs."""
    seed = torch.tensor([0.6], dtype=torch.float32)
    cls = body  # each body is named for the class it measures
    with_k = roofline.count_ops(rp.elem_rate_plain, seed, body, n_chunks=2, K=5)
    without = roofline.count_ops(rp.elem_rate_plain, seed, body, n_chunks=2, K=0)
    numerator = rp.elem_steps(body, n_chunks=2, K=5) * roofline.body_ops(body)[cls]
    assert with_k[cls] - without[cls] == numerator
    census = roofline.count_ops(rp.mma_rate_plain, seed, n_mm=3, K_mm=2, sub=64)
    assert census["mxu_macs"] == rp.mma_macs(3, 2, 64)


@pytest.mark.parametrize("body", ["trans", "sqrtdiv", "simple"])
def test_r1_step_check_tells_the_steps_apart(body):
    """``chip_smoke.r1_step_check`` on the CPU, where R1's wrapper takes the
    plain version: it passes, and a probe that runs one step fewer than it
    is asked fails it, though at the tool's K = 128 the trans and sqrtdiv
    outputs of K and K - 1 steps agree within ``r1_bound``."""
    import types

    import chip_smoke

    seed = torch.tensor([0.5625], dtype=torch.float32)
    assert chip_smoke.r1_step_check(rp, seed, body, n_chunks=2) <= 1e-6 * float(
        chip_smoke.r1_reference(rp, seed, body, 2, 4)[0, 0])

    def short(seed, body, n_chunks=None, K=rp.K_STEPS):
        return rp.elem_rate_plain(seed, body, n_chunks=n_chunks, K=K - 1)

    with pytest.raises(AssertionError, match="beyond the bound"):
        chip_smoke.r1_step_check(types.SimpleNamespace(**{**vars(rp), "elem_rate_cuda": short}),
                                 seed, body, n_chunks=2)
    if body != "simple":
        at_128 = chip_smoke.r1_reference(rp, seed, body, 2, 128)[0, 0]
        at_127 = chip_smoke.r1_reference(rp, seed, body, 2, 127)[0, 0]
        assert abs(float(at_128 - at_127)) <= chip_smoke.r1_bound(2, rp.SUB) * float(at_128)


def test_sfu_classes_are_capped_at_the_sfu_rate():
    """trans and sqrtdiv rates are held below the special function units'
    16 results per SM and clock (132 SMs, 1980 MHz), which every exp, square
    root and division of R1's bodies passes through once. Held to the FP32
    peak instead, a probe that ran a sixteenth of its steps would pass."""
    sfu = 16 * 132 * 1.98e9
    assert roofline.PEAK_PER_S["trans"] == roofline.PEAK_PER_S["sqrtdiv"] == sfu
    assert roofline.PEAK_PER_S["simple"] == roofline.FP32_OPS_PER_S > 16 * sfu
    assert roofline.PEAK_PER_S["mxu_macs"] == roofline.BF16_MACS_PER_S


def test_body_ops_as_the_kernels_compute_them():
    """exp(-0.9 y): a multiply and an exp; 1/sqrt(|y| + 1): two sqrtdiv
    (the port's rsqrt) and two simple; the where body five simple."""
    assert roofline.body_ops("trans") == {"mxu_macs": 0.0, "trans": 1.0, "sqrtdiv": 0.0,
                                          "simple": 1.0}
    assert roofline.body_ops("sqrtdiv")["sqrtdiv"] == 2.0
    assert roofline.body_ops("sqrtdiv")["simple"] == 2.0
    assert roofline.body_ops("simple")["simple"] == 5.0


def test_measuring_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.microbench_rates()
    out = tmp_path / "roofline.json"
    for argv in (["flagship", "--out", str(out)], ["--out", str(out)]):
        with pytest.raises(RuntimeError, match="CUDA"):
            roofline.main(argv)
    assert not out.exists()
    with pytest.raises(SystemExit):
        roofline.main(["toroid"])
    with pytest.raises(RuntimeError, match="CUDA"):
        BS.time_launches(lambda k: None)


def test_hand_counts_live_in_the_tool():
    """chip_smoke.py's flat bound uses the tool's hand counts; the
    flagship's K1a is 257 float32 operations a ray."""
    import chip_smoke
    from xicsrt_tpu_torch.engine import Pipeline

    for name in ("OPS_PER_RAY", "bound", "k1_ops", "k5_ops", "chain_k1_ops",
                 "mosaic_work", "mosaic_k1_ops"):
        assert getattr(chip_smoke, name) is getattr(roofline, name)
    config, _ = roofline.scenario_config("flagship")
    assert roofline.k1_ops(roofline.k1_pack(Pipeline(config, device="cpu"))) == 257
    assert roofline.bound(3.35e9, 0) == (1.0, "bytes")
    assert roofline.bound(0, 67e9) == (1.0, "operations")


def test_scenarios_are_the_jax_sides():
    """The port's copies of the scenario configs equal ``tools/
    bench_scenarios.py``'s and ``__graft_entry__``'s (plain dicts; those
    files import JAX only inside functions)."""
    from __graft_entry__ import _spectrometer_config
    from tools import bench_scenarios as jax_side

    assert set(BS.SCENARIOS) == set(jax_side.SCENARIOS)
    for name in BS.SCENARIOS:
        np.testing.assert_equal(BS.SCENARIOS[name](1 << 20, 3),
                                jax_side.SCENARIOS[name](1 << 20, 3))
    np.testing.assert_equal(BS._spectrometer_config(1 << 20, 2, keep_images=True),
                            _spectrometer_config(1 << 20, 2, keep_images=True))


def test_port_tools_import_nothing_of_the_jax_side():
    """Parsed, not imported: no module of the port imports JAX, the JAX
    package, the repository's ``tools`` or ``__graft_entry__``."""
    package = os.path.dirname(xicsrt_tpu_torch.__file__)
    banned = ("jax", "xicsrt_tpu", "tools", "__graft_entry__")
    files = [os.path.join(root, f) for root, _, names in os.walk(package)
             for f in names if f.endswith(".py")]
    assert any(f.endswith(os.path.join("tools", "roofline.py")) for f in files)
    found = {}
    for path in files:
        for node in ast.walk(ast.parse(open(path).read(), filename=path)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            bad = [n for n in names if n.split(".")[0] in banned]
            if bad:
                found[path] = bad
    assert not found



def _primitive_size(jaxpr, names) -> int:
    """Output elements of the primitives ``names`` in a jaxpr, sub-jaxprs
    included, as JAX's ``count_ops`` walks it."""
    total = 0
    for eqn in jaxpr.eqns:
        for p in eqn.params.values():
            if hasattr(p, "jaxpr"):
                total += _primitive_size(p.jaxpr, names)
            elif hasattr(p, "eqns"):
                total += _primitive_size(p, names)
        if eqn.primitive.name in names:
            total += int(np.prod(eqn.outvars[0].aval.shape))
    return total


@pytest.mark.parametrize("name", roofline.SCENARIO_NAMES)
def test_census_is_jax_census_less_the_tpu_workarounds(name, monkeypatch):
    """Class by class, the port's census of K1 is JAX's census of its TPU
    kernel less what the port dropped by design: the MXU's one-hot binning
    (all of JAX's MACs, and its ``eq`` and ``convert_element_type`` one-hot
    construction, which also holds the few ordinary conversions), for a
    plasma the interval one-hot bundle gather (8 x min(B_pad, 4096) MACs
    and 3 x min(B_pad, 4096) simple operations a ray, JAX
    ``tools/roofline.py:196-199``); and ``rsqrt``, one sqrtdiv in JAX, is
    two in the port (``1/sqrt``). Held within 1 operation for trans and
    sqrtdiv and 10 % for simple."""
    from tools import roofline as jax_roofline
    from xicsrt_tpu.ops.fused_trace import image_macs_per_ray

    chunk = 8192
    one_hot = [0]
    rsqrt = [0]
    count_ops = jax_roofline.count_ops

    def tallied(fn, *args):
        jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
        one_hot[0] += _primitive_size(jaxpr, ("eq", "convert_element_type"))
        rsqrt[0] += _primitive_size(jaxpr, ("rsqrt",))
        return count_ops(fn, *args)

    monkeypatch.setattr(jax_roofline, "count_ops", tallied)
    config, _ = roofline.scenario_config(name)
    config["general"].pop("engine")
    ref, pipeline = jax_roofline.chain_ops_per_ray(config, chunk=chunk)
    ours, _ = roofline.chain_ops_per_ray(config, chunk=chunk)
    gather = 0
    if name.startswith("plasma"):
        gather = min(-(-max(int(pipeline.source.bundle_count), 128) // 128) * 128, 4096)
    image_macs = sum(image_macs_per_ray(nx, ny)
                     for (nx, ny), _ in pipeline.image_specs().values())
    assert ref["mxu_macs"] == image_macs + 8 * gather > 0
    assert ours["mxu_macs"] == 0
    assert abs(ref["trans"] - ours["trans"]) <= 1
    assert abs(ref["sqrtdiv"] + rsqrt[0] / chunk - ours["sqrtdiv"]) <= 1
    simple = ref["simple"] - one_hot[0] / chunk - 3 * gather
    assert ours["simple"] == pytest.approx(simple, rel=0.1)
