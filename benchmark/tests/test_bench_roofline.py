"""The yardstick's arithmetic against hand counts: K1's census and bound,
the trace's intervals, and the per-layer readers on a made-up trace."""

import pytest

from benchhelp import spec
from harness import cell as cell_run
from harness import devtrace, roofline

SPEC = spec.load_spec()
# Float32 operations a ray, by hand from the kernels' stages (the census
# of tools/roofline.py's OPS_PER_RAY): the isotropic cone 11 and its
# rotation 15; a plane's hit 22, a sphere's 39, a torus's 327; bounds 17;
# a gaussian crystal's test in mc mode 32; a nearest image 10; a plasma ray
# from its bundle 105.
HAND = {
    "flagship": (11 + 15, {"crystal": 39 + 17 + 32 + 10, "detector": 22 + 17 + 10}),
    "plasma": (105, {"crystal": 327 + 17 + 32 + 10, "detector": 22 + 17 + 10}),
}


@pytest.mark.parametrize("config", sorted(HAND))
def test_census_matches_hand_counts(config):
    census = spec.load_json(f"{spec.BENCH_DIR}/roofline/{config}.json")
    source, optics = HAND[config]
    assert census["source_ops_per_ray"] == source
    assert census["optic_ops_per_ray"] == optics


def test_call_bound_by_hand():
    census = spec.load_json(f"{spec.BENCH_DIR}/roofline/flagship.json")
    peak = roofline.peaks()
    counts = {"source": 1 << 28, "crystal": 3_600_000, "detector": 3_500_000}
    ops = 26 * (1 << 28) + 98 * (1 << 28) + 49 * 3_600_000
    assert roofline.call_bound_s(census, peak, counts, 1, 4) == pytest.approx(ops / 67e12, rel=1e-12)
    assert roofline.call_bound_s(census, peak, counts, 4, 4) == pytest.approx(ops / 67e12, rel=1e-12)
    few = {"source": 10, "crystal": 1, "detector": 1}
    assert roofline.call_bound_s(census, peak, few, 2, 4) == pytest.approx(2 * 60740 / 3.35e12)
    plasma = spec.load_json(f"{spec.BENCH_DIR}/roofline/plasma.json")
    assert roofline.call_bound_s(plasma, peak, {"plasma": 0, "crystal": 0, "detector": 0}, 1, 4) == (
        pytest.approx((60740 + 4 * 144000) / 3.35e12))


def test_kernel_names():
    census = {"kernels": ["fused_trace"]}
    assert roofline.is_kernel(census, "void fused_trace_flat_kernel<0>(float const*, int)")
    assert roofline.is_kernel(census, "fused_trace_kernel<1, 0, 2>")
    assert roofline.is_kernel(census, "void (anonymous namespace)::fused_trace_flat_kernel"
                              "<0, false>(float const*, int, int const*, int)")
    assert roofline.is_kernel(census, "void (anonymous namespace)::fused_trace_kernel<2, false,"
                              " 0, 0>(float const*)")
    assert not roofline.is_kernel(census, "void at::native::vectorized_elementwise_kernel<4>()")
    assert not roofline.is_kernel(census, "Memcpy DtoH (Device -> Pageable)")


def test_intervals():
    u = devtrace.union([(3, 4), (0, 1), (0.5, 2), (5, 6)])
    assert u == [(0, 2), (3, 4), (5, 6)]
    assert devtrace.covered(u, 1, 5.5) == pytest.approx(1 + 1 + 0.5)
    assert devtrace.gaps(devtrace.clip(u, 0.5, 7), (0.5, 7)) == [(2, 3), (4, 5), (6, 7)]
    spans = [("raytrace_run", 0.0, 10.0), ("build_runner", 2.0, 3.0)]
    assert devtrace.innermost(spans, 2.5) == "build_runner"
    assert devtrace.innermost(spans, 5.0) == "raytrace_run"
    assert devtrace.innermost(spans, 11.0) == "harness"


def _ctx(cell_name):
    cell = spec.resolve(SPEC, cell_name)
    calls = [{"index": i, "t0": 10.0 * i, "t1": 10.0 * i + 9.0, "rays": 100,
              "counts": {"source": 1 << 26, "crystal": 1 << 20, "detector": 1 << 20}}
             for i in range(2)]
    spans = [("build_runner", 0.0, 2.0), ("raytrace_run", 2.0, 9.0),
             ("build_runner", 10.0, 12.0), ("raytrace_run", 12.0, 19.0)]
    ops = [("void fused_trace_flat_kernel<0>(...)", 0, 4.0, 8.0),
           ("Memcpy DtoH", 0, 8.0, 8.5), ("void fused_trace_flat_kernel<0>(...)", 0, 14.0, 18.0),
           ("void fused_trace_flat_kernel<0>(...)", 1, 14.0, 16.0)]
    return cell_run.Context(cell=cell, setup_s=1.0, window=(0.0, 20.0), calls=calls,
                            devices=["cuda:0", "cuda:1"], spans=spans, ops=ops)


def test_readers_on_a_made_up_trace():
    ctx = _ctx("flagship.scan")
    read = {m: spec.metric_reader(m)(ctx) for m in
            ("build_ms", "run_host_ms", "idle_pct.trace", "k1_roofline", "mfu.trace",
             "rays_per_s", "setup_s")}
    assert read["build_ms"] == pytest.approx(2000.0)
    # raytrace_run 7 s a call, of which the union of devices is busy 4.5 and 4 s.
    assert read["run_host_ms"] == pytest.approx((2.5 + 3.0) / 2 * 1e3)
    # device 0 busy 8.5 of 20 s, device 1 2 of 20.
    assert read["idle_pct.trace"] == pytest.approx(100 * ((1 - 8.5 / 20) + (1 - 2 / 20)) / 2)
    bound = roofline.bound_total_s(ctx)
    assert read["k1_roofline"] == pytest.approx(100 * bound / 10.0)
    assert read["mfu.trace"] == pytest.approx(100 * bound / (20.0 * 2))
    assert read["rays_per_s"] == pytest.approx(200 / 20.0)
    assert read["setup_s"] == 1.0
    untraced = _ctx("flagship.scan")
    untraced.spans = untraced.ops = None
    for m in ("build_ms", "run_host_ms", "idle_pct.trace", "k1_roofline", "mfu.trace"):
        assert spec.metric_reader(m)(untraced) is None


def test_breakdown_names_gaps_by_span():
    ctx = _ctx("flagship.scan")
    b = cell_run.breakdown(ctx.ops, ctx.spans, ctx.window)
    assert b["device_ops"][0][0].startswith("void fused_trace_flat_kernel")
    assert b["device_ops"][0][1] == pytest.approx(10.0)
    # idle: [8.5, 14), of it raytrace_run 2.5 s, build_runner 2, the loop 1;
    # [0, 4); [18, 20).
    assert [g[1] for g in b["idle_gaps"]] == pytest.approx([5.5, 4.0, 2.0])
    assert b["idle_gaps"][0][0] == "raytrace_run"
    assert devtrace.dominant(ctx.spans, 8.5, 11.5) == "build_runner"
    assert devtrace.dominant(ctx.spans, 8.5, 10.4) == "harness"
    assert devtrace.dominant([], 0.0, 1.0) == "harness"


def test_k5_census_matches_hand_counts():
    """K5f: the source 11 + 15; a sphere 45, bounds 17, a weighed crystal
    38, a bilinear image 24; a plane 22, bounds, an image. K5b adds per
    optic the adjoint 141 and its shape's (sphere 98, plane 53), and the
    crystal's 41."""
    census = spec.load_json(f"{spec.BENCH_DIR}/roofline/flagship.k5.json")
    forward = (11 + 15) + (45 + 17 + 38 + 24) + (22 + 17 + 24)
    assert census["forward_ops_per_ray"] == forward == 213
    assert census["vjp_ops_per_ray"] == forward + (141 + 98 + 41) + (141 + 53)


def _fit_ctx():
    cell = spec.resolve(SPEC, "flagship.fit")
    calls = [{"index": i, "t0": 1.0 * i, "t1": 1.0 * i + 0.8, "rays": 1 << 24} for i in range(4)]
    ops = [("void (anonymous namespace)::fused_grad_fwd_kernel<0>(...)", 0, 0.1, 0.2),
           ("void fused_grad_replay_kernel<0, 0, 0, 0>(...)", 0, 0.2, 0.6),
           ("Memcpy DtoH", 0, 0.6, 0.65)]
    ops += [(n, d, s + i, e + i) for i in (1, 2, 3) for n, d, s, e in ops[:3]]
    return cell_run.Context(cell=cell, setup_s=2.0, window=(0.0, 3.8), calls=calls,
                            devices=["cuda:0"], spans=[], ops=ops)


def test_fit_readers_on_a_made_up_trace():
    ctx = _fit_ctx()
    read = {m: spec.metric_reader(m)(ctx) for m in
            ("grad_rays_per_s", "fit_host_ms", "k5_roofline", "mfu.fit", "idle_pct.fit")}
    assert read["grad_rays_per_s"] == pytest.approx(4 * (1 << 24) / 3.8)
    # each 0.8 s step holds 0.55 s of device work
    assert read["fit_host_ms"] == pytest.approx(250.0)
    bound = 4 * (1 << 24) * (213 + 687) / 67e12
    assert roofline.k5_bound_total_s(ctx, {"forward_ops_per_ray": 213,
                                           "vjp_ops_per_ray": 687}) == pytest.approx(bound)
    assert read["k5_roofline"] == pytest.approx(100 * bound / (4 * 0.5))
    assert read["mfu.fit"] == pytest.approx(100 * bound / 3.8)
    assert read["idle_pct.fit"] == pytest.approx(100 * (1 - 4 * 0.55 / 3.8))
    ctx.ops = None
    for m in ("fit_host_ms", "k5_roofline", "mfu.fit", "idle_pct.fit"):
        assert spec.metric_reader(m)(ctx) is None
