"""The CUDA kernels against their plain twins, on the card, and the plasma
path through both engines.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

from __graft_entry__ import _spectrometer_config
from xicsrt_tpu_torch.engine import Pipeline
from xicsrt_tpu_torch.ops import fused_trace as ft
from xicsrt_tpu_torch.ops.pallas_binning import bin_image_plain, bin_images_cuda

pytestmark = pytest.mark.cuda

# Rays that may differ per element between the kernel and its twin: both
# round the same float32 operations in the same order, but a ray exactly at
# a threshold may still fall apart where two math-library calls round apart.
TOL_RAYS = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("nx,ny,ps", [(100, 100, 0.002), (100, 50, 0.004),
                                      (40, 20, 0.005), (1200, 1000, 0.001)])
def test_binning_kernel_matches_twin(cuda_device, nx, ny, ps):
    """Unit weights bin exactly; the last shape exceeds shared memory and
    takes the global-atomics path."""
    rng = np.random.default_rng(5)
    n = 1 << 18
    x = np.zeros((n, 3), np.float32)
    x[:, 0] = rng.uniform(-0.5, 0.5, n) * (nx + 4) * ps
    x[:, 1] = rng.uniform(-0.5, 0.5, n) * (ny + 4) * ps
    xt = torch.from_numpy(x).to(cuda_device)
    mt = torch.from_numpy(rng.uniform(size=n) < 0.9).to(cuda_device)
    ones = torch.ones(n, device=cuda_device)
    before = bin_images_cuda.launches
    out, = bin_images_cuda([(xt, mt, ones, nx, ny, ps)])
    assert bin_images_cuda.launches == before + 1
    assert torch.equal(out, bin_image_plain(xt, mt, ones, nx, ny, ps))


@pytest.mark.parametrize("angular", ["isotropic_xy", "isotropic"])
def test_fused_kernel_matches_twin(cuda_device, angular):
    cfg = _spectrometer_config(intensity=1 << 18, engine="fused")
    cfg["sources"]["source"]["angular_dist"] = angular
    pipe = Pipeline(cfg, device=cuda_device)
    src = ft._source_spec(pipe.source)
    optics = [ft._optic_spec(o) for o in pipe.optics]
    fparams = ft.pack_params(src, optics, pipe.params, cuda_device)
    n = pipe.num_rays
    before = ft.fused_run_cuda.launches
    kernel = ft.fused_run_cuda(fparams, n, n - 7, seed=(3, 4))
    twin = ft.fused_run_plain(fparams, n, n - 7, seed=(3, 4))
    assert ft.fused_run_cuda.launches == before + 1
    assert int(kernel[0][0]) == n - 7
    assert (kernel[0] - twin[0]).abs().max().item() <= TOL_RAYS
    assert (kernel[1] - twin[1]).abs().sum().item() <= 2 * TOL_RAYS * len(optics)


def _k1a_case(case, n):
    """K1a's chains: the flagship; a sparse one (a 5 cm crystal, the last
    5000 rays dead at the source), where more warps leave the chain early;
    phase 27's convex toroidal crystals, which take the build with the torus
    code. Returns (config, count, curved shapes, build)."""
    import chip_smoke

    if case == "torus":
        return (chip_smoke.mirror_configs(n, 1, "fused")["torus_no_check"], n, 1,
                "fused_trace_kernel<point, kStages 0>")
    cfg = chip_smoke.flagship(n, 1, engine="fused")
    if case == "sparse":
        cfg["optics"]["crystal"]["xsize"] = 0.05
        return cfg, n - 5000, 0, "fused_trace_flat_kernel<0>"
    return cfg, n, 0, "fused_trace_flat_kernel<0>"


@pytest.mark.parametrize("rng", ["input", "hw"])
@pytest.mark.parametrize("case", ["flagship", "sparse", "torus"])
def test_k1a_matches_twin_exactly(cuda_device, case, rng):
    """K1a's builds (images in global atomics where staging costs a block,
    warps leaving the chain once their lanes are dead, the point build
    without the torus and cylinder code) 0 rays and 0 pixels apart from the
    twin, both RNG modes; the flagship takes fused_trace_flat_kernel<0>,
    the torus (dense images asked for) the build with every shape."""
    import chip_smoke
    from xicsrt_tpu_torch.tools.roofline import k1_pack

    n = 1 << 18
    cfg, count, shapes, build = _k1a_case(case, n)
    fparams = k1_pack(Pipeline(cfg, device=cuda_device))
    assert (fparams.full_source, fparams.cheb, fparams.stages, fparams.shapes) == (
        False, False, 0, shapes)
    assert chip_smoke.k1_build_name(fparams) == build
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    kwargs = ({"uniforms": torch.rand((fparams.n_draws, n), generator=gen,
                                      device=cuda_device)}
              if rng == "input" else {"seed": (21, 22)})
    before = ft.fused_run_cuda.launches
    kernel = ft.fused_run_cuda(fparams, n, count, **kwargs)
    twin = ft.fused_run_plain(fparams, n, count, **kwargs)
    assert ft.fused_run_cuda.launches == before + 1
    assert int(kernel[0][0]) == count
    assert int(kernel[0][-1]) > 0
    assert torch.equal(kernel[0], twin[0])
    assert torch.equal(kernel[1], twin[1])


@pytest.mark.parametrize("weights", ["unit", "float"])
def test_k2_one_launch_matches_plain_per_image(cuda_device, weights):
    """K2's one launch for several images (ray counts of their own, one mask
    not 16-byte aligned, an empty item) against bin_image_plain of each:
    unit weights exactly (the unit flag's integer counters, and the float
    path), random weights within float32 summation order."""
    rng = np.random.default_rng(12)
    items = []
    for (nx, ny, ps), n in zip([(100, 100, 0.002), (100, 50, 0.004), (40, 20, 0.005),
                                (30, 30, 0.01)], [1 << 18, 77777, 1 << 16, 0]):
        x = np.zeros((n + 1, 3), np.float32)
        x[:, 0] = rng.uniform(-0.5, 0.5, n + 1) * (nx + 4) * ps
        x[:, 1] = rng.uniform(-0.5, 0.5, n + 1) * (ny + 4) * ps
        mask = torch.from_numpy(rng.uniform(size=n + 1) < 0.2).to(cuda_device)
        w = (np.ones(n + 1, np.float32) if weights == "unit"
             else rng.uniform(size=n + 1).astype(np.float32))
        # The second item's rays start one byte into their mask.
        cut = slice(1, None) if ny == 50 else slice(0, n)
        items.append((torch.from_numpy(x[cut]).to(cuda_device), mask[cut],
                      torch.from_numpy(w[cut]).to(cuda_device), nx, ny, ps))
    assert items[1][1].data_ptr() % 16 != 0
    flags = (True, False) if weights == "unit" else (False,)
    for unit in flags:
        before = bin_images_cuda.launches
        got = bin_images_cuda(items, unit_weights=unit)
        assert bin_images_cuda.launches == before + 1
        for image, item in zip(got, items):
            plain = bin_image_plain(*item)
            if weights == "unit":
                assert torch.equal(image, plain)
            else:
                assert torch.allclose(image, plain, rtol=1e-5, atol=1e-5)


def _grad_setup(cuda_device, n):
    from xicsrt_tpu_torch.ops import fused_grad as fg

    cfg = _spectrometer_config(intensity=n, interact_mode="weight",
                               image_mode="bilinear")
    pipe = Pipeline(cfg, device=cuda_device)
    _, _, pack, spec = fg.build_fused_diff(pipe)
    return fg, spec, pack(pipe.params).detach()


def test_fused_grad_kernels_match_twins(cuda_device):
    """K5f against its twin (totals rtol 1e-4, pixels 1e-3 of the maximum:
    atomics add in another order); K5b against the float32 twin (the same
    float32 arithmetic, slot sums in another order: rtol 1e-3, atol 1e-5 of
    the largest slot)."""
    n = 1 << 18
    fg, spec, pvec = _grad_setup(cuda_device, n)
    static, lam = spec["static"], spec["lam"]
    before = (fg.fused_grad_forward_cuda.launches, fg.fused_grad_vjp_cuda.launches)
    image = fg.fused_grad_forward_cuda(static, pvec, n, lam, seed=(3, 4))
    twin = fg.fused_grad_forward_plain(static, pvec, n, lam, seed=(3, 4))
    assert abs(image.sum().item() - twin.sum().item()) <= 1e-4 * twin.sum().item()
    assert (image - twin).abs().max().item() <= 1e-3 * twin.abs().max().item()
    g = torch.randn(static.img_total, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(1))
    grad = fg.fused_grad_vjp_cuda(static, pvec, n, lam, g, seed=(3, 4))
    grad_twin = fg.fused_grad_vjp_plain(static, pvec, n, lam, g, seed=(3, 4))
    scale = grad_twin.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(grad, grad_twin, rtol=1e-3, atol=1e-5 * scale)
    after = (fg.fused_grad_forward_cuda.launches, fg.fused_grad_vjp_cuda.launches)
    assert after == (before[0] + 1, before[1] + 1)


def _variant_config(kind):
    """``tests/test_fused_grad.py::_variant_config``, read from that file
    with ``ast`` (the file imports JAX; the card's machine has none)."""
    import ast
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_fused_grad.py")
    defs = [node for node in ast.parse(open(path).read()).body
            if isinstance(node, ast.FunctionDef) and node.name == "_variant_config"]
    namespace = {"np": np}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), namespace)
    return namespace["_variant_config"](kind)


def _grad_variant(kind, n):
    """A variant in the gradient path's modes with about ``n`` rays (a
    plasma's emissivity scaled to n expected photons)."""
    cfg = _variant_config(kind)
    cfg["general"].update(interact_mode="weight", image_mode="bilinear")
    if "plasma" in cfg["sources"]:
        cfg["sources"]["plasma"]["emissivity"] *= n / 1534.6
    else:
        cfg["sources"]["source"]["intensity"] = n
    return cfg


def _k5f_base(variant):
    """The chain of a K5 build variant (bit 0 a torus, bit 1 a cylinder,
    bits 2-3 the source, plus 12 with a mosaic): one whose least build the
    variant contains."""
    source, mosaic = (variant % 12) >> 2, variant >= 12
    if source == 1:
        return "plasma_cubic"
    if source == 2:
        return "focused_gaussian_voigt"
    if mosaic:
        return "mosaic_sphere"
    return ("torus_crystal" if variant & 1 else "cylinder_crystal" if variant & 2
            else "flagship")


# The chains at their own build, then every one of the 24 builds on a chain
# it contains (a build with more stages traces the same rays), then example
# 08's chain, whose 80 KB image takes blocks of more than 256 threads.
K5F_CASES = ([(kind, None) for kind in ("torus_crystal", "convex_torus_mirror",
                                         "cylinder_crystal", "convex_cylinder_mirror",
                                         "plasma_cubic")]
             + [("variant", v) for v in range(24)] + [("example08", None)])


@pytest.mark.parametrize("kind,variant", K5F_CASES,
                         ids=[k if v is None else f"variant{v}" for k, v in K5F_CASES])
def test_fused_grad_variants_match_twins(cuda_device, monkeypatch, kind, variant):
    """K5f and K5b (both its builds) on curved optics, plasmas, the generic
    source and mosaics in every build variant, against the float32 twins with
    test_fused_grad_kernels_match_twins's bounds, in both RNG modes, at a
    ray count that is no multiple of the K5f block the launch takes."""
    import chip_smoke
    from xicsrt_tpu_torch.ops import fused_grad as fg
    from xicsrt_tpu_torch.ops import native

    n = (1 << 17) + 17
    name = _k5f_base(variant) if kind == "variant" else kind
    if name == "flagship":
        cfg = _spectrometer_config(intensity=n, interact_mode="weight", image_mode="bilinear")
    elif name == "example08":
        cfg = chip_smoke.repo_function("examples/example_08_plasma_fitting.py",
                                       "_config")(8.3e20, 2.0e4)
        cfg["general"].update(interact_mode="weight", image_mode="bilinear")
    elif name in ("mosaic_sphere", "focused_gaussian_voigt"):
        cfg = chip_smoke.grad_variant(name, n)
    else:
        cfg = _grad_variant(name, n)
    pipe = Pipeline(cfg, device=cuda_device)
    _, _, pack, spec = fg.build_fused_diff(pipe)
    static, lam = spec["static"], spec["lam"]
    own = fg._variant(static)
    if variant is not None:
        # The same source; every stage of the chain's own build.
        assert own % 12 >> 2 == variant % 12 >> 2
        assert own % 4 & variant % 4 == own % 4 and (own < 12 or variant >= 12)
        monkeypatch.setattr(fg, "_variant", lambda st: variant)
    threads = native.library().xrt_fused_grad_fwd_threads(
        fg._variant(static), static.img_total, static.fp.numel(), static.ip.numel())
    assert threads >= 256 and n % threads
    if name == "example08":
        assert threads > 256
    pvec = pack(pipe.params).detach()
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    uniforms = torch.rand((static.n_draws, n), generator=gen, device=cuda_device)
    g = torch.randn(static.img_total, device=cuda_device, generator=gen)
    for kwargs in ({"seed": (8, 9)}, {"uniforms": uniforms}):
        image = fg.fused_grad_forward_cuda(static, pvec, n, lam, **kwargs)
        twin = fg.fused_grad_forward_plain(static, pvec, n, lam, **kwargs)
        assert twin.sum().item() > 0
        assert abs(image.sum().item() - twin.sum().item()) <= 1e-4 * twin.sum().item()
        assert (image - twin).abs().max().item() <= 1e-3 * twin.abs().max().item()
        grad = fg.fused_grad_vjp_cuda(static, pvec, n, lam, g, **kwargs)
        grad_twin = fg.fused_grad_vjp_plain(static, pvec, n, lam, g, **kwargs)
        scale = grad_twin.abs().max().item()
        assert scale > 0
        torch.testing.assert_close(grad, grad_twin, rtol=1e-3, atol=1e-5 * scale)
        # K5b's replay build, the launcher's for long chains, in the same variant.
        replay = fg.fused_grad_vjp_cuda(static, pvec, n, lam, g, _build="replay", **kwargs)
        torch.testing.assert_close(replay, grad_twin, rtol=1e-3, atol=1e-5 * scale)


def test_fused_cylinder_kernel_matches_twin(cuda_device):
    """K1's cylinder stage against its twin, at most TOL_RAYS apart."""
    cfg = _variant_config("cylinder_crystal")
    cfg["general"].update(engine="fused", interact_mode="mc", image_mode="nearest")
    cfg["sources"]["source"]["intensity"] = 1 << 18
    pipe = Pipeline(cfg, device=cuda_device)
    src = ft._source_spec(pipe.source)
    optics = [ft._optic_spec(o) for o in pipe.optics]
    fparams = ft.pack_params(src, optics, pipe.params, cuda_device)
    n = pipe.num_rays
    kernel = ft.fused_run_cuda(fparams, n, n, seed=(3, 4))
    twin = ft.fused_run_plain(fparams, n, n, seed=(3, 4))
    assert int(twin[0][-1]) > 1000
    assert (kernel[0] - twin[0]).abs().max().item() <= TOL_RAYS
    assert (kernel[1] - twin[1]).abs().sum().item() <= 2 * TOL_RAYS * len(optics)


def test_remat_on_cuda_draws_the_same_rays(cuda_device):
    """The checkpointed recompute forks the run's CUDA generator."""
    from xicsrt_tpu_torch.gradients import make_differentiable

    cfg = _spectrometer_config(intensity=1 << 14, num_iter=2)
    grads = []
    for remat in (False, True):
        image_fn, pipe = make_differentiable(cfg, remat=remat, device=cuda_device)
        d = pipe.params["optics"]["crystal"]["crystal_spacing"].clone().requires_grad_(True)
        params = dict(pipe.params)
        params["optics"] = dict(params["optics"])
        params["optics"]["crystal"] = dict(params["optics"]["crystal"], crystal_spacing=d)
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        image_fn(params, gen)["detector"].pow(2).sum().backward()
        grads.append(d.grad)
    assert grads[0].abs().item() > 0
    assert torch.equal(grads[0], grads[1])


def _plasma_torus(emissivity, num_iter, **general):
    """A cubic argon plasma and example 03's toroidal crystal."""
    g = {"number_of_iter": num_iter, "random_seed": 0, "keep_history": False,
         "print_results": False}
    g.update(general)
    return {
        "general": g,
        "sources": {"plasma": {
            "class_name": "XicsrtPlasmaCubic", "origin": [0.0, 0.0, 0.0],
            "xsize": 0.02, "ysize": 0.02, "zsize": 0.02,
            "target": [0.0, 0.0, 0.80374151], "spread": np.radians(10.0),
            "emissivity": emissivity, "temperature": 1000.0, "mass_number": 40.0,
            "wavelength": 3.9492, "time_resolution": 1e-3, "bundle_volume": 1e-6,
            "bundle_count": 1000, "use_poisson": True, "linewidth": 1e14}},
        "optics": {
            "crystal": {
                "class_name": "XicsrtOpticToroidalCrystal",
                "origin": [0.0, 0.0, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151], "xsize": 0.2, "ysize": 0.2,
                "radius_major": 1.0, "radius_minor": 0.64, "crystal_spacing": 2.45676,
                "rocking_type": "gaussian", "rocking_fwhm": 1e-3},
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084], "xsize": 0.4, "ysize": 0.2},
        },
    }


def test_bundle_gather_kernel_matches_twin(cuda_device):
    """K4 equals its twin bit for bit, empty bundles and tail rays included."""
    from xicsrt_tpu_torch.ops import bundle_gather as bg

    rng = np.random.default_rng(3)
    counts = rng.integers(0, 40, 5000)
    counts[rng.random(5000) < 0.3] = 0
    cum = torch.from_numpy(np.cumsum(counts).astype(np.int32)).to(cuda_device)
    table = torch.from_numpy(rng.standard_normal((5000, 8)).astype(np.float32)).to(cuda_device)
    n = int(cum[-1]) + 777
    before = bg.interval_gather_cuda.launches
    out = bg.interval_gather_cuda(cum, table, n)
    assert bg.interval_gather_cuda.launches == before + 1
    assert torch.equal(out, bg.interval_gather_plain(cum, table, n))
    assert torch.equal(bg.interval_gather_cuda(cum, table[:, :3], n), out[:, :3])


def test_bundle_gather_kernel_gradient_matches_twin(cuda_device):
    """Autograd through K4 (the kernel forward, a scatter-add backward)
    gives the table the twin's gradient: each bundle row sums the row
    gradients of its rays; rays past cum[-1] add nothing."""
    from xicsrt_tpu_torch.ops import bundle_gather as bg

    rng = np.random.default_rng(8)
    counts = rng.integers(0, 9, 300)
    counts[rng.random(300) < 0.2] = 0
    cum = torch.from_numpy(np.cumsum(counts).astype(np.int32)).to(cuda_device)
    table = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32)).to(cuda_device)
    n = int(cum[-1]) + 40
    weights = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)).to(cuda_device)
    grads = []
    for gather in (bg.interval_gather_cuda, bg.interval_gather_plain):
        t = table.clone().requires_grad_(True)
        (gather(cum, t, n) * weights).sum().backward()
        grads.append(t.grad)
    # Row sums of a few float32 products, added in another order.
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("rng", ["input", "hw"])
def test_fused_plasma_torus_kernel_matches_twin(cuda_device, rng):
    """K1 with a plasma source and a toroidal crystal: the same counts and
    images as its twin, ray for ray."""
    from xicsrt_tpu_torch.draws import Draws

    pipe = Pipeline(_plasma_torus(2e15, 2, engine="fused"), device=cuda_device)
    src = ft._source_spec(pipe.source)
    optics = [ft._optic_spec(o) for o in pipe.optics]
    fparams = ft.pack_params(src, optics, pipe.params, cuda_device)
    bundles = ft.plasma_bundles(pipe.source, pipe.params["sources"]["plasma"],
                                pipe.params["filters"],
                                Draws(torch.Generator(device=cuda_device).manual_seed(4)), 2)
    n = 2 * pipe.num_rays
    kwargs = {"seed": (5, 6)}
    if rng == "input":
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        kwargs = {"uniforms": torch.rand((fparams.n_draws, n), generator=gen,
                                         device=cuda_device)}
    kernel = ft.fused_run_cuda(fparams, n, n, bundles=bundles, **kwargs)
    twin = ft.fused_run_plain(fparams, n, n, bundles=bundles, **kwargs)
    assert int(kernel[0][-1]) > 0
    assert torch.equal(kernel[0], twin[0]) and torch.equal(kernel[1], twin[1])


@pytest.mark.parametrize("rate", [152.0, 4000.0, 16777.0])
def test_poisson_counts_are_unbiased_on_cuda(cuda_device, rate):
    """Bundle counts on the card, at rates where cuRAND alone is biased or
    has no skew: mean within 5 standard errors of the rate over 2^22 draws,
    variance within 5 sqrt(2/R) of it, relative, third central moment within
    5 standard errors, sqrt((6 rate^3 + 18 rate^2 + rate) / R), of the
    rate."""
    from xicsrt_tpu_torch.draws import Draws

    R = 1 << 22
    lam = torch.full((R,), rate, device=cuda_device)
    counts = Draws(torch.Generator(device=cuda_device).manual_seed(9)).poisson_counts(lam)
    counts = counts.double()
    assert abs(counts.mean().item() - rate) < 5 * np.sqrt(rate / R)
    assert abs(counts.var().item() / rate - 1.0) < 5 * np.sqrt(2.0 / R)
    m3 = ((counts - counts.mean()) ** 3).mean().item()
    assert abs(m3 - rate) < 5 * np.sqrt((6 * rate**3 + 18 * rate**2 + rate) / R)


def test_plasma_engines_launch_their_kernels(cuda_device):
    """The eager engine gathers bundle rows with K4; the fused engine traces
    the plasma with K1; both count the real-units photons."""
    from xicsrt_tpu_torch.engine import raytrace
    from xicsrt_tpu_torch.ops import bundle_gather as bg

    expected = 2 * 2e15 * 1e-3 * 0.02**3 * np.sin(np.radians(5.0)) ** 2
    for engine, counter in (("xla", bg.interval_gather_cuda), ("fused", ft.fused_run_cuda)):
        before = counter.launches
        res = raytrace(_plasma_torus(2e15, 2, engine=engine), device=cuda_device)
        assert counter.launches > before
        n = res["total"]["meta"]["plasma"]["num_out"]
        assert abs(n - expected) < 5 * np.sqrt(expected)
        assert res["total"]["image"]["detector"].sum() == res["total"]["meta"]["detector"]["num_out"]


def _new_stage_config(stage):
    """``chip_smoke.py``'s chains of the mirror, file and mesh stages at
    2^16 rays (the script imports no JAX)."""
    import chip_smoke

    n = 1 << 16
    if stage in ("plane_fold", "torus_no_check", "flagship_no_check"):
        return chip_smoke.mirror_configs(n, 1, "fused")[stage]
    if stage == "file":
        return chip_smoke.file_crystal_config(n, 1, "fused")
    if stage.startswith("cheb"):
        return chip_smoke.cheb_degree_config(int(stage[4:]), n)
    cls, kw = chip_smoke.MESH_CRYSTALS[stage]
    return chip_smoke.mesh_config(n, 1, "fused", cls, **kw)


@pytest.mark.parametrize("stage", ["plane_fold", "torus_no_check", "flagship_no_check",
                                   "file", "mesh_sphere", "mesh_cylinder", "mesh_torus",
                                   "cheb4", "cheb6", "cheb8", "cheb10", "cheb12"])
def test_mirror_file_and_mesh_stages_match_twins(cuda_device, stage):
    """K1c-mirror, K1c-file and K1c-cheb: K1 on the chain's own rays and K3
    on one eager iteration's, each equal to its twin in both RNG modes; the
    Chebyshev surfaces at each degree of the fit (4-12)."""
    import chip_smoke
    from xicsrt_tpu_torch import engine

    before = (ft.fused_run_cuda.launches, ft.fused_trace_run_cuda.launches)
    chip_smoke.k1_k3_against_twins(ft, engine, _new_stage_config(stage), stage, 61)
    assert ft.fused_run_cuda.launches == before[0] + 2
    assert ft.fused_trace_run_cuda.launches == before[1] + 2


def test_fused_grad_file_rocking_matches_twins(cuda_device):
    """K5c-file: K5f and K5b on ``file_rocking`` against the float32 twins
    with test_fused_grad_kernels_match_twins's bounds, under Philox."""
    import chip_smoke
    from xicsrt_tpu_torch.ops import fused_grad as fg

    pipe = Pipeline(chip_smoke.grad_variant("file_rocking", 1 << 17), device=cuda_device)
    _, _, pack, spec = fg.build_fused_diff(pipe)
    static, lam, n = spec["static"], spec["lam"], spec["n_total"]
    assert static.aux.numel() > 1
    pvec = pack(pipe.params).detach()
    image = fg.fused_grad_forward_cuda(static, pvec, n, lam, seed=(8, 9))
    twin = fg.fused_grad_forward_plain(static, pvec, n, lam, seed=(8, 9))
    assert twin.sum().item() > 0
    assert abs(image.sum().item() - twin.sum().item()) <= 1e-4 * twin.sum().item()
    assert (image - twin).abs().max().item() <= 1e-3 * twin.abs().max().item()
    g = torch.randn(static.img_total, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(2))
    grad = fg.fused_grad_vjp_cuda(static, pvec, n, lam, g, seed=(8, 9))
    grad_twin = fg.fused_grad_vjp_plain(static, pvec, n, lam, g, seed=(8, 9))
    scale = grad_twin.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(grad, grad_twin, rtol=1e-3, atol=1e-5 * scale)


@pytest.mark.parametrize("stage", ["flagship weight", "flagship bilinear", "flagship both",
                                   "mosaic15 mc", "mosaic15 weight", "mesh mosaic mc",
                                   "mesh mosaic weight"])
def test_k1d_and_mosaic_stages_match_twins(cuda_device, stage):
    """K1d (weight mode, bilinear images) and K1c-mosaic (mc, weight; on a
    mesh, the Chebyshev builds' serial loop): K1 on the chain's own rays
    and K3 on one eager iteration's (in weight mode with the rays' weights:
    K3-weight), each against its twin in both RNG modes at 2^16 rays:
    counts equal, images within the bound of float32 summation order
    (``chip_smoke.twin_equal``)."""
    import chip_smoke
    from xicsrt_tpu_torch import engine

    cfg = chip_smoke.k1d_mosaic_chains(1 << 16)[stage]
    before = (ft.fused_run_cuda.launches, ft.fused_trace_run_cuda.launches)
    chip_smoke.k1_k3_against_twins(ft, engine, cfg, stage, 71)
    assert ft.fused_run_cuda.launches == before[0] + 2
    assert ft.fused_trace_run_cuda.launches == before[1] + 2


def test_fused_grad_mosaic_matches_twins(cuda_device):
    """K5d: K5f and K5b on ``mosaic_sphere`` against the float32 twins with
    test_fused_grad_kernels_match_twins's bounds, and K5b against the
    float64 twin at rtol 2e-2 / atol 5e-3 of the largest slot, under
    Philox."""
    import chip_smoke
    from xicsrt_tpu_torch.ops import fused_grad as fg

    pipe = Pipeline(chip_smoke.grad_variant("mosaic_sphere", 1 << 17), device=cuda_device)
    _, _, pack, spec = fg.build_fused_diff(pipe)
    static, lam, n = spec["static"], spec["lam"], spec["n_total"]
    assert static.n_draws == 2 + 3 * 6
    pvec = pack(pipe.params).detach()
    before = (fg.fused_grad_forward_cuda.launches, fg.fused_grad_vjp_cuda.launches)
    image = fg.fused_grad_forward_cuda(static, pvec, n, lam, seed=(8, 9))
    twin = fg.fused_grad_forward_plain(static, pvec, n, lam, seed=(8, 9))
    assert twin.sum().item() > 0
    assert abs(image.sum().item() - twin.sum().item()) <= 1e-4 * twin.sum().item()
    assert (image - twin).abs().max().item() <= 1e-3 * twin.abs().max().item()
    g = torch.randn(static.img_total, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(2))
    grad = fg.fused_grad_vjp_cuda(static, pvec, n, lam, g, seed=(8, 9))
    grad_twin = fg.fused_grad_vjp_plain(static, pvec, n, lam, g, seed=(8, 9))
    scale = grad_twin.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(grad, grad_twin, rtol=1e-3, atol=1e-5 * scale)
    truth = fg.fused_grad_vjp_plain(static, pvec.double(), n, lam, g.double(), seed=(8, 9))
    torch.testing.assert_close(grad.double(), truth, rtol=2e-2,
                               atol=5e-3 * truth.abs().max().item())
    after = (fg.fused_grad_forward_cuda.launches, fg.fused_grad_vjp_cuda.launches)
    assert after == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("rng", ["input", "hw"])
def test_fused_grad_three_optics_matches_twin(cuda_device, rng):
    """K5b's per-thread slot sums on three optics (``chip_smoke.
    fold_chain_config``: a planar mirror, the spherical crystal, the
    detector) at 2^20 rays, so each thread carries a dozen or more rays
    through the grid-stride loop: against the float32 twin at rtol 1e-3 /
    atol 1e-5 of the largest slot, every optic's slots non-zero, in both
    RNG modes."""
    import chip_smoke
    from xicsrt_tpu_torch.ops import fused_grad as fg

    n = 1 << 20
    pipe = Pipeline(chip_smoke.fold_chain_config(n), device=cuda_device)
    _, _, pack, spec = fg.build_fused_diff(pipe)
    static, lam = spec["static"], spec["lam"]
    assert static.n_optics == 3
    pvec = pack(pipe.params).detach()
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    g = torch.randn(static.img_total, device=cuda_device, generator=gen)
    if rng == "input":
        kwargs = {"uniforms": torch.rand((static.n_draws, n), device=cuda_device,
                                         generator=gen)}
    else:
        kwargs = {"seed": (10, 11)}
    before = fg.fused_grad_vjp_cuda.launches
    grad = fg.fused_grad_vjp_cuda(static, pvec, n, lam, g, **kwargs)
    assert fg.fused_grad_vjp_cuda.launches == before + 1
    twin = fg.fused_grad_vjp_plain(static, pvec, n, lam, g, chunk=1 << 18, **kwargs)
    scale = twin.abs().max().item()
    per_optic = twin[:3 * fg.SLOTS_PER_OPTIC].reshape(3, fg.SLOTS_PER_OPTIC)
    assert bool((per_optic.abs().amax(dim=1) > 0).all())
    torch.testing.assert_close(grad, twin, rtol=1e-3, atol=1e-5 * scale)


@pytest.mark.parametrize("case", ["found", "sampled", "found weight", "found sparse"])
def test_k1e_matches_twin(cuda_device, case):
    """K1e: K1's marked build, the chunk selection and the record launch
    against the twin at 2^16 rays, chunk 4096 (16 chunks, 4 slots), in
    both RNG modes: counts and images as ``chip_smoke.twin_equal`` holds
    them, the same kept chunks and every recorded value equal."""
    import chip_smoke

    mode = case.split()[0]
    n = 1 << 16
    cfg = _spectrometer_config(intensity=n, engine="fused",
                               interact_mode="weight" if "weight" in case else "mc")
    if "sparse" in case:
        cfg["optics"]["detector"]["xsize"] = chip_smoke.SPARSE_DETECTOR_XSIZE
    fparams = chip_smoke.k1_pack(Pipeline(cfg, device=cuda_device))
    spec = ft.HistorySpec(mode, 4, 4096)
    uniforms = torch.rand((fparams.n_draws, n), device=cuda_device,
                          generator=torch.Generator(device=cuda_device).manual_seed(3))
    before = (ft.fused_run_cuda.launches, ft.history_record_cuda.launches)
    for kw in ({"seed": (5, 6)}, {"uniforms": uniforms}):
        chip_smoke.k1e_against_twin(ft, fparams, n, spec, case, **kw)
    assert (ft.fused_run_cuda.launches, ft.history_record_cuda.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("case", ["flagship mc", "flagship weight", "mosaic15",
                                  "plasma_torus", "sparse"])
def test_k1e_probe_matches_marked_build_and_twin(cuda_device, case):
    """K1e's probe (``chip_smoke.probe_against_marked``) at 2^20 rays (the
    plasma's 2^18 photons, chunks of 4096), 8 slots of 8192 rays, in both
    RNG modes: its marks, count and flag equal its twin's, and the 'found'
    call that probes (two K1 launches) equal to the one whose K1 marks
    every chunk and to the twin: counts, images and reservoir. The
    flagship's and ``mosaic15``'s first 8 chunks all keep a ray, so the
    probe finds them and K1 makes no mark; the narrowed detector's do not,
    and K1 marks the run (the fallback)."""
    import chip_smoke
    from xicsrt_tpu_torch import engine

    n, bundles = 1 << 20, None
    if case == "plasma_torus":
        pipe, fparams, bundles, n = chip_smoke.plasma_k1_setup(ft, engine, 1 << 18, 1)
    else:
        if case == "mosaic15":
            cfg = chip_smoke.mosaic15_config(n, 1, "fused")
        else:
            cfg = _spectrometer_config(intensity=n, engine="fused",
                                       interact_mode="weight" if "weight" in case else "mc")
        if case == "sparse":
            cfg["optics"]["detector"]["xsize"] = chip_smoke.SPARSE_DETECTOR_XSIZE
        pipe = Pipeline(cfg, device=cuda_device)
        fparams = chip_smoke.k1_pack(pipe)
    spec = ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, 8, "found")
    uniforms = torch.rand((fparams.n_draws, n), device=cuda_device,
                          generator=torch.Generator(device=cuda_device).manual_seed(17))
    before = ft.history_probe_cuda.launches
    for kw in ({"seed": (17, 4)}, {"uniforms": uniforms}):
        _, fallback, _ = chip_smoke.probe_against_marked(ft, fparams, n, spec, case,
                                                         bundles=bundles, **kw)
        if case != "plasma_torus":
            assert fallback == (case == "sparse")
    windows = len(ft.probe_windows(spec, n))
    assert ft.history_probe_cuda.launches == before + 2 * 2 * windows


@pytest.mark.parametrize("probe_from", [0, 1 << 62], ids=["probed", "marked"])
def test_found_raytrace_equals_the_run_without_history(cuda_device, probe_from, monkeypatch):
    """A 'found' ``raytrace`` of 2^20 rays x 2 on the card: meta and images
    equal to the run's without history on the same seed, whether it
    probes (two K1 launches, the probe's flag picking one) or K1 marks
    every chunk (one); the split's arrays in pageable memory, not in a
    pinned buffer."""
    import chip_smoke
    from xicsrt_tpu_torch import raytrace

    monkeypatch.setattr(ft, "PROBE_MIN_RAYS", probe_from)
    res = {}
    for kh in (False, "found"):
        before = ft.fused_run_cuda.launches
        res[kh] = raytrace(_spectrometer_config(intensity=1 << 20, num_iter=2, engine="fused",
                                                keep_history=kh), device=cuda_device)
        assert ft.fused_run_cuda.launches - before == (2 if kh and probe_from == 0 else 1)
    chip_smoke.totals_equal(res["found"], res[False], f"PROBE_MIN_RAYS {probe_from}")
    for section in ("found", "lost"):
        for arrays in res["found"][section]["history"].values():
            for a in arrays.values():
                assert not torch.from_numpy(a).is_pinned()
    assert res["found"]["found"]["history"]["detector"]["mask"].shape[0] > 0


@pytest.mark.parametrize("mode", ["mc", "weight"])
@pytest.mark.parametrize("cutoff", [False, True], ids=["no_cutoff", "cutoff"])
@pytest.mark.parametrize("depth", [1, 4, 15, 33])
def test_mosaic_layers_spread_over_the_warp_match_twins(cuda_device, depth, cutoff, mode):
    """K1c-mosaic's warp-wide layers (``xrt_mosaic``): K1 on the chain's own
    rays and K3 on one eager iteration's with every odd ray dead, each
    against its twin in both RNG modes at 2^16 rays, at depths 1, 4, 15
    and 33 (over a warp, and not a multiple of the group), with and without
    a cutoff, behind an aperture that kills about half the rays
    (``chip_smoke.mosaic_case_config``): counts exact, nearest images exact,
    weighted pixels within the summation-order bound
    (``chip_smoke.twin_equal``)."""
    import chip_smoke
    from xicsrt_tpu_torch import engine

    cfg = chip_smoke.mosaic_case_config(depth, cutoff, mode, 1 << 16)
    before = (ft.fused_run_cuda.launches, ft.fused_trace_run_cuda.launches)
    chip_smoke.k1_k3_against_twins(ft, engine, cfg, f"mosaic depth {depth} {mode}", 81,
                                   alternate=True)
    assert ft.fused_run_cuda.launches == before[0] + 2
    assert ft.fused_trace_run_cuda.launches == before[1] + 2


@pytest.mark.parametrize("mode", ["mc", "weight"])
def test_k1e_found_on_mosaic15_matches_twin(cuda_device, mode):
    """K1e's 'found' reservoir on ``mosaic15`` (the record launch traces the
    kept chunks' layers again, spread over the warp as K1 does) against
    the twin at 2^16 rays, chunk 4096, 4 slots, in both RNG modes: the same
    kept chunks and every recorded value equal."""
    import chip_smoke

    n = 1 << 16
    fparams = chip_smoke.k1_pack(Pipeline(chip_smoke.mosaic15_config(
        n, 1, "fused", interact_mode=mode), device=cuda_device))
    uniforms = torch.rand((fparams.n_draws, n), device=cuda_device,
                          generator=torch.Generator(device=cuda_device).manual_seed(4))
    before = ft.history_record_cuda.launches
    for kw in ({"seed": (7, 8)}, {"uniforms": uniforms}):
        chip_smoke.k1e_against_twin(ft, fparams, n, ft.HistorySpec("found", 4, 4096),
                                    f"K1e found mosaic15 {mode}", **kw)
    assert ft.history_record_cuda.launches == before + 2


def _k1d_flagship(mode, n, device, sparse=False):
    """The flagship in K1d's run mode ``mode`` (``chip_smoke.WEIGHT_MODES``:
    weight, bilinear or both) at ``n`` rays, packed for K1; ``sparse``: its
    detector narrowed until about a third of the 8192-ray chunks keep a ray
    in mc mode. The library picks K1's flat build of the weight and
    bilinear stages for it (``chip_smoke.k1_build_name``)."""
    import chip_smoke

    cfg = chip_smoke.flagship(n, 1, engine="fused", **chip_smoke.WEIGHT_MODES[mode])
    if sparse:
        cfg["optics"]["detector"]["xsize"] = chip_smoke.SPARSE_DETECTOR_XSIZE
    fparams = chip_smoke.k1_pack(Pipeline(cfg, device=device))
    assert fparams.stages == 1 and not fparams.plasma
    assert chip_smoke.k1_build_name(fparams) == "fused_trace_flat_kernel<1>"
    return fparams


@pytest.mark.parametrize("rng", ["input", "hw"])
@pytest.mark.parametrize("mode", ["weight", "bilinear", "both"])
def test_k1d_flat_build_matches_twin(cuda_device, mode, rng):
    """K1d in the flagship's flat build (float64 images in global memory,
    terms of zero not issued, the warp vote in mc runs) against its twin at
    2^20 rays: counts equal, every pixel within the bound of float32
    summation order (``chip_smoke.twin_equal``)."""
    import chip_smoke

    n = 1 << 20
    fparams = _k1d_flagship(mode, n, cuda_device)
    kw = {"seed": (15, 1)} if rng == "hw" else {"uniforms": torch.rand(
        (fparams.n_draws, n), device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(15))}
    before = ft.fused_run_cuda.launches
    chip_smoke.twin_equal(ft.fused_run_cuda(fparams, n, n, **kw),
                          ft.fused_run_plain(fparams, n, n, **kw, terms=True),
                          f"K1d {mode} rng={rng}", fparams)
    assert ft.fused_run_cuda.launches == before + 1


@pytest.mark.parametrize("mode", ["bilinear", "both"])
def test_k1d_bilinear_image_sums_in_float64(cuda_device, mode):
    """At 2^24 flagship rays the kernel's bilinear images (float64 sums,
    rounded once to float32) sum within 1e-6 of the exact sum of the
    twin's float32 terms (its tally of their magnitudes in float64; every
    term is at least 0), and its counts equal the twin's."""
    n = 1 << 24
    fparams = _k1d_flagship(mode, n, cuda_device)
    counts, image = ft.fused_run_cuda(fparams, n, n, seed=(15, 2))
    twin_counts, _, (_, magnitudes) = ft.fused_run_plain(fparams, n, n, seed=(15, 2),
                                                         terms=True)
    assert torch.equal(counts, twin_counts)
    exact = magnitudes.sum().item()
    assert exact > 0
    assert abs(image.double().sum().item() - exact) <= 1e-6 * exact


@pytest.mark.parametrize("mode", ["weight", "bilinear", "both"])
def test_k1e_marks_of_the_k1d_flat_build_match_twin(cuda_device, mode):
    """K1e's 'found' reservoir behind K1d's marked flat build on the
    flagship with a narrowed detector at 2^20 rays, chunk 8192, a slot for
    every chunk, so the kept chunks are every marked chunk: the same marks
    as the twin's and every recorded value equal, in both RNG modes; in mc
    mode some chunks keep no ray."""
    import chip_smoke

    n = 1 << 20
    fparams = _k1d_flagship(mode, n, cuda_device, sparse=True)
    spec = ft.HistorySpec("found", n // 8192, 8192)
    uniforms = torch.rand((fparams.n_draws, n), device=cuda_device,
                          generator=torch.Generator(device=cuda_device).manual_seed(16))
    for kw in ({"seed": (15, 3)}, {"uniforms": uniforms}):
        _, hist = chip_smoke.k1e_against_twin(ft, fparams, n, spec, f"K1e found K1d {mode}",
                                              **kw)
        assert int(hist.used) > 0
        if mode == "bilinear":
            assert int(hist.used) < spec.slots


@pytest.mark.parametrize("rng", ["input", "hw"])
@pytest.mark.parametrize("chain", ["plane_fold", "torus_no_check", "convex_cylinder_mirror",
                                   "flagship_no_check"])
def test_k1c_mirror_builds_match_twins(cuda_device, chain, rng):
    """K1c-mirror: phase 27's four mirror chains take their builds
    (``chip_smoke.MIRROR_BUILDS``: a window of the images staged as integer
    counts where no torus is in the chain; the torus's build with every
    shape) and are 0 rays and 0 pixels apart from the twin at 2^20 rays."""
    import chip_smoke

    n = 1 << 20
    fparams = chip_smoke.k1_pack(Pipeline(chip_smoke.mirror_configs(n, 1, "fused")[chain],
                                          device=cuda_device))
    assert fparams.dense_images
    assert chip_smoke.k1_build_name(fparams) == chip_smoke.MIRROR_BUILDS[chain]
    kw = {"seed": (19, 1)} if rng == "hw" else {"uniforms": torch.rand(
        (fparams.n_draws, n), device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(19))}
    before = ft.fused_run_cuda.launches
    chip_smoke.twin_equal(ft.fused_run_cuda(fparams, n, n, **kw),
                          ft.fused_run_plain(fparams, n, n, **kw, terms=True),
                          f"K1c-mirror {chain} rng={rng}", fparams)
    assert ft.fused_run_cuda.launches == before + 1


def _one_pixel_config(n, crystal_pixel):
    """The flagship with its crystal unchecked, no aperture and a 2 degree
    cone, so every ray reaches the crystal and the detector: its crystal's
    image of pixels ``crystal_pixel`` wide (0.2: one pixel, which every lane
    of every warp adds to; 0.001: 200 x 200, too large to stage with the
    detector's), its detector's two (the window)."""
    import chip_smoke

    cfg = chip_smoke.mirror_configs(n, 1, "fused")["flagship_no_check"]
    del cfg["optics"]["aperture"]
    cfg["sources"]["source"]["spread"] = np.radians(2.0)
    cfg["optics"]["crystal"]["pixel_size"] = crystal_pixel
    cfg["optics"]["detector"]["pixel_size"] = 0.2
    return cfg


@pytest.mark.parametrize("rng", ["input", "hw"])
@pytest.mark.parametrize("image", ["staged", "window"])
def test_dense_images_of_whole_warps_on_one_pixel(cuda_device, image, rng):
    """The dense build's staged integer counts where whole warps land on one
    pixel (``_one_pixel_config``): every pixel staged (3) or the window
    alone, the detector's 2 of 40002 (the crystal's in global memory):
    every ray alive at every element, counts and images 0 rays apart from
    the twin at 2^20 rays; staged, the crystal's one pixel holds every
    ray."""
    import ctypes

    import chip_smoke
    from xicsrt_tpu_torch.ops import native

    n = 1 << 20
    cfg = _one_pixel_config(n, 0.2 if image == "staged" else 0.001)
    fparams = chip_smoke.k1_pack(Pipeline(cfg, device=cuda_device))
    assert chip_smoke.k1_build_name(fparams) == "fused_trace_dense_kernel"
    assert fparams.stage_window == (fparams.img_total - 2, fparams.img_total)
    dyn = ctypes.c_int(-1)
    n_fp, n_ip = fparams.fp.numel(), fparams.ip.numel()
    assert native.library().xrt_fused_trace_occupancy(
        0, 0, 0, fparams.shapes, 1, *fparams.stage_window, fparams.img_total, n_fp, n_ip,
        ctypes.byref(dyn)) > 0
    assert dyn.value == (ft.head_bytes(n_fp, n_ip)
                         + 4 * (fparams.img_total if image == "staged" else 2))
    kw = {"seed": (23, 2)} if rng == "hw" else {"uniforms": torch.rand(
        (fparams.n_draws, n), device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(23))}
    counts, images = ft.fused_run_cuda(fparams, n, n, **kw)
    chip_smoke.twin_equal((counts, images), ft.fused_run_plain(fparams, n, n, **kw, terms=True),
                          f"dense images, {image}, rng={rng}", fparams)
    assert counts.tolist() == [n] * (1 + fparams.n_optics)
    if image == "staged":
        assert int(images[0]) == n


@pytest.mark.parametrize("rng", ["input", "hw"])
@pytest.mark.parametrize("mode", ["mc", "weight", "bilinear"])
def test_k1c_cylinder_build_matches_twin(cuda_device, mode, rng):
    """K1c-cylinder in its build without the torus code
    (``fused_trace_cylinder_kernel``; its stage-1 build stages the weighted
    and bilinear images in shared memory) against its twin at 2^20 rays:
    0 rays and 0 pixels apart in mc mode, the counts equal and each pixel
    within the bound of float32 summation order in weight mode and with
    bilinear images (``chip_smoke.twin_equal``)."""
    import chip_smoke

    n = 1 << 20
    fparams = chip_smoke.k1_pack(Pipeline(chip_smoke.cylinder_mode_config(mode, n),
                                          device=cuda_device))
    assert chip_smoke.k1_build_name(fparams) == chip_smoke.CYLINDER_MODES[mode][1]
    kw = {"seed": (29, 3)} if rng == "hw" else {"uniforms": torch.rand(
        (fparams.n_draws, n), device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(29))}
    before = ft.fused_run_cuda.launches
    chip_smoke.twin_equal(ft.fused_run_cuda(fparams, n, n, **kw),
                          ft.fused_run_plain(fparams, n, n, **kw, terms=True),
                          f"K1c-cylinder {mode} rng={rng}", fparams)
    assert ft.fused_run_cuda.launches == before + 1


@pytest.mark.parametrize("chain", ["cylinder", "flagship_no_check"])
def test_k1e_found_on_the_new_builds_matches_twin(cuda_device, chain):
    """K1e 'found' through the marked builds of the cylinder
    (``fused_trace_cylinder_kernel<0, true>``) and of dense images
    (``fused_trace_dense_kernel<true>``) against the twin at 2^18 rays,
    chunk 4096, both RNG modes: counts, images, kept chunks and every
    recorded value equal (``chip_smoke.k1e_against_twin``)."""
    import chip_smoke

    n = 1 << 18
    cfg = (chip_smoke.cylinder_config(n, 1, "fused") if chain == "cylinder"
           else chip_smoke.mirror_configs(n, 1, "fused")[chain])
    fparams = chip_smoke.k1_pack(Pipeline(cfg, device=cuda_device))
    spec = ft.HistorySpec("found", 4, 4096)
    uniforms = torch.rand((fparams.n_draws, n), device=cuda_device,
                          generator=torch.Generator(device=cuda_device).manual_seed(31))
    before = (ft.fused_run_cuda.launches, ft.history_record_cuda.launches)
    for kw in ({"seed": (31, 4)}, {"uniforms": uniforms}):
        _, hist = chip_smoke.k1e_against_twin(ft, fparams, n, spec, f"K1e found {chain}", **kw)
        assert int(hist.used) == 4
    assert (ft.fused_run_cuda.launches, ft.history_record_cuda.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("n", [1, 31, 33, 4096 + 17, 1 << 16])
@pytest.mark.parametrize("mode", ["mc", "weight"])
def test_k3_on_ragged_counts_matches_twin(cuda_device, n, mode):
    """K3 on the first n rays of the flagship's eager iteration (n = 1, 31,
    33, a count that leaves a grid-stride step and a warp ragged, 2^16),
    in mc and in weight mode with the rays' weights, against its twin in
    both RNG modes: counts exact, images as ``chip_smoke.twin_equal``
    holds them (equal where no ray reaches the detector)."""
    import chip_smoke

    pipe = Pipeline(_spectrometer_config(intensity=1 << 16, engine="fused",
                                         interact_mode=mode), device=cuda_device)
    k3p = chip_smoke.k3_pack(ft, pipe)
    rays = chip_smoke.eager_rays(pipe, 12)
    args = (k3p, rays.origin[:n].contiguous(), rays.direction[:n].contiguous(),
            rays.wavelength[:n].contiguous(), rays.mask[:n].contiguous())
    weight = {"weight": rays.weight[:n].contiguous()} if k3p.weight else {}
    uniforms = torch.rand((k3p.n_draws, n), device=cuda_device,
                          generator=torch.Generator(device=cuda_device).manual_seed(n))
    for kw in ({"seed": (12, n)}, {"uniforms": uniforms}):
        kernel = ft.fused_trace_run_cuda(*args, **kw, **weight)
        plain = ft.fused_trace_run_plain(*args, **kw, **weight, terms=True)
        assert int(kernel[0][0]) == int(rays.mask[:n].sum())
        if int(plain[0][-1]) > 0:
            chip_smoke.twin_equal(kernel, plain, f"K3 {mode} on {n} rays", k3p)
        else:  # no ray reaches the detector: counts and images equal all the same
            assert torch.equal(kernel[0], plain[0])
            assert torch.equal(kernel[1], plain[1])


def test_cli_runs_on_the_card(cuda_device):
    """``python -m xicsrt_tpu_torch`` in a process of its own at 2^16 rays:
    exit 0, its saved meta equal to an in-process run's, the found history
    saved (``chip_smoke.phase_cli``)."""
    import chip_smoke
    import xicsrt_tpu_torch

    chip_smoke.phase_cli(xicsrt_tpu_torch.raytrace, 1 << 16)


@pytest.mark.parametrize("body", ["trans", "sqrtdiv", "simple"])
def test_elem_rate_kernel_matches_plain(cuda_device, body):
    """R1 against its plain chains summed in float64 at 4 grid steps of
    K = 1 .. 4, held to ``chip_smoke.r1_bound`` element by element, each K
    at least 10 bounds from the last (``chip_smoke.r1_step_check``): a
    kernel short of a step fails."""
    import chip_smoke
    from xicsrt_tpu_torch.ops import roofline_probes as rp

    seed = torch.tensor([0.6], dtype=torch.float32, device=cuda_device)
    before = (rp.elem_rate_cuda.launches, rp.elem_rate_cuda.body_launches[body])
    chip_smoke.r1_step_check(rp, seed, body, n_chunks=4, steps=4)
    assert (rp.elem_rate_cuda.launches, rp.elem_rate_cuda.body_launches[body]) == (
        before[0] + 4, before[1] + 4)


def test_mma_rate_kernel_matches_plain(cuda_device):
    """R2 against its plain version at 8 grid steps of 4 products over
    sub 256, held to ``chip_smoke.r2_bound``; column 0 (B's zero row) is 0."""
    import chip_smoke
    from xicsrt_tpu_torch.ops import native
    from xicsrt_tpu_torch.ops import roofline_probes as rp

    seed = torch.tensor([0.011], dtype=torch.float32, device=cuda_device)
    before = rp.mma_rate_cuda.launches
    kernel = rp.mma_rate_cuda(seed, n_mm=8, K_mm=4, sub=256)
    plain = rp.mma_rate_plain(seed, n_mm=8, K_mm=4, sub=256)
    blocks = native.library().xrt_mma_rate_blocks(8)
    chip_smoke.held_to(kernel, plain, chip_smoke.r2_bound(8, 4, 256, blocks), "R2")
    assert bool((kernel[:, 0] == 0).all()) and float(kernel.max()) > 0
    assert rp.mma_rate_cuda.launches == before + 1


@pytest.mark.parametrize("K_mm", [1, 2])
def test_mma_rate_kernel_on_uneven_steps(cuda_device, K_mm):
    """R2 at the tool's sub with 7 grid steps more than the blocks it
    launches, so some blocks take two steps and the rest one, against its
    plain version within ``chip_smoke.r2_bound`` of the blocks launched."""
    import chip_smoke
    from xicsrt_tpu_torch.ops import native
    from xicsrt_tpu_torch.ops import roofline_probes as rp

    lib = native.library()
    n_mm = lib.xrt_mma_rate_blocks(1 << 20) + 7
    blocks = lib.xrt_mma_rate_blocks(n_mm)
    assert n_mm % blocks != 0
    seed = torch.tensor([0.013], dtype=torch.float32, device=cuda_device)
    before = rp.mma_rate_cuda.launches
    kernel = rp.mma_rate_cuda(seed, n_mm=n_mm, K_mm=K_mm)
    plain = rp.mma_rate_plain(seed, n_mm=n_mm, K_mm=K_mm)
    chip_smoke.held_to(kernel, plain, chip_smoke.r2_bound(n_mm, K_mm, rp.SUB, blocks), "R2")
    assert bool((kernel[:, 0] == 0).all()) and float(kernel.max()) > 0
    assert rp.mma_rate_cuda.launches == before + 1


@pytest.mark.parametrize("rng", ["input", "hw"])
def test_k1_plasma_on_1e5_ragged_bundles_matches_twin(cuda_device, rng):
    """K1 plasma+torus at 1e5 bundles, with runs of zero-photon bundles and
    32 m + 17 slots an iteration (``chip_smoke.ragged_bundles``: a warp's
    live lanes span two iterations, the tails are dead), as the warp's
    bundle search finds them: counts and images equal to the twin's."""
    import chip_smoke
    from xicsrt_tpu_torch import engine

    _, fparams, bundles, _ = chip_smoke.plasma_k1_setup(ft, engine, 1 << 18, 2, 100000,
                                                        seed=21)
    bundles, n = chip_smoke.ragged_bundles(bundles, 22)
    assert (n // 2) % 32 == 17
    kwargs = {"seed": (23, 24)}
    if rng == "input":
        gen = torch.Generator(device=cuda_device).manual_seed(25)
        kwargs = {"uniforms": torch.rand((fparams.n_draws, n), generator=gen,
                                         device=cuda_device)}
    before = ft.fused_run_cuda.launches
    kernel = ft.fused_run_cuda(fparams, n, n, bundles=bundles, **kwargs)
    twin = ft.fused_run_plain(fparams, n, n, bundles=bundles, **kwargs)
    assert ft.fused_run_cuda.launches == before + 1
    assert int(kernel[0][-1]) > 0
    assert torch.equal(kernel[0], twin[0]) and torch.equal(kernel[1], twin[1])


K1_BUILD_CASES = [f"{kind} {stage}" for kind in ("plasma", "generic")
                  for stage in ("weight", "bilinear", "both", "mosaic mc", "mosaic weight",
                                "mesh", "found")]


@pytest.mark.parametrize("case", K1_BUILD_CASES)
def test_k1_source_builds_match_twins(cuda_device, case):
    """Each K1 build of the plasma and of the generic sampler past their own
    (``chip_smoke.k1_source_build_chains``: weight mode, bilinear images,
    both, a mosaic crystal in mc and weight mode, a mesh crystal; and
    K1e's marked build and record kernel, 'found' in 4 slots of 4096
    rays), against the twin in both RNG modes at 2^16 rays."""
    import chip_smoke
    from xicsrt_tpu_torch import engine

    n = 1 << 16
    kind, stage = case.split(" ", 1)
    history = None
    if stage == "found":
        history = ft.HistorySpec("found", 4, 4096)
        cfg = (chip_smoke.plasma_config(n, 1, engine="fused") if kind == "plasma"
               else chip_smoke.source_matrix_config(n, 1, "fused"))
    else:
        cfg = chip_smoke.k1_source_build_chains(n)[case]
    before = ft.fused_run_cuda.launches
    chip_smoke.k1_build_against_twin(ft, engine, cfg, case, 91, history)
    assert ft.fused_run_cuda.launches == before + 2


def test_bundle_gather_kernel_on_1e5_bundles_matches_twin(cuda_device):
    """K4 at 1e5 bundles (every tenth empty) beside the warp search it now
    shares a header with: equal to its twin, the tail rays zero rows."""
    import chip_smoke
    from xicsrt_tpu_torch.ops import bundle_gather as bg

    gen = torch.Generator(device=cuda_device).manual_seed(26)
    cum, table = chip_smoke.gather_inputs(100000, 1 << 20, gen)
    n = (1 << 20) + 333
    out = bg.interval_gather_cuda(cum, table, n)
    assert torch.equal(out, bg.interval_gather_plain(cum, table, n))
    assert float(out[1 << 20:].abs().max()) == 0.0


def _k4_counts(B, rng, mean=50.0):
    """Photon counts of ``B`` bundles: Poisson of ``mean``, a fifth of them
    zero, and a run of 40 zero-count bundles (longer than a warp's window)
    after the first tenth."""
    counts = rng.poisson(mean, B)
    counts[rng.random(B) < 0.2] = 0
    if B > 80:
        counts[B // 10:B // 10 + 40] = 0
    return counts


@pytest.mark.parametrize("B", [1, 31, 32, 33, 1000, 100000])
@pytest.mark.parametrize("mean", [3.0, 5000.0])
def test_bundle_gather_warp_tiles_match_twin(cuda_device, B, mean):
    """K4's warp tiles against its twin bit for bit: bundles fewer than, as
    many as and more than a warp's window; bundles emptier than a warp
    (mean 3: a warp's rays span many bundles and leave the window) and
    fuller (5000, or 83 at 1e5 bundles); runs of empty bundles; ``n`` not a multiple of 32 with
    rays past ``cum[-1]``, and ``n`` below ``cum[-1]``."""
    from xicsrt_tpu_torch.ops import bundle_gather as bg

    rng = np.random.default_rng(B + int(mean))
    counts = _k4_counts(B, rng, min(mean, (1 << 23) / B))  # at most ~2^23 rays
    counts[-1] = max(counts[-1], 1)
    cum = torch.from_numpy(np.cumsum(counts).astype(np.int32)).to(cuda_device)
    table = torch.from_numpy(rng.standard_normal((B, 8)).astype(np.float32)).to(cuda_device)
    total = int(cum[-1])
    for n in (total + 45, max(total - 13, 1), 1, 31, 33):
        before = bg.interval_gather_cuda.launches
        out = bg.interval_gather_cuda(cum, table, n)
        assert bg.interval_gather_cuda.launches == before + 1
        assert torch.equal(out, bg.interval_gather_plain(cum, table, n)), (B, mean, n)
        if n > total:
            assert float(out[total:].abs().max()) == 0.0


def test_bundle_gather_all_empty_leading_bundles(cuda_device):
    """The first 100 bundles and every other after them empty; the last
    bundle's count ends the rays: rays of a warp in up to 32 bundles, none
    in the window's first entries."""
    from xicsrt_tpu_torch.ops import bundle_gather as bg

    counts = np.zeros(400, np.int64)
    counts[100::2] = 1
    counts[-1] = 3
    cum = torch.from_numpy(np.cumsum(counts).astype(np.int32)).to(cuda_device)
    table = torch.arange(400 * 8, dtype=torch.float32, device=cuda_device).reshape(400, 8)
    n = int(cum[-1]) + 70
    assert torch.equal(bg.interval_gather_cuda(cum, table, n),
                       bg.interval_gather_plain(cum, table, n))


@pytest.fixture
def cuda_devices():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    return torch.cuda.device_count()


def test_sharded_over_cuda_devices_matches_one_device(cuda_devices):
    """One process sharding over every CUDA device (a pipeline on each, the
    eager engine's params moved there) against the same shards on
    ``cuda:0``: the flagship fused and eager (with history) and example 03
    eager (K4) to the bit; the eager and fused gradient paths but for
    float32 summation order."""
    import chip_smoke
    import torch_multihost_worker as worker
    from xicsrt_tpu_torch.engine import _run_generator
    from xicsrt_tpu_torch.parallel import make_sharded_run, ray_mesh

    n = cuda_devices
    meshes = (ray_mesh(n, "cuda"), ray_mesh(n, "cuda:0"))
    assert meshes[0].devices == tuple(torch.device("cuda", i) for i in range(n))
    for cfg in (chip_smoke.flagship(1 << 22, 2, engine="fused"),
                chip_smoke.flagship(1 << 18, 2, engine="xla", keep_history=True),
                chip_smoke.example_config("example_03_plasma_spectrometer.py")):
        outs = []
        for mesh in meshes:
            runner, pipe, _ = make_sharded_run(cfg, mesh=mesh)
            outs.append(runner(pipe.params, _run_generator(pipe.general, 0, pipe.device)))
        for section in ("meta", "image"):
            for name, value in outs[1][section].items():
                assert torch.equal(outs[0][section][name].cpu(), value.cpu()), (section, name)
        for name, rays in outs[1]["history"].items():
            assert torch.equal(outs[0]["history"][name].origin.cpu(), rays.origin.cpu())
    sums = [worker.spacing_gradient(mesh) for mesh in meshes]
    np.testing.assert_allclose(sums[0], sums[1], rtol=1e-10)
    fused = [worker.fused_gradients(mesh) for mesh in meshes]
    np.testing.assert_allclose(fused[0][0], fused[1][0], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(fused[0][1], fused[1][1], rtol=1e-5, atol=1e-4)


def test_nccl_ranks_match_one_process(cuda_devices, tmp_path):
    """One NCCL rank a GPU (``tests/torch_multihost_worker.py``) against one
    process of as many shards on ``cuda:0`` (``check_ranks``)."""
    from torch_multihost_worker import check_ranks, run_ranks

    n = cuda_devices
    config = _spectrometer_config(intensity=1 << 16, num_iter=2, random_seed=7,
                                  keep_history=True, shard_rays=True, devices=n)
    check_ranks(run_ranks(n, config, "cuda", tmp_path), config, "cuda:0")


# ---------------------------------------------------------------------------
# Long optic chains (tools/bench_scenarios.with_baffles): every K1 build, K1e
# and K3 past 16 optics, baffle127 (the kernels' longest chain) and baffle42
# (the gradient kernels').
# ---------------------------------------------------------------------------

LONG_BUILDS = ["flat", "flat weight", "flat bilinear", "dense window", "cylinder",
               "cylinder weight", "torus", "generic", "plasma", "chebyshev", "mosaic"]


@pytest.mark.parametrize("label", LONG_BUILDS)
def test_long_chain_builds_match_twins(cuda_device, label):
    """Each K1 build on its chain behind baffle plates (17 optics), K1e
    'found' and K3 on it, against their twins in both RNG modes:
    0 rays and 0 pixels apart in mc mode, pixels within the float32
    summation-order bound in weight mode and with bilinear images."""
    import chip_smoke
    from xicsrt_tpu_torch import engine

    cfg, build = chip_smoke.long_chain_builds(1 << 18)[label]
    fparams = chip_smoke.k1_pack(engine.Pipeline(cfg, device=cuda_device))
    assert fparams.n_optics == chip_smoke.LONG_CHAIN_OPTICS == 17
    assert chip_smoke.k1_build_name(fparams) == build
    chip_smoke.long_chain_against_twins(ft, engine, cfg, f"long {label}", seed=49)


@pytest.mark.parametrize("mode", ["mc", "weight", "bilinear", "found"])
def test_baffle127_matches_twin(cuda_device, mode):
    """K1 on baffle127 (127 optics, 126 apertures) in mc and weight mode,
    with bilinear images, and with 'found' history (K1e), against its twin
    in both RNG modes; the packed buffers' head as the library counts it."""
    import chip_smoke
    from xicsrt_tpu_torch import engine
    from xicsrt_tpu_torch.ops import native
    from xicsrt_tpu_torch.tools.bench_scenarios import baffle_config

    general = {"weight": {"interact_mode": "weight"},
               "bilinear": {"image_mode": "bilinear"}}.get(mode, {})
    cfg = baffle_config(124, 1 << 20, 1, engine="fused", **general)
    pipe = engine.Pipeline(cfg, device=cuda_device)
    fparams = chip_smoke.k1_pack(pipe)
    assert fparams.n_optics == 127
    n_fp, n_ip = fparams.fp.numel(), fparams.ip.numel()
    assert 4 * native.library().xrt_head_floats_of(n_fp, n_ip) == ft.head_bytes(n_fp, n_ip)
    spec = (ft._history_spec(pipe, ft._source_spec(pipe.source), 8192, 8, "found")
            if mode == "found" else None)
    chip_smoke.k1_build_against_twin(ft, engine, cfg, f"baffle127 {mode}", 127, history=spec)


def _baffle42(n, cuda_device):
    from xicsrt_tpu_torch.ops import fused_grad as fg
    from xicsrt_tpu_torch.tools.bench_scenarios import baffle_config

    cfg = baffle_config(39, n, 1, interact_mode="weight", image_mode="bilinear")
    pipe = Pipeline(cfg, device=cuda_device)
    _, _, pack, spec = fg.build_fused_diff(pipe)
    return pipe, pack(pipe.params).detach(), spec


def test_baffle42_gradients_match_twins(cuda_device):
    """K5f and K5b on baffle42 (42 optics, K5's longest chain: the launcher
    takes K5b's replay build, its saved states in device memory) against
    the float32 twins in both RNG modes, at
    test_fused_grad_variants_match_twins's bounds; the recomputing build,
    whose rows do not fit, asked for explicitly, raises."""
    import chip_smoke
    from xicsrt_tpu_torch.ops import fused_grad as fg

    n = (1 << 16) + 17
    pipe, pvec, spec = _baffle42(n, cuda_device)
    static, lam = spec["static"], spec["lam"]
    assert static.n_optics == 42
    launch = fg.k5b_layout(static, pvec.numel(), n)
    assert (launch["build"], launch["states"]) == ("replay", "device")
    gen = torch.Generator(device=cuda_device).manual_seed(42)
    uniforms = torch.rand((static.n_draws, n), generator=gen, device=cuda_device)
    g = torch.randn(static.img_total, device=cuda_device, generator=gen)
    for kwargs in ({"seed": (8, 9)}, {"uniforms": uniforms}):
        chip_smoke.k5_against_twins(fg, static, pvec, n, lam, g, "baffle42", **kwargs)
    with pytest.raises(RuntimeError):
        fg.fused_grad_vjp_cuda(static, pvec, n, lam, g, seed=(8, 9), _build="recompute")


@pytest.mark.parametrize("kind", ["flagship", "torus_crystal", "plasma_cubic"])
def test_k5b_replay_matches_twin(cuda_device, kind):
    """K5b's replay build (the launcher's for long chains) on short chains
    where the launcher takes the recomputing build, its states in shared
    memory, against the float32 twin at its bounds (rtol 1e-3, atol 1e-5 of
    the largest slot), and the same vjp run to run."""
    from xicsrt_tpu_torch.ops import fused_grad as fg

    n = (1 << 17) + 17
    cfg = (_spectrometer_config(intensity=n, interact_mode="weight", image_mode="bilinear")
           if kind == "flagship" else _grad_variant(kind, n))
    pipe = Pipeline(cfg, device=cuda_device)
    _, _, pack, spec = fg.build_fused_diff(pipe)
    static, lam = spec["static"], spec["lam"]
    pvec = pack(pipe.params).detach()
    g = torch.randn(static.img_total, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(3))
    twin = fg.fused_grad_vjp_plain(static, pvec, n, lam, g, seed=(4, 5))
    scale = twin.abs().max().item()
    assert scale > 0
    assert fg.k5b_layout(static, pvec.numel(), n, "replay")["states"] == "shared"
    grad = fg.fused_grad_vjp_cuda(static, pvec, n, lam, g, seed=(4, 5), _build="replay")
    torch.testing.assert_close(grad, twin, rtol=1e-3, atol=1e-5 * scale)
    again = fg.fused_grad_vjp_cuda(static, pvec, n, lam, g, seed=(4, 5), _build="replay")
    assert torch.equal(grad, again)
