"""The host side of the main path's kernels K1a and K2 on the CPU.

- K2's one launch for every image of an iteration (``pallas_binning.
  bin_images_cuda``): its packing (each image at an offset of one output,
  rays per item, the unit-weight flag) by its plain path, against one
  ``bin_image`` call per item and against the JAX package's Pallas kernel
  in interpret mode; the eager engine's choice of the flag.
- K1's build: what its launcher picks the build from (source, Chebyshev
  stage, stages, ``FusedParams.shapes``, ``FusedParams.dense_images``); a
  point source's chain of planes and spheres, in mc mode and with weights
  or bilinear images, passes it what the build without the torus and
  cylinder code takes, a cylinder chain what the build without the torus
  code takes, a mirror chain dense images.
- What K1 really traces (``tools/roofline.live_lanes``): the rays and
  32-ray warps alive into each optic of the flagship at 2^16 rays, held to
  the twin's counts and to the twin's history record of the same rays.
- The image terms K1 adds (``tools/roofline.image_adds``): on the flagship
  at 2^14 rays, the twin's term tally, and the share of terms of exactly
  zero, which K1 does not issue.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from xicsrt_tpu.ops.pallas_binning import bin_image_pallas
from xicsrt_tpu_torch import engine
from xicsrt_tpu_torch.ops import binning as tbin
from xicsrt_tpu_torch.ops import fused_trace as ft
from xicsrt_tpu_torch.ops.pallas_binning import MAX_ITEMS, bin_images_cuda, pack_items
from xicsrt_tpu_torch.tools import bench_scenarios as BS
from xicsrt_tpu_torch.tools import roofline

# (nx, ny, pixel size) of the flagship's crystal and detector, and a small grid.
SHAPES = [(100, 100, 0.002), (100, 50, 0.004), (40, 20, 0.005)]


def _items(n_rays, seed, weights="ones", dtype=np.float32, shapes=SHAPES):
    """One item a shape: hits over the grid and a margin, 30 % set."""
    rng = np.random.default_rng(seed)
    out = []
    for (nx, ny, ps), n in zip(shapes, n_rays):
        x = np.zeros((n, 3), dtype)
        x[:, 0] = rng.uniform(-0.5, 0.5, n) * (nx + 4) * ps
        x[:, 1] = rng.uniform(-0.5, 0.5, n) * (ny + 4) * ps
        mask = rng.uniform(size=n) < 0.3
        w = np.ones(n, dtype) if weights == "ones" else rng.uniform(size=n).astype(dtype)
        out.append((torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(w),
                    nx, ny, ps))
    return out


@pytest.mark.parametrize("unit", [True, False], ids=["unit_flag", "float_weights"])
@pytest.mark.parametrize("n_rays", [(3000, 3000, 3000), (4096, 17, 0)],
                         ids=["same_rays", "ragged"])
def test_packed_binning_matches_one_bin_image_per_item(unit, n_rays):
    """Unit weights: each packed image equal to the port's bin_image of its
    item and to JAX's Pallas kernel (interpret mode), with and without the
    unit flag; the offsets tile one output."""
    items = _items(n_rays, seed=sum(n_rays))
    before = bin_images_cuda.launches
    got = bin_images_cuda(items, unit_weights=unit)
    assert bin_images_cuda.launches == before  # CPU tensors: the plain path
    packed = pack_items(items)
    assert packed.offsets == [0, 10000, 15000] and packed.total == 15800
    for image, (x, m, w, nx, ny, ps) in zip(got, items):
        assert image.shape == (nx, ny) and image.dtype == torch.float32
        assert torch.equal(image, tbin.bin_image(x, m, w, nx, ny, ps))
        if x.shape[0] == 0:  # JAX's kernel takes no empty ray axis
            assert not image.any()
            continue
        ref = bin_image_pallas(jnp.asarray(x.numpy()), jnp.asarray(m.numpy()),
                               jnp.asarray(w.numpy()), nx, ny, ps, interpret=True)
        np.testing.assert_array_equal(image.numpy(), np.asarray(ref))


def test_packed_binning_weighted_and_float64():
    """Random weights: each packed image equal to bin_image of its item (the
    same index_put_ order); float64 inputs bin in float32 and come back in
    float64, as pallas_binning.py:79 casts them."""
    items = _items((2000, 2500, 1500), seed=7, weights="random")
    for image, item in zip(bin_images_cuda(items), items):
        assert torch.equal(image, tbin.bin_image(*item))
    wide = _items((2000, 2500, 1500), seed=8, dtype=np.float64)
    for image, (x, m, w, nx, ny, ps) in zip(bin_images_cuda(wide, unit_weights=True), wide):
        assert image.dtype == torch.float64
        ref = bin_image_pallas(jnp.asarray(x.numpy()), jnp.asarray(m.numpy()),
                               jnp.asarray(w.numpy()), nx, ny, ps, interpret=True)
        np.testing.assert_array_equal(image.numpy(), np.asarray(ref))


def test_packed_binning_checks_and_splits_launches():
    """More than MAX_ITEMS images split into launches of MAX_ITEMS; bad
    shapes raise before anything is binned."""
    items = _items([500] * (MAX_ITEMS + 2), seed=9, shapes=[SHAPES[2]] * (MAX_ITEMS + 2))
    got = bin_images_cuda(items)
    assert len(got) == MAX_ITEMS + 2
    for image, item in zip(got, items):
        assert torch.equal(image, tbin.bin_image(*item))
    assert bin_images_cuda([]) == []
    x, m, w, nx, ny, ps = items[0]
    with pytest.raises(ValueError):
        pack_items([(x[:, :2], m, w, nx, ny, ps)])
    with pytest.raises(ValueError):
        pack_items([(x, m.to(torch.int8), w, nx, ny, ps)])
    with pytest.raises(ValueError):
        pack_items([(x, m, w[:-1], nx, ny, ps)])


@pytest.mark.parametrize("mode", ["mc", "weight"])
def test_eager_engine_packs_its_images(mode):
    """The eager flagship with ``binning='pallas'`` (K2's plain path on the
    CPU, the unit flag in mc mode) gives the images and counts of
    ``binning='xla'`` on the same draws."""
    out = {}
    for impl in ("xla", "pallas"):
        cfg = cs.flagship(1 << 13, 2, engine="xla", binning=impl, interact_mode=mode)
        cfg["general"]["random_seed"] = 5
        res = engine.raytrace(cfg, device="cpu")
        out[impl] = res["total"]
    for name, image in out["xla"]["image"].items():
        assert torch.equal(torch.as_tensor(out["pallas"]["image"][name]),
                           torch.as_tensor(image))
    assert float(sum(torch.as_tensor(i).sum() for i in out["xla"]["image"].values())) > 0
    for name, meta in out["xla"]["meta"].items():
        assert out["pallas"]["meta"][name]["num_out"] == meta["num_out"]


def _packed(cfg):
    return roofline.k1_pack(engine.Pipeline(cfg, device="cpu"))


def _weighted(cfg):
    cfg["general"]["interact_mode"] = "weight"
    return cfg


@pytest.mark.parametrize("chain,expected", [
    ("flagship", (0, False, 0, 0, False, (10000, 15000))),
    ("flagship weight", (0, False, 1, 0, False, (10000, 15000))),
    ("flagship bilinear", (0, False, 1, 0, False, (10000, 15000))),
    ("toroidal", (0, False, 0, 1, False, (10000, 15000))),
    ("toroidal weight", (0, False, 1, 1, False, (0, 10000))),
    ("cylinder", (0, False, 0, 2, False, (10000, 10800))),
    ("cylinder weight", (0, False, 1, 2, False, (10000, 10800))),
    ("convex_cylinder_mirror", (0, False, 0, 2, True, (10000, 11600))),
    ("torus_no_check", (0, False, 0, 1, True, (0, 10000))),
    ("flagship_no_check", (0, False, 0, 0, True, (10000, 15000))),
    ("plane_fold", (0, False, 0, 0, True, (0, 10000))),
    ("mesh", (0, True, 0, 0, False, (10000, 15000))),
    ("mosaic15", (0, False, 2, 0, False, (10000, 15000))),
    ("generic source", (1, False, 0, 0, False, (10000, 15000))),
    ("plasma_torus", (2, False, 0, 1, False, (10000, 15000))),
])
def test_k1_build_choice(chain, expected):
    """What K1's launcher picks its build from (xrt_fused_build,
    xrt_fused_pick): the source (0 the point cut, 1 the whole generic
    sampler, 2 a plasma), the Chebyshev stage, the stages, the chain's
    curved shapes (FusedParams.shapes: 1 a torus, 2 a cylinder), dense
    images (FusedParams.dense_images) and the window of pixels the window
    builds stage (FusedParams.stage_window). A point source with no
    Chebyshev stage, stages 0 or 1 and no torus takes a build without the
    torus code: the flagship in every mode none of the curved code
    (fused_trace_flat_kernel), the cylinder crystal in mc and weight mode
    the cylinder's (fused_trace_cylinder_kernel, its stage-0 build staging
    the window: the detector's image). The mirror chains (no Bragg or
    mosaic crystal before an image, mc, nearest) ask for dense images, the
    mirror's or the detector's image their window, the flagship's Bragg
    crystal none; a chain with a torus (toroidal, torus_no_check) takes
    the build with every shape, dense or not (the card tests ask the
    library, ``xrt_fused_trace_build``)."""
    n = 1 << 10
    cls, kw = cs.MESH_CRYSTALS["mesh_sphere"]
    mirrors = cs.mirror_configs(n, 1, "fused")
    configs = {
        "flagship": lambda: cs.flagship(n, 1, engine="fused"),
        "flagship weight": lambda: cs.flagship(n, 1, engine="fused", interact_mode="weight"),
        "flagship bilinear": lambda: cs.flagship(n, 1, engine="fused", image_mode="bilinear"),
        "toroidal weight": lambda: _weighted(mirrors["torus_no_check"]),
        "toroidal": lambda: BS.SCENARIOS["toroidal"](n, 1),
        "cylinder": lambda: cs.cylinder_config(n, 1, "fused"),
        "cylinder weight": lambda: cs.cylinder_mode_config("weight", n),
        "mesh": lambda: cs.mesh_config(n, 1, "fused", cls, **kw),
        "mosaic15": lambda: cs.mosaic15_config(n, 1, "fused"),
        "generic source": lambda: cs.source_matrix_config(n, 1, "fused"),
        "plasma_torus": lambda: cs.plasma_config(n, 1, engine="fused"),
        **{name: (lambda cfg=cfg: cfg) for name, cfg in mirrors.items()},
    }
    fparams = _packed(configs[chain]())
    source = 2 if fparams.plasma else int(fparams.full_source)
    assert (source, fparams.cheb, fparams.stages, fparams.shapes, fparams.dense_images,
            fparams.stage_window) == expected


@pytest.mark.parametrize("mode", ["mc", "weight", "bilinear"])
def test_image_adds_match_the_twins_term_tally(mode):
    """At 2^14 flagship rays (Philox): each image's adds (``tools/roofline.
    image_adds``, from the twin's record hook) equal the twin's term tally
    k (``terms=True``), which counts the terms of zero too; in weight mode
    more than half the terms are exactly zero (the rocking curve underflows
    far from Bragg and the rays stay alive), which K1 does not issue; in mc
    mode with nearest images none is."""
    n = 1 << 14
    general = {"weight": {"interact_mode": "weight"},
               "bilinear": {"image_mode": "bilinear"}}.get(mode, {})
    fparams = _packed(cs.flagship(n, 1, engine="fused", **general))
    adds = roofline.image_adds(fparams, n, seed=(1, 2))
    _, _, (k, _) = ft.fused_run_plain(fparams, n, n, seed=(1, 2), terms=True)
    imaged = []
    for e in range(fparams.n_optics):
        oi = fparams.ip_host[ft.HDR_I + e * ft.OPT_I: ft.HDR_I + (e + 1) * ft.OPT_I]
        if oi[7] >= 0:
            imaged.append((e, int(k[oi[7]: oi[7] + oi[8] * oi[9]].sum())))
    assert [(a["optic"], a["adds"]) for a in adds] == imaged
    assert all(a["adds"] > 0 for a in adds)
    zero = sum(a["zero"] for a in adds) / sum(a["adds"] for a in adds)
    if mode == "weight":
        assert zero > 0.5
    else:
        assert zero == 0.0


def test_live_lanes_of_the_flagship_match_the_twin():
    """At 2^16 flagship rays (Philox): the rays alive into each optic equal
    the twin's counts, and the warps with a live lane equal those of the
    twin's history record of the same rays (every ray's alive field after
    each element); about two thirds of the warps find no live lane at the
    detector, none at the aperture or the crystal."""
    n = 1 << 16
    fparams = _packed(cs.flagship(n, 1, engine="fused"))
    live = roofline.live_lanes(fparams, n, seed=(1, 2))
    counts, _ = ft.fused_run_plain(fparams, n, n, seed=(1, 2))
    assert live["counts"] == counts.tolist()
    assert live["rays_into"] == counts.tolist()[:-1]
    spec = ft.HistorySpec("sampled", 1, n)
    hist = ft.history_record_plain(fparams, n, n, spec, seed=(1, 2))
    rows = hist.slots[0].reshape(1 + fparams.n_optics, -1, n)
    alive = rows[:, 7] != 0  # field 7: alive, after the source then each optic
    warps = alive[:-1].reshape(fparams.n_optics, n // 32, 32).any(dim=2).sum(dim=1)
    assert live["warps_into"] == warps.tolist()
    assert live["warps"] == n // 32
    assert live["dead_warp_share"][:2] == [0.0, 0.0]
    assert 0.55 < live["dead_warp_share"][2] < 0.75
    ops = roofline.k1_live_ops(fparams, live, n)
    assert ops["flat"] == roofline.k1_ops(fparams) * n
    assert ops["live_rays"] < ops["live_warps"] < ops["flat"]
    assert sum(roofline.optic_k1_ops(fparams)) == roofline.chain_k1_ops(fparams)


@pytest.mark.parametrize("chain", ["flagship", "flagship weight", "cylinder", "mesh",
                                   "generic source"])
def test_k1_bounds_count_the_rays_alive_into_each_optic(chain):
    """``chip_smoke.k1_bounds``, the bound of K1's rows in the kernels line
    (point and generic sources): the same bytes as the flat bound, and the
    operations of the rays alive into each optic by the twin's counts,
    the source's for every ray; never above the flat census."""
    n = 1 << 12
    cls, kw = cs.MESH_CRYSTALS["mesh_sphere"]
    configs = {
        "flagship": lambda: cs.flagship(n, 1, engine="fused"),
        "flagship weight": lambda: cs.flagship(n, 1, engine="fused", interact_mode="weight"),
        "cylinder": lambda: cs.cylinder_config(n, 1, "fused"),
        "mesh": lambda: cs.mesh_config(n, 1, "fused", cls, **kw),
        "generic source": lambda: cs.source_matrix_config(n, 1, "fused"),
    }
    fparams = _packed(configs[chain]())
    live, flat = cs.k1_bounds(fparams, n)
    counts, _ = ft.fused_run_plain(fparams, n, n, seed=(1, 2))
    per_optic = roofline.optic_k1_ops(fparams)
    source = roofline.k1_ops(fparams) - sum(per_optic)
    ops = source * n + sum(o * r for o, r in zip(per_optic, counts.tolist()[:-1]))
    n_bytes = (cs.packed_bytes(fparams.fp, fparams.ip, fparams.aux)
               + fparams.img_total * 4 + 8 * (1 + fparams.n_optics))
    assert live == roofline.bound(n_bytes, ops)
    assert flat == roofline.bound(n_bytes, roofline.k1_ops(fparams) * n)
    assert live[0] <= flat[0]
    assert ops <= roofline.k1_ops(fparams) * n
    if chain != "flagship weight":  # the Bragg check kills most rays at the crystal
        assert ops < roofline.k1_ops(fparams) * n

