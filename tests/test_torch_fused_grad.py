"""The fused gradient kernels' plain twins (K5f, K5b) against the JAX
package on the CPU.

``build_fused_diff(pipe, chunk=1024, interpret=True, rng='input')`` runs the
Pallas kernels through the interpreter on uniforms drawn as
``jax.random.uniform(key, (n_chunks, n_draws, 8, 128), float32)``; ray
``r = chunk*1024 + s*128 + lane`` takes draw ``k`` from ``U[chunk, k, s,
lane]``, so the port receives ``U.permute(1, 0, 2, 3).reshape(n_draws, -1)``
(as ``tests/test_torch_fused.py`` does).

Tolerances:
- ``pack`` of the port's params equals JAX's ``pvec`` exactly;
- forward images: totals rtol 2e-4 (the JAX test's own bound between its
  kernel and replica) and pixels 1e-3 of the image maximum (float32; the two
  evaluate sin, rsqrt and exp with other roundings, which moves a gaussian
  weight by up to ~1e-4 relative);
- the hand adjoint against ``torch.autograd`` of the forward twin at
  float64: rtol 1e-9, atol 1e-10 of the largest slot (the JAX analog,
  ``test_fused_grad.py:225-247``);
- the float32 adjoint against the JAX float32 kernel's: rtol 2e-3, atol
  2e-5 of the largest slot. Both do the same float32 arithmetic, but round
  sin, rsqrt and exp apart and sum the slots in other orders; the observed
  worst slot (the crystal's bz_y on the flagship chain: 909.46 against
  910.27) uses 0.45 of this bound, 0.13 on the folded variant;
- on the JAX test's chain the float32 adjoint against the float64 truth:
  rtol 2e-2, atol 5e-3 of the largest slot (per-ray terms cancel heavily in
  some slots, ``test_fused_grad.py:250-259``);
- vjp linear in its cotangent: rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu.ops import fused_grad as FG
from xicsrt_tpu_torch import params_from_jax
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.gradients import make_differentiable, make_fused_differentiable
from xicsrt_tpu_torch.ops import fused_grad as fg

N_RAYS = 1792
SLOT_SPACING = fg.SLOTS_PER_OPTIC * 1 + 13  # the crystal's d-spacing


def _config(intensity=N_RAYS, **general):
    """``tests/test_fused_grad.py:26-77``'s chain in weight/bilinear mode."""
    g = {"number_of_iter": 1, "random_seed": 0, "print_results": False,
         "keep_history": False, "interact_mode": "weight",
         "image_mode": "bilinear"}
    g.update(general)
    return {
        "general": g,
        "sources": {"source": {
            "class_name": "XicsrtSourceDirected", "intensity": intensity,
            "wavelength": 3.9492, "angular_dist": "isotropic_xy",
            "spread": np.radians(10.0)}},
        "optics": {
            "aperture": {
                "class_name": "XicsrtOpticAperture",
                "origin": [0.0, 0.0, 0.4], "zaxis": [0.0, 0.0, -1.0],
                "aperture": [
                    {"shape": "circle", "size": [0.09], "logic": "and"},
                    {"shape": "circle", "size": [0.03], "origin": [-0.02, 0.0],
                     "logic": "not"},
                ]},
            "crystal": {
                "class_name": "XicsrtOpticSphericalCrystal",
                "origin": [0.0, -3e-4, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151],
                "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
                "crystal_spacing": 2.45676, "rocking_type": "gaussian",
                "rocking_fwhm": 1e-3, "pixel_size": 0.01},
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4, "ysize": 0.2, "pixel_size": 0.01},
        },
    }


def _variant():
    """The chain folded by a planar mirror (the downstream optics reflected
    through the mirror's plane), with a convex crystal of 5 m radius and a
    50 mrad step rocking curve, a zsize bound and rectangle/ellipse
    apertures."""
    cfg = _config()
    m = np.array([0.0, 0.0, 0.2])
    n = np.array([0.0, 1.0, 1.0]) / np.sqrt(2.0)
    optics = {"fold": {
        "class_name": "XicsrtOpticPlanarMirror", "origin": m.tolist(),
        "zaxis": n.tolist(), "xsize": 0.5, "ysize": 0.5, "pixel_size": 0.025}}
    for name, optic in cfg["optics"].items():
        p = np.asarray(optic["origin"])
        z = np.asarray(optic["zaxis"])
        optics[name] = dict(optic, origin=(p - 2.0 * np.dot(p - m, n) * n).tolist(),
                            zaxis=(z - 2.0 * np.dot(z, n) * n).tolist())
    optics["aperture"]["aperture"] = [
        {"shape": "rectangle", "size": [0.16, 0.12], "logic": "and"},
        {"shape": "ellipse", "size": [0.03, 0.02], "origin": [0.01, 0.0],
         "logic": "xor"},
    ]
    optics["aperture"].update(xsize=0.3, ysize=0.3, zsize=1e-3)
    optics["crystal"].update(rocking_type="step", rocking_fwhm=0.05,
                             convex=True, radius=5.0)
    cfg["optics"] = optics
    return cfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gs(spec, seed=0):
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=(nx, ny)).astype(np.float32)
            for name, nx, ny in spec["images"]}


def _flat(gs, spec, dtype=torch.float32):
    return torch.cat([torch.as_tensor(gs[n], dtype=dtype).reshape(-1)
                      for n, _, _ in spec["images"]])


@pytest.fixture(scope="module", params=["flagship_chain", "variant"])
def pair(request):
    """The JAX interpreted kernels and the port's twins on one config, with
    the uniforms JAX drew, permuted to the port's ray order."""
    cfg = _config() if request.param == "flagship_chain" else _variant()
    jp = JaxPipeline(cfg)
    jforward, jvjp, jpack, jspec = FG.build_fused_diff(
        jp, chunk=1024, interpret=True, rng="input")
    tp = TorchPipeline(cfg, device="cpu")
    forward, vjp, pack, spec = fg.build_fused_diff(tp, rng="input", chunk=1024)
    params = params_from_jax(_np_tree(jp.params))
    key = jax.random.key(5)
    U = jax.random.uniform(key, (jspec["n_chunks"], jspec["n_draws"], 8, 128),
                           dtype=jnp.float32)
    U = torch.tensor(np.asarray(U)).permute(1, 0, 2, 3).reshape(jspec["n_draws"], -1)
    U = U[:, :spec["n_total"]].contiguous()
    return {"name": request.param, "jp": jp, "jforward": jforward, "jvjp": jvjp, "jpvec": jpack(jp.params),
            "key": key, "tp": tp, "forward": forward, "vjp": vjp, "pack": pack,
            "spec": spec, "params": params, "U": U}


def test_pack_matches_jax(pair):
    pvec = pair["pack"](pair["params"])
    assert pvec.dtype == torch.float32 and pvec.shape == pair["jpvec"].shape
    np.testing.assert_array_equal(pvec.numpy(), np.asarray(pair["jpvec"]))
    # The port's own params pack to the same vector.
    np.testing.assert_array_equal(pair["pack"](pair["tp"].params).numpy(), pvec.numpy())
    grads = fg.unpack_grads(pair["tp"], pvec)
    np.testing.assert_array_equal(grads["crystal"]["basis"],
                                  pair["tp"].params["optics"]["crystal"]["frame"].basis)


def test_forward_twin_matches_jax_kernel(pair):
    ref = _np_tree(pair["jforward"](pair["jpvec"], pair["key"])["image"])
    pvec = pair["pack"](pair["params"])
    out = pair["forward"](pvec, 0, uniforms=pair["U"])["image"]
    assert set(out) == set(ref)
    for name, img in out.items():
        img = img.numpy()
        assert img.shape == ref[name].shape and ref[name].sum() > 0
        np.testing.assert_allclose(img.sum(), ref[name].sum(), rtol=2e-4)
        np.testing.assert_allclose(img, ref[name], rtol=0,
                                   atol=1e-3 * np.abs(ref[name]).max())


def test_vjp_twin_matches_jax_kernel_and_truth(pair):
    spec = pair["spec"]
    gs = _gs(spec)
    pvec = pair["pack"](pair["params"])
    ref = np.asarray(pair["jvjp"](pair["jpvec"], pair["key"], gs))
    ours = pair["vjp"](pvec, 0, gs, uniforms=pair["U"]).numpy()
    truth = fg.fused_grad_vjp_plain(spec["static"], pvec.double(), spec["n_total"],
                                    spec["lam"], _flat(gs, spec, torch.float64),
                                    uniforms=pair["U"]).numpy()
    scale = np.abs(truth).max()
    assert scale > 0
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-5 * scale)
    if pair["name"] == "flagship_chain":
        # The JAX test's own bound. On the folded variant the float32
        # adjoint of the fold mirror's origin cancels beyond it, in the JAX
        # kernel as in the twin (both -8484 against -10053 in float64),
        # while the float64 twin equals JAX's float64 autodiff.
        np.testing.assert_allclose(ours, truth, rtol=2e-2, atol=5e-3 * scale)


def test_hand_adjoint_matches_autograd_float64(pair):
    """The hand-written adjoint equals torch.autograd of the forward twin
    on the same rays, at float64."""
    spec = pair["spec"]
    gs = _gs(spec, seed=1)
    g = _flat(gs, spec, torch.float64)
    pvec = pair["pack"](pair["params"]).double().requires_grad_(True)
    images = fg.fused_grad_forward_plain(spec["static"], pvec, spec["n_total"],
                                         spec["lam"], uniforms=pair["U"])
    (images * g).sum().backward()
    auto = pvec.grad.numpy()
    hand = fg.fused_grad_vjp_plain(spec["static"], pvec.detach(), spec["n_total"],
                                   spec["lam"], g, uniforms=pair["U"]).numpy()
    scale = np.abs(auto).max()
    assert scale > 0
    np.testing.assert_allclose(hand, auto, rtol=1e-9, atol=1e-10 * scale)
    b = fg.SLOTS_PER_OPTIC * [o["name"] for o in spec["optics"]].index("crystal")
    assert np.abs(auto[b:b + 3]).max() > 0        # origin
    assert np.abs(auto[b + 3:b + 12]).max() > 0   # basis
    assert abs(auto[b + 12]) > 0                  # radius
    assert abs(auto[b + 15]) > 0                  # reflectivity


def test_vjp_linear_in_cotangent(pair):
    spec = pair["spec"]
    gs = _gs(spec, seed=2)
    pvec = pair["pack"](pair["params"])
    g1 = pair["vjp"](pvec, 0, gs, uniforms=pair["U"]).numpy()
    g2 = pair["vjp"](pvec, 0, {k: 2.0 * v for k, v in gs.items()},
                     uniforms=pair["U"]).numpy()
    np.testing.assert_allclose(g2, 2.0 * g1, rtol=1e-5, atol=1e-8)


def test_philox_stream_and_slicing():
    """rng='hw': the same seed regenerates the same rays in forward and
    vjp, independent of the twin's slice size."""
    tp = TorchPipeline(_config(), device="cpu")
    f1, v1, pack, spec = fg.build_fused_diff(tp, chunk=1024)
    f2, v2, _, _ = fg.build_fused_diff(tp, chunk=700)
    pvec = pack(tp.params)
    a, b = f1(pvec, 9)["image"], f2(pvec, 9)["image"]
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-6)
    assert not torch.equal(f1(pvec, 10)["image"]["detector"], a["detector"])
    gs = _gs(spec)
    torch.testing.assert_close(v1(pvec, 9, gs), v2(pvec, 9, gs), rtol=1e-6, atol=1e-3)
    assert fg.seed_words((1, 2)) == (1, 2)


@pytest.mark.parametrize("change", [
    ("optics", "crystal", {"class_name": "XicsrtOpticToroidalCrystal",
                           "radius_major": 1.0, "radius_minor": 0.4}),
    ("optics", "crystal", {"class_name": "XicsrtOpticSphericalMosaicCrystal"}),
    ("optics", "crystal", {"rocking_type": "file"}),
    ("optics", "crystal", {"class_name": "XicsrtOpticCylindricalCrystal"}),
    ("sources", "source", {"use_poisson": True}),
    ("sources", "source", {"class_name": "XicsrtPlasmaGeneric"}),
    ("sources", "source", {"xsize": 0.01}),
    ("general", None, {"dtype": "float64"}),
])
def test_outside_subset_raises(change):
    section, name, update = change
    cfg = _config()
    (cfg[section] if name is None else cfg[section][name]).update(update)
    with pytest.raises(fg.FusedGradUnsupported):
        make_fused_differentiable(cfg, device="cpu")


def test_mesh_and_mode_raise():
    with pytest.raises(fg.FusedGradUnsupported):
        make_fused_differentiable(_config(), n_devices=4, device="cpu")
    tp = TorchPipeline(_config(interact_mode="mc"), device="cpu")
    with pytest.raises(fg.FusedGradUnsupported):
        fg.build_fused_diff(tp)
    with pytest.raises(ValueError):
        fg.build_fused_diff(TorchPipeline(_config(), device="cpu"), rng="tpu")


def test_sign_descent_recovers_spacing():
    """Example 07's loop on the twins (``test_fused_grad.py:313-341``):
    frozen rays, sign steps of a shrinking size on the pixel L2 loss."""
    forward, vjp, pack, pipe = make_fused_differentiable(_config(1 << 13), device="cpu")
    pvec0 = pack(pipe.params).detach()
    target = forward(pvec0, 11)["image"]
    d_true = float(pvec0[SLOT_SPACING])
    pvec = pvec0.clone()
    pvec[SLOT_SPACING] = d_true * (1.0 + 2e-4)
    step = 2.5e-4
    errs = [abs(float(pvec[SLOT_SPACING]) - d_true)]
    for _ in range(12):
        out = forward(pvec, 11)["image"]
        gv = vjp(pvec, 11, {k: out[k] - target[k] for k in out})
        pvec[SLOT_SPACING] -= step * float(torch.sign(gv[SLOT_SPACING]))
        step *= 0.6
        errs.append(abs(float(pvec[SLOT_SPACING]) - d_true))
    assert errs[-1] < 0.2 * errs[0], errs


def test_spacing_gradient_matches_eager_statistically():
    """d(sum detector)/d(crystal_spacing) from the K5b twin agrees with the
    eager engine's autograd within Monte-Carlo error (different samplers,
    different rays; ``test_fused_grad.py:270-310``)."""
    n = 1 << 14
    forward, vjp, pack, pipe = make_fused_differentiable(_config(n), device="cpu")
    pvec = pack(pipe.params)
    gs = {"crystal": torch.zeros(20, 20), "detector": torch.ones(40, 20)}
    g_f = np.array([float(vjp(pvec, k, gs)[SLOT_SPACING]) for k in range(4)])

    image_fn, pipe64 = make_differentiable(_config(n, dtype="float64"), device="cpu")
    g_x = []
    for k in range(4):
        d = pipe64.params["optics"]["crystal"]["crystal_spacing"].clone().requires_grad_(True)
        params = dict(pipe64.params)
        params["optics"] = dict(params["optics"])
        params["optics"]["crystal"] = dict(params["optics"]["crystal"], crystal_spacing=d)
        image_fn(params, torch.Generator().manual_seed(k))["detector"].sum().backward()
        g_x.append(float(d.grad))
    mf, sf = g_f.mean(), g_f.std(ddof=1) / 2.0
    mx, sx = np.mean(g_x), np.std(g_x, ddof=1) / 2.0
    assert abs(mf) > 5 * sf, (mf, sf)
    assert abs(mf - mx) < 6 * np.sqrt(sf**2 + sx**2) + 0.02 * abs(mx), (mf, sf, mx, sx)
