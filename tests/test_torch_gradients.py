"""The port's eager gradient path against the JAX package on the CPU.

- Weight mode: a crystal multiplies the ray weight by its reflection
  probability; the port's weight-mode images equal JAX's, image for image,
  on the uniforms JAX drew (float32; rtol 2e-3 per pixel: the same rays and
  splats, but each weight is exp(-z^2/2) of a deviation from two float32
  arcsins, and one ulp of arcsin, 6e-8 rad, is 1.4e-4 of the 0.42 mrad
  sigma, so a weight at z = 3 moves by ~4e-4 when the two libraries round
  apart).
- Bilinear binning: the ``TentImages`` backward equals autograd of the
  scatter splat (float64, rtol 1e-12) and JAX's ``_tent_images`` VJP.
- ``torch.autograd`` of the eager engine equals ``jax.grad`` of JAX's
  ``make_differentiable`` at float64 on identical uniforms and params
  (rtol 1e-9, atol 1e-10 of the largest gradient: only summation order
  differs).
- ``remat=True`` (checkpointed iterations) gives the gradient of
  ``remat=False`` exactly, with generator draws and explicit draws.
- ``align`` recovers a perturbed crystal d-spacing (example 04's task,
  smaller).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xicsrt_tpu.gradients import make_differentiable as jax_make_differentiable
from xicsrt_tpu.ops.binning import _tent_images
from xicsrt_tpu_torch import params_from_jax
from xicsrt_tpu_torch.draws import ExplicitDraws
from xicsrt_tpu_torch.geometry import Frame
from xicsrt_tpu_torch.gradients import (
    align,
    l2_image_loss,
    make_differentiable,
    make_fused_differentiable,
)
from xicsrt_tpu_torch.ops.binning import (
    TentImages,
    bin_image_bilinear,
    bin_images_fused,
)

N_RAYS = 1792


def _config(intensity=N_RAYS, dtype="float32", fwhm=1e-3):
    """``tests/test_fused_grad.py``'s chain: aperture (circle AND NOT
    circle), spherical crystal, detector, 0.01 m pixels."""
    return {
        "general": {"number_of_iter": 1, "random_seed": 0, "print_results": False,
                    "dtype": dtype},
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
                "rocking_fwhm": fwhm, "pixel_size": 0.01},
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4, "ysize": 0.2, "pixel_size": 0.01},
        },
    }


def _jax_draws(key, n, dtype):
    """The uniforms JAX's one-iteration run draws in weight mode: the
    source's u, v (``split(split(split(key, 1)[0])[0], 4)[1]`` split in
    two); weight-mode crystals draw nothing."""
    k_source, _ = jax.random.split(jax.random.split(key, 1)[0])
    ku, kv = jax.random.split(jax.random.split(k_source, 4)[1])
    return [np.asarray(jax.random.uniform(k, (n,), dtype=dtype)) for k in (ku, kv)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_f32():
    image_fn, pipe = jax_make_differentiable(_config())
    key = jax.random.key(3)
    return image_fn, pipe, key


def test_weight_mode_images_match_jax(jax_f32):
    image_fn, jpipe, key = jax_f32
    ref = _np_tree(image_fn(jpipe.params, key))
    fn, tpipe = make_differentiable(_config(), device="cpu")
    params = params_from_jax(_np_tree(jpipe.params))
    with torch.no_grad():
        out = fn(params, ExplicitDraws(_jax_draws(key, N_RAYS, jnp.float32)))
    assert set(out) == set(ref) == {"crystal", "detector"}
    for name, img in out.items():
        scale = np.abs(ref[name]).max()
        assert 0 < ref[name].sum() < N_RAYS
        np.testing.assert_allclose(img.numpy(), ref[name], rtol=2e-3,
                                   atol=1e-6 * scale)


def _random_hits(rng, n, nx, ny, ps, dtype=torch.float64):
    x = np.zeros((n, 3))
    x[:, 0] = rng.uniform(-0.7, 0.7, n) * nx * ps
    x[:, 1] = rng.uniform(-0.7, 0.7, n) * ny * ps
    mask = rng.uniform(size=n) > 0.2
    w = rng.uniform(0.1, 2.0, n)
    return (torch.tensor(x, dtype=dtype), torch.tensor(mask),
            torch.tensor(w, dtype=dtype))


@pytest.mark.parametrize("nx,ny,ps", [(19, 31, 0.01), (40, 20, 0.005)])
def test_tent_backward_matches_scatter_autograd_and_jax(nx, ny, ps):
    rng = np.random.default_rng(11)
    x, mask, w = _random_hits(rng, 2500, nx, ny, ps)
    pw = torch.tensor(rng.normal(size=(nx, ny)))

    def grads(binner):
        xl = x.clone().requires_grad_(True)
        wl = w.clone().requires_grad_(True)
        img = binner(xl, wl)
        (img * pw).sum().backward()
        return img.detach(), xl.grad[:, :2], wl.grad

    img_s, gx_s, gw_s = grads(lambda xl, wl: bin_image_bilinear(xl, mask, wl, nx, ny, ps))
    img_t, gx_t, gw_t = grads(lambda xl, wl: bin_images_fused(
        [(xl, mask, wl, nx, ny, ps)], "bilinear")[0])
    torch.testing.assert_close(img_t, img_s, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gx_t, gx_s, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gw_t, gw_s, rtol=1e-12, atol=1e-12)

    # JAX's tent contraction with its hand-written VJP on the same pixels.
    px = x[:, 0] / ps + (nx - 1) / 2.0
    py = x[:, 1] / ps + (ny - 1) / 2.0
    wm = torch.where(mask, w, 0.0)

    def jloss(px, py, w):
        (img,) = _tent_images(((nx, ny),), 1024, None, (px,), (py,), (w,))
        return jnp.sum(img * jnp.asarray(pw.numpy()))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (px, py, wm)))
    pxt, pyt, wt = (t.clone().requires_grad_(True) for t in (px, py, wm))
    (img,) = TentImages.apply(((nx, ny),), pxt, pyt, wt)
    (img * pw).sum().backward()
    for ours, theirs in zip((pxt.grad, pyt.grad, wt.grad), jg):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-10,
                                   atol=1e-12)


def _leaf_params(params):
    """A copy of ``params`` whose every optic tensor is a leaf that
    requires grad; returns (params, {name: [tensors]})."""
    out = dict(params)
    out["optics"] = {}
    leaves = {}
    for name, p in params["optics"].items():
        q = {}
        for key, v in p.items():
            if isinstance(v, Frame):
                v = Frame(origin=v.origin.clone().requires_grad_(True),
                          basis=v.basis.clone().requires_grad_(True))
                leaves[(name, "origin")], leaves[(name, "basis")] = v.origin, v.basis
            else:
                v = v.clone().requires_grad_(True)
                leaves[(name, key)] = v
            q[key] = v
        out["optics"][name] = q
    return out, leaves


def _jax_leaf(grads, name, key):
    node = grads["optics"][name]
    if key in ("origin", "basis"):
        return np.asarray(getattr(node["frame"], key))
    return np.asarray(node[key])


def test_autograd_matches_jax_grad_float64():
    cfg = _config(dtype="float64")
    image_fn, jpipe = jax_make_differentiable(cfg)
    key = jax.random.key(9)
    rng = np.random.default_rng(2)
    gs = {"crystal": rng.normal(size=(20, 20)), "detector": rng.normal(size=(40, 20))}

    def jloss(params):
        imgs = image_fn(params, key)
        return sum(jnp.sum(imgs[k] * gs[k]) for k in gs)

    jgrad = jax.grad(jloss)(jpipe.params)

    fn, _ = make_differentiable(cfg, device="cpu")
    params, leaves = _leaf_params(params_from_jax(_np_tree(jpipe.params)))
    imgs = fn(params, ExplicitDraws(_jax_draws(key, N_RAYS, jnp.float64)))
    sum((imgs[k] * torch.tensor(gs[k])).sum() for k in gs).backward()

    pairs = [(leaf.grad.numpy(), _jax_leaf(jgrad, name, k))
             for (name, k), leaf in leaves.items()]
    scale = max(np.abs(j).max() for _, j in pairs)
    assert scale > 0
    for (name, k), (ours, theirs) in zip(leaves, pairs):
        np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-10 * scale,
                                   err_msg=f"{name}.{k}")
    # Signal reaches every parameter group of the crystal.
    for k in ("origin", "basis", "radius", "crystal_spacing", "rocking_fwhm"):
        assert np.abs(leaves[("crystal", k)].grad.numpy()).max() > 0, k


@pytest.mark.parametrize("draws", ["generator", "explicit"])
def test_remat_equals_no_remat(draws):
    """The checkpointed recompute draws the same rays: same images, same
    gradient. Two iterations, so the second draws after the first."""
    cfg = _config()
    cfg["general"]["number_of_iter"] = 2
    rows = [np.random.default_rng(k).uniform(size=N_RAYS).astype(np.float32)
            for k in range(4)]
    results = []
    for remat in (False, True):
        fn, pipe = make_differentiable(cfg, remat=remat, device="cpu")
        params, leaves = _leaf_params(pipe.params)
        rng = (torch.Generator().manual_seed(5) if draws == "generator"
               else ExplicitDraws(rows))
        imgs = fn(params, rng)
        (imgs["detector"] * imgs["detector"]).sum().backward()
        results.append(({k: v.detach() for k, v in imgs.items()},
                         {k: v.grad for k, v in leaves.items()}))
    (imgs0, g0), (imgs1, g1) = results
    for k in imgs0:
        assert torch.equal(imgs0[k], imgs1[k])
    assert any(v.abs().max() > 0 for v in g0.values())
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def _example04(intensity):
    """``examples/example_04_differentiable_alignment.py``'s config."""
    return {
        "general": {"number_of_iter": 1, "random_seed": 0, "print_results": False,
                    "dtype": "float64"},
        "sources": {"source": {
            "class_name": "XicsrtSourceDirected", "intensity": intensity,
            "wavelength": 3.9492, "spread": np.radians(10.0)}},
        "optics": {
            "crystal": {
                "class_name": "XicsrtOpticSphericalCrystal",
                "origin": [0.0, 0.0, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151],
                "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
                "crystal_spacing": 2.45676, "rocking_type": "gaussian",
                "rocking_fwhm": 2e-4},
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4, "ysize": 0.2, "pixel_size": 0.01},
        },
    }


def test_align_recovers_spacing():
    """Example 04's task at 20000 rays and 40 steps: Adam on the pixel L2
    loss moves a d-spacing perturbed by 2e-4 (relative) back to the truth,
    with the criteria of ``tests/test_gradients.py``."""
    fn, pipe = make_differentiable(_example04(20000), device="cpu")
    with torch.no_grad():
        target = fn(pipe.params, torch.Generator().manual_seed(7))["detector"]
    perturbed = _example04(20000)
    perturbed["optics"]["crystal"]["crystal_spacing"] = 2.45676 * (1 + 2e-4)
    seen = []
    final, losses = align(perturbed, {"detector": target},
                          [("optics", "crystal", "crystal_spacing")], steps=40,
                          learning_rate=2e-5, seed=7, resample=False, device="cpu",
                          callback=lambda i, loss, trainable: seen.append(i))
    recovered = float(final["optics"]["crystal"]["crystal_spacing"])
    assert seen == list(range(40)) and len(losses) == 40
    assert losses[-1] < 0.25 * losses[0]
    assert abs(recovered - 2.45676) < 0.5 * 2.45676 * 2e-4
    assert not final["optics"]["crystal"]["crystal_spacing"].requires_grad


def test_align_frame_path_and_loss():
    """A frame path optimises origin and basis together."""
    cfg = _config(2000)
    fn, pipe = make_differentiable(cfg, device="cpu")
    with torch.no_grad():
        target = fn(pipe.params, torch.Generator().manual_seed(1))["detector"]
    final, losses = align(cfg, {"detector": target + 0.1},
                          [("optics", "detector", "frame")], steps=2,
                          learning_rate=1e-4, device="cpu")
    frame = final["optics"]["detector"]["frame"]
    assert isinstance(frame, Frame) and len(losses) == 2
    assert not torch.equal(frame.origin, pipe.params["optics"]["detector"]["frame"].origin)
    assert float(l2_image_loss(target, target + 0.1)) == pytest.approx(0.01)


def test_entry_points_need_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_differentiable(_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_fused_differentiable(_config())
    with pytest.raises(NotImplementedError):
        make_differentiable(_config(), n_devices=4, device="cpu")
