"""The fused gradient path on the tasks of examples 07 and 08, on the CPU
twins of K5f and K5b, at small sizes.

- A cubic plasma (``tests/test_fused_grad.py:720-817``'s configuration):
  d/d(emissivity) against a central finite difference of the forward twin
  over +-5 % (the image is linear in the emissivity: within 2 %);
  d/d(temperature) against a central finite difference over +-2 % (within
  15 %, the JAX test's bound) and against the eager engine's autograd at
  float64 over 6 seeds each (means within 6 combined standard errors plus
  5 %; the two sample other rays).
- Example 07's sign descent on its toroidal crystal at 2^13 rays: the
  d-spacing error falls below 0.2 of the perturbation, and the radius and
  radius_minor gradients at the perturbed start are nonzero.
- Example 08's fit of (log E, log T) by Adam at 2000 photons: E within 5 %
  and T within 15 % (the example's own asserts).
"""

import copy

import numpy as np
import torch

from tests.test_fused_grad import _variant_config
from xicsrt_tpu_torch.gradients import make_differentiable, make_fused_differentiable
from xicsrt_tpu_torch.ops.fused_grad import SLOTS_PER_OPTIC, unpack_grads


def _hot_plasma(dtype="float32"):
    config = copy.deepcopy(_variant_config("plasma_cubic"))
    p = config["sources"]["plasma"]
    p.update(emissivity=8.3e20, temperature=2e4, xsize=2e-4, ysize=2e-4, zsize=2e-4,
             bundle_volume=8e-12)
    config["optics"]["detector"]["pixel_size"] = 0.002
    config["general"]["dtype"] = dtype
    return config


def test_plasma_gradients_fd_and_eager_parity():
    forward, vjp, pack, pipe = make_fused_differentiable(_hot_plasma(), device="cpu")
    pvec = pack(pipe.params).detach()
    b = len(pipe.optics) * SLOTS_PER_OPTIC
    out0 = forward(pvec, 4)["image"]
    img0 = out0["detector"].numpy()
    prof = img0.sum(axis=1)
    cx = (np.arange(len(prof)) * prof).sum() / max(prof.sum(), 1e-9)
    nx, ny = img0.shape
    # A second-moment loss: the temperature sets the line width, which a
    # total-weight loss does not see to first order.
    g_det = torch.from_numpy(np.broadcast_to(((np.arange(nx) - cx) ** 2)[:, None],
                                             (nx, ny)).astype(np.float32).copy())
    gs = {"crystal": torch.zeros_like(out0["crystal"]), "detector": g_det}
    gv = vjp(pvec, 4, gs).numpy()

    def loss_at(k, scale):
        pv = pvec.clone()
        pv[k] *= scale
        return float((forward(pv, 4)["image"]["detector"].double() * g_det).sum())

    E0, T0 = float(pvec[b]), float(pvec[b + 1])
    fd_E = (loss_at(b, 1.05) - loss_at(b, 0.95)) / (0.1 * E0)
    assert abs(gv[b] - fd_E) < 2e-2 * abs(fd_E), (gv[b], fd_E)
    fd_T = (loss_at(b + 1, 1.02) - loss_at(b + 1, 0.98)) / (0.04 * T0)
    assert abs(fd_T) > 0
    assert abs(gv[b + 1] - fd_T) < 0.15 * abs(fd_T), (gv[b + 1], fd_T)

    image_fn, pipe64 = make_differentiable(_hot_plasma("float64"), device="cpu")
    g_x = []
    for k in range(6):
        T = pipe64.params["sources"]["plasma"]["temperature"].clone().requires_grad_(True)
        params = dict(pipe64.params)
        params["sources"] = {"plasma": dict(params["sources"]["plasma"], temperature=T)}
        img = image_fn(params, torch.Generator().manual_seed(k))["detector"]
        (img * g_det.double()).sum().backward()
        g_x.append(float(T.grad))
    g_f = np.array([float(vjp(pvec, k, gs)[b + 1]) for k in range(6)])
    mf, sf = g_f.mean(), g_f.std(ddof=1) / np.sqrt(6)
    mx, sx = np.mean(g_x), np.std(g_x, ddof=1) / np.sqrt(6)
    assert abs(mf) > 3 * sf, (mf, sf)
    assert abs(mf - mx) < 6 * np.sqrt(sf**2 + sx**2) + 0.05 * abs(mx), (mf, sf, mx, sx)


def _example07(intensity):
    """``examples/example_07_fused_gradients.py``'s config."""
    return {
        "general": {"number_of_iter": 1, "random_seed": 0, "print_results": False},
        "sources": {"source": {
            "class_name": "XicsrtSourceDirected", "intensity": intensity,
            "wavelength": 3.9492, "angular_dist": "isotropic_xy",
            "spread": np.radians(10.0)}},
        "optics": {
            "crystal": {
                "class_name": "XicsrtOpticToroidalCrystal",
                "origin": [0.0, -3e-4, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151],
                "xsize": 0.2, "ysize": 0.2, "radius_major": 1.0, "radius_minor": 0.4,
                "crystal_spacing": 2.45676, "rocking_type": "gaussian",
                "rocking_fwhm": 1e-3, "pixel_size": 0.01},
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4, "ysize": 0.2, "pixel_size": 0.01},
        },
    }


def test_example07_sign_descent_on_a_torus():
    forward, vjp, pack, pipe = make_fused_differentiable(_example07(1 << 13), device="cpu")
    pvec_true = pack(pipe.params).detach()
    target = forward(pvec_true, 7)["image"]
    slot = SLOTS_PER_OPTIC * 0 + 13
    d_true = float(pvec_true[slot])
    pvec = pvec_true.clone()
    pvec[slot] = d_true * (1 + 2e-4)
    errs = [abs(float(pvec[slot]) - d_true)]
    step, gvec0 = 2.5e-4, None
    for _ in range(14):
        out = forward(pvec, 7)["image"]
        gvec = vjp(pvec, 7, {k: out[k] - target[k] for k in out})
        gvec0 = gvec if gvec0 is None else gvec0
        pvec[slot] -= step * float(torch.sign(gvec[slot]))
        step *= 0.6
        errs.append(abs(float(pvec[slot]) - d_true))
    assert errs[-1] < 0.2 * errs[0], errs
    grads = unpack_grads(pipe, gvec0)["crystal"]
    assert grads["radius"] != 0.0 and grads["radius_minor"] != 0.0, grads


def _example08(emissivity, temperature):
    """``examples/example_08_plasma_fitting.py``'s config, with the
    emissivity scaled from 8.3e20 to 2000 expected photons."""
    cfg = _hot_plasma()
    cfg["sources"]["plasma"].update(emissivity=emissivity, temperature=temperature)
    cfg["optics"]["crystal"]["pixel_size"] = 0.02
    return cfg


def test_example08_fit_recovers_emissivity_and_temperature():
    E_true, T_true = 8.3e20 * 2000 / 8087, 2.0e4
    forward, vjp, pack, pipe = make_fused_differentiable(
        _example08(E_true, T_true), chunk=8192, device="cpu")
    pvec_true = pack(pipe.params).detach()
    b = len(pipe.optics) * SLOTS_PER_OPTIC
    target = forward(pvec_true, 3)["image"]["detector"]
    pvec = pvec_true.clone()
    pvec[b] *= 0.6
    pvec[b + 1] *= 0.5
    m, v = np.zeros(2), np.zeros(2)
    lr, b1, b2 = 0.08, 0.9, 0.999
    for step in range(200):
        out = forward(pvec, 3)["image"]
        g_img = {k: out[k] - target if k == "detector" else torch.zeros_like(out[k])
                 for k in out}
        gvec = vjp(pvec, 3, g_img).numpy()
        theta = np.log(pvec[b:b + 2].double().numpy())
        grad = gvec[b:b + 2] * np.exp(theta)
        m = b1 * m + (1 - b1) * grad
        v = b2 * v + (1 - b2) * grad * grad
        mh, vh = m / (1 - b1 ** (step + 1)), v / (1 - b2 ** (step + 1))
        theta = theta - lr * mh / (np.sqrt(vh) + 1e-12)
        pvec[b:b + 2] = torch.from_numpy(np.exp(theta)).float()
    E_fit, T_fit = float(pvec[b]), float(pvec[b + 1])
    assert abs(E_fit / float(pvec_true[b]) - 1) < 0.05, E_fit
    assert abs(T_fit / T_true - 1) < 0.15, T_fit
