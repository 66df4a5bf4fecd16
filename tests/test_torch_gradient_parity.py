"""The port's eager gradients against the CPU reference's goldens: the three
checks of ``tests/test_gradient_parity.py``, through
``make_differentiable(config, device='cpu')`` and ``torch.autograd``, at
float64 on the flagship chain (Directed source, spherical crystal,
detector), with the same bounds.

- the detected efficiency's derivative in a global-y shift of the crystal
  origin (``gradient_reference.npz``): the port's central difference equals
  the reference's within 5 combined sigma, and autograd equals that
  difference within 3 % (its O(delta^2) truncation on the curved flank)
  plus 5 sigma;
- the [100, 50] detector image's derivative in origin y and in
  crystal_spacing (``gradient_pixel_reference.npz``), smoothed and summed
  into superpixels: within 5 combined sigma (plus 2 % of the scale) in
  every superpixel, and a cosine above 0.95. The field is one
  Jacobian-vector product: the image's vector-Jacobian product ``J^T u``
  is linear in ``u``, so differentiating it again in ``u`` gives ``J``
  (forward mode in two reverse passes). It averages 18 keys where the
  JAX test averages 6: the 6-key cosine of the crystal_spacing field is
  noise-bound, in the JAX package as in the port (JAX's reads 0.983, 0.849
  and 0.948 on keys 0-5, 6-11 and 12-17, the port's 0.934, 0.907 and
  0.942; over 18 keys 0.977 and 0.966);
- d(efficiency)/d(crystal_spacing) and /d(rocking_fwhm)
  (``gradient_params_reference.npz``): within 5 % plus 5 combined sigma of
  the reference's central differences.

The rays of key ``k`` come from ``torch.Generator().manual_seed(k)``, so
the estimates are statistical, as the JAX test's are.
"""

import ast
import os

import numpy as np
import pytest
import torch

from xicsrt_tpu_torch.geometry import Frame
from xicsrt_tpu_torch.gradients import make_differentiable

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
INTENSITY = 1 << 18


def _jax_test_configs():
    """``_config`` of ``tests/test_gradient_parity.py``, read with ``ast``
    (the module itself runs JAX at import)."""
    path = os.path.join(os.path.dirname(__file__), "test_gradient_parity.py")
    defs = [node for node in ast.parse(open(path).read()).body
            if isinstance(node, ast.FunctionDef) and node.name in ("_config", "_config_base")]
    namespace = {"np": np}
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), namespace)
    return namespace["_config"]


_config = _jax_test_configs()


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, name))


def _with_crystal(params, **leaves):
    """A copy of ``params`` with the crystal's ``leaves`` replaced."""
    p = dict(params)
    p["optics"] = dict(params["optics"])
    p["optics"]["crystal"] = dict(params["optics"]["crystal"], **leaves)
    return p


def _shifted(params, t):
    """The crystal moved by ``t`` along global y."""
    frame = params["optics"]["crystal"]["frame"]
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=frame.origin.dtype)
    return _with_crystal(params, frame=Frame(frame.origin + t * e_y, frame.basis))


def _key(k):
    return torch.Generator().manual_seed(k)


def _mean_sem(values):
    values = np.asarray(values)
    return values.mean(), values.std(ddof=1) / np.sqrt(len(values))


def test_gradient_parity_vs_reference():
    golden = _golden("gradient_reference.npz")
    y0, fwhm = float(golden["y0"]), float(golden["rocking_fwhm"])
    delta = float(golden["delta"])
    fd_ref, fd_ref_std = float(golden["fd_efficiency_mean"]), float(golden["fd_efficiency_std"])
    image_fn, pipeline = make_differentiable(_config(y0, fwhm, INTENSITY), device="cpu")
    params = pipeline.params

    def efficiency(t, k):
        return image_fn(_shifted(params, t), _key(k))["detector"].sum() / INTENSITY

    fds, grads = [], []
    for k in range(6):
        plus = efficiency(torch.tensor(delta, dtype=torch.float64), k)
        minus = efficiency(torch.tensor(-delta, dtype=torch.float64), k)
        fds.append(float((plus - minus) / (2 * delta)))
        t = torch.zeros((), dtype=torch.float64, requires_grad=True)
        (g,) = torch.autograd.grad(efficiency(t, k), t)
        grads.append(float(g))
    fd, fd_sigma = _mean_sem(fds)
    g, g_sigma = _mean_sem(grads)
    assert abs(g) > 10 * g_sigma, (g, g_sigma)
    assert abs(fd_ref) > 3 * fd_ref_std, (fd_ref, fd_ref_std)
    combined = np.sqrt(fd_sigma**2 + fd_ref_std**2)
    assert abs(fd - fd_ref) < 5 * combined, (fd, fd_sigma, fd_ref, fd_ref_std)
    assert abs(g - fd) < 0.03 * abs(fd) + 5 * np.sqrt(g_sigma**2 + fd_sigma**2), (g, fd)


def _smooth_coarse(field, cx=20, cy=25):
    from scipy.ndimage import gaussian_filter

    f = gaussian_filter(field, sigma=1.5, mode="constant")
    nx, ny = f.shape
    return f.reshape(cx, nx // cx, cy, ny // cy).sum(axis=(1, 3))


@pytest.mark.parametrize("pname", ["origin_y", "crystal_spacing"])
def test_gradient_parity_pixel_field(pname):
    golden = _golden("gradient_pixel_reference.npz")
    y0, fwhm = float(golden["y0"]), float(golden["rocking_fwhm"])
    ref_sc = np.stack([_smooth_coarse(f) for f in golden[f"fd_pixel_{pname}_fields"]])
    ref_mean = ref_sc.mean(axis=0)
    ref_sem = ref_sc.std(axis=0, ddof=1) / np.sqrt(ref_sc.shape[0])

    config = _config(y0, fwhm, INTENSITY, wavelength_dist="uniform",
                     wavelength_range=[3.9492 - 0.013, 3.9492 + 0.013])
    det = config["optics"]["detector"]
    det["origin"] = list(np.asarray(det["origin"]) + 0.08 * np.asarray(det["zaxis"]))
    # No recomputation: the second reverse pass differentiates the first.
    image_fn, pipeline = make_differentiable(config, remat=False, device="cpu")
    params = pipeline.params

    def field(k):
        if pname == "origin_y":
            v = torch.zeros((), dtype=torch.float64, requires_grad=True)
            p = _shifted(params, v)
        else:
            v = params["optics"]["crystal"]["crystal_spacing"].clone().requires_grad_(True)
            p = _with_crystal(params, crystal_spacing=v)
        image = image_fn(p, _key(k))["detector"] / INTENSITY
        u = torch.zeros_like(image, requires_grad=True)
        (vjp,) = torch.autograd.grad(image, v, grad_outputs=u, create_graph=True)
        (jvp,) = torch.autograd.grad(vjp, u)
        return _smooth_coarse(jvp.numpy())

    fields = np.stack([field(k) for k in range(18)])
    m, s = fields.mean(axis=0), fields.std(axis=0, ddof=1) / np.sqrt(len(fields))
    scale = np.abs(ref_mean).max()
    assert scale > 0
    assert (np.abs(ref_mean) > 0.05 * scale).sum() >= 8
    sigma = np.sqrt(s**2 + ref_sem**2) + 0.02 * scale
    bad = np.abs(m - ref_mean) > 5 * sigma
    assert not bad.any(), (bad.sum(), np.abs(m - ref_mean)[bad].max(), scale)
    cos = float((m * ref_mean).sum() / (np.linalg.norm(m) * np.linalg.norm(ref_mean)))
    assert cos > 0.95, cos


@pytest.mark.parametrize("pname", ["crystal_spacing", "rocking_fwhm"])
def test_gradient_parity_physics_params(pname):
    golden = _golden("gradient_params_reference.npz")
    y0, fwhm = float(golden["y0"]), float(golden["rocking_fwhm0"])
    fd_ref, fd_ref_std = float(golden[f"fd_{pname}_mean"]), float(golden[f"fd_{pname}_std"])
    image_fn, pipeline = make_differentiable(_config(y0, fwhm, INTENSITY), device="cpu")
    params = pipeline.params
    grads = []
    for k in range(6):
        v = params["optics"]["crystal"][pname].clone().requires_grad_(True)
        image = image_fn(_with_crystal(params, **{pname: v}), _key(k))["detector"]
        (g,) = torch.autograd.grad(image.sum() / INTENSITY, v)
        grads.append(float(g))
    g, g_sigma = _mean_sem(grads)
    assert abs(g) > 10 * g_sigma, (g, g_sigma)
    assert abs(fd_ref) > 3 * fd_ref_std, (fd_ref, fd_ref_std)
    combined = np.sqrt(g_sigma**2 + fd_ref_std**2)
    assert abs(g - fd_ref) < 0.05 * abs(fd_ref) + 5 * combined, (g, g_sigma, fd_ref, fd_ref_std)
