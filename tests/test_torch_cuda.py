"""The CUDA kernels against their plain twins, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import _spectrometer_config
from xicsrt_tpu_torch.engine import Pipeline
from xicsrt_tpu_torch.ops import fused_trace as ft
from xicsrt_tpu_torch.ops.pallas_binning import bin_image_cuda, bin_image_plain

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
    before = bin_image_cuda.launches
    out = bin_image_cuda(xt, mt, ones, nx, ny, ps)
    assert bin_image_cuda.launches == before + 1
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
