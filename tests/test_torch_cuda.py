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
