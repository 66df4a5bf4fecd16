"""The binning kernel's plain twin and the port's scatter binning against
the JAX package: ``ops.binning.bin_image`` and the Pallas kernel
``bin_image_pallas`` run through its interpreter (the
``tests/test_parallel.py`` pattern).

Hits come from a numpy seed as float32 and include exact half-pixel ties,
which must round half to even in every implementation. Unit-weight images
are compared for exact equality.

``bin_image`` runs under ``jax.jit``, as the JAX engine runs it: XLA then
turns ``x / pixel_size`` into a fused multiply-add with the float32
reciprocal, which moves some exact ties by one pixel against an eager
division. The port reproduces the jitted form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xicsrt_tpu.ops.binning import bin_image as _jax_bin_image
from xicsrt_tpu.ops.pallas_binning import bin_image_pallas
from xicsrt_tpu_torch.ops import binning as tbin
from xicsrt_tpu_torch.ops.pallas_binning import bin_image_plain, bin_images_cuda

jax_bin_image = jax.jit(_jax_bin_image, static_argnums=(3, 4, 5))
SHAPES = [(100, 100, 0.002), (100, 50, 0.004), (40, 20, 0.005)]


def _hits(nx, ny, ps, n=20000, seed=0):
    """Local hits over the grid and a margin, a random mask, and tie rays."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, 3), np.float32)
    x[:, 0] = (rng.uniform(-0.5, 0.5, n) * (nx + 4) * ps).astype(np.float32)
    x[:, 1] = (rng.uniform(-0.5, 0.5, n) * (ny + 4) * ps).astype(np.float32)
    x[:, 2] = rng.uniform(-1e-3, 1e-3, n).astype(np.float32)
    # Exact half-pixel ties: float32 neighbours of each pixel boundary whose
    # fma(x, 1/ps, (nb-1)/2), rounded once to float32, is k + 0.5.
    inv = np.float64(np.float32(1.0) / np.float32(ps))
    for axis, nb in ((0, nx), (1, ny)):
        half = (nb - 1) / 2.0
        base = ((np.arange(-1, nb + 1) + 0.5 - half) * ps).astype(np.float32)
        cand = np.concatenate([(base.view(np.int32) + d).view(np.float32)
                               for d in range(-64, 65)])
        f = (cand.astype(np.float64) * inv + half).astype(np.float32)
        ties = np.unique(cand[f == np.floor(f) + np.float32(0.5)])
        assert ties.size > nb
        rows = rng.choice(n, size=min(n // 4, 20 * ties.size), replace=False)
        x[rows, axis] = np.resize(ties, rows.size)
    mask = rng.uniform(size=n) < 0.85
    return x, mask


@pytest.mark.parametrize("nx,ny,ps", SHAPES)
def test_twin_matches_jax_bin_image_and_pallas(nx, ny, ps):
    x, mask = _hits(nx, ny, ps)
    w = np.ones(len(x), np.float32)
    jx, jm, jw = jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w)
    ref_scatter = np.asarray(jax_bin_image(jx, jm, jw, nx, ny, ps))
    ref_pallas = np.asarray(bin_image_pallas(jx, jm, jw, nx, ny, ps, interpret=True))
    tx, tm, tw = torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(w)
    twin = bin_image_plain(tx, tm, tw, nx, ny, ps).numpy()
    scatter = tbin.bin_image(tx, tm, tw, nx, ny, ps).numpy()
    assert ref_scatter.sum() > 0.5 * mask.sum()
    # Exact: integer counts, the same rounding of every tie.
    np.testing.assert_array_equal(twin, ref_pallas)
    np.testing.assert_array_equal(twin, ref_scatter)
    np.testing.assert_array_equal(scatter, ref_scatter)


def test_weighted_twin_matches_jax():
    nx, ny, ps = SHAPES[0]
    x, mask = _hits(nx, ny, ps, seed=1)
    w = np.random.default_rng(2).uniform(size=len(x)).astype(np.float32)
    ref = np.asarray(jax_bin_image(jnp.asarray(x), jnp.asarray(mask),
                                   jnp.asarray(w), nx, ny, ps))
    twin = bin_image_plain(torch.from_numpy(x), torch.from_numpy(mask),
                           torch.from_numpy(w), nx, ny, ps).numpy()
    # Float32 sums of ~2 weights per pixel, possibly in another order.
    np.testing.assert_allclose(twin, ref, rtol=1e-6, atol=1e-6)


def test_round_half_to_even():
    """Exact ties on both sides of even and odd pixels."""
    nx, ny, ps = 4, 1, 0.5
    # x/ps + 1.5 = 0.5, 1.5, 2.5, 3.5 -> pixels 0, 2, 2, 4 (dropped).
    x = np.array([[-0.5, 0, 0], [0.0, 0, 0], [0.5, 0, 0], [1.0, 0, 0]], np.float32)
    mask = np.ones(4, bool)
    w = np.ones(4, np.float32)
    ref = np.asarray(jax_bin_image(jnp.asarray(x), jnp.asarray(mask),
                                   jnp.asarray(w), nx, ny, ps))
    twin = bin_images_cuda([(torch.from_numpy(x), torch.from_numpy(mask),
                             torch.from_numpy(w), nx, ny, ps)])[0].numpy()
    np.testing.assert_array_equal(ref[:, 0], [1, 0, 2, 0])
    np.testing.assert_array_equal(twin, ref)


def test_cpu_tensors_take_the_twin():
    """On CPU tensors the wrapper runs the twin and launches nothing."""
    nx, ny, ps = SHAPES[1]
    x, mask = _hits(nx, ny, ps, n=3000, seed=3)
    w = np.ones(len(x), np.float32)
    before = bin_images_cuda.launches
    items = [(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(w),
              nx, ny, ps)]
    out = tbin.bin_images_fused(items, "nearest", impl="pallas")[0]
    ref = tbin.bin_images_fused(items, "nearest", impl="xla")[0]
    assert bin_images_cuda.launches == before
    assert torch.equal(out, ref)
    # Bilinear images are plain PyTorch on every device; the pallas choice
    # names the nearest-mode kernel only.
    bilinear = tbin.bin_images_fused(items, "bilinear", impl="pallas")[0]
    assert bin_images_cuda.launches == before
    assert torch.equal(bilinear, tbin.bin_images_fused(items, "bilinear")[0])
    assert 0 < float(bilinear.sum()) <= float(mask.sum())
    with pytest.raises(ValueError):
        tbin.bin_images_fused(items, "cubic")


def test_float64_inputs_bin_in_float32():
    """Like pallas_binning.py:79, the kernel path casts to float32 first."""
    nx, ny, ps = SHAPES[2]
    x, mask = _hits(nx, ny, ps, n=2000, seed=4)
    w = np.ones(len(x), np.float64)
    out, = bin_images_cuda([(torch.from_numpy(x.astype(np.float64)),
                             torch.from_numpy(mask), torch.from_numpy(w), nx, ny, ps)])
    ref = bin_image_pallas(jnp.asarray(x.astype(np.float64)), jnp.asarray(mask),
                           jnp.asarray(w), nx, ny, ps, interpret=True)
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

