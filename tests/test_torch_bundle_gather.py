"""K4's plain twin against the JAX bundle gather.

``interval_gather_plain`` must equal the JAX Pallas kernel
``interval_gather(..., interpret=True)`` and its XLA twin
``interval_gather_xla`` exactly: both select whole float32 table rows, and
rays at or past ``cum[-1]`` get zero rows. Inputs are made with numpy from a
seed, with zero-count bundles and tail rays as in ``tests/test_plasma.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xicsrt_tpu.ops.bundle_gather import interval_gather, interval_gather_xla
from xicsrt_tpu_torch.ops import bundle_gather as bg


def _inputs(B, seed, tail=50, k=8):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 7, B)
    counts[rng.random(B) < 0.2] = 0  # plenty of empty bundles
    cum = np.cumsum(counts).astype(np.int32)
    table = rng.standard_normal((B, k)).astype(np.float32)
    return cum, table, int(cum[-1]) + tail


@pytest.mark.parametrize("B", [100, 4096])
def test_plain_equals_jax_kernel_and_xla(B):
    cum, table, n = _inputs(B, seed=B)
    ours = bg.interval_gather_plain(torch.from_numpy(cum), torch.from_numpy(table), n)
    kernel = np.asarray(interval_gather(jnp.asarray(cum), jnp.asarray(table), n,
                                        interpret=True))
    xla = np.asarray(interval_gather_xla(jnp.asarray(cum), jnp.asarray(table), n))
    np.testing.assert_array_equal(ours.numpy(), kernel)
    np.testing.assert_array_equal(ours.numpy(), xla)
    assert not ours[int(cum[-1]):].any()


def test_fewer_attributes_and_leading_empty_bundles():
    """K < 8 columns; bundles of zero count at the front and the back."""
    cum, table, n = _inputs(300, seed=7, tail=10, k=5)
    cum[:4] = 0
    cum[-3:-1] = cum[-1]
    ours = bg.interval_gather_cuda(torch.from_numpy(cum), torch.from_numpy(table), n)
    xla = np.asarray(interval_gather_xla(jnp.asarray(cum), jnp.asarray(table), n))
    assert ours.shape == (n, 5)
    np.testing.assert_array_equal(ours.numpy(), xla)


def test_wrapper_takes_the_twin_on_cpu_and_checks_inputs():
    cum, table, n = _inputs(64, seed=3)
    cum_t, table_t = torch.from_numpy(cum), torch.from_numpy(table)
    before = bg.interval_gather_cuda.launches
    out = bg.interval_gather_cuda(cum_t, table_t, n)
    assert bg.interval_gather_cuda.launches == before  # no kernel on the CPU
    assert torch.equal(out, bg.interval_gather_plain(cum_t, table_t, n))
    with pytest.raises(ValueError, match="unsupported device"):
        bg.interval_gather_cuda(cum_t.to("meta"), table_t.to("meta"), n)


def test_gradient_reaches_the_table_rows():
    """Autograd through the gather adds each ray's row gradient into its
    bundle's row; rays past cum[-1] contribute nothing."""
    cum, table, n = _inputs(40, seed=11, tail=7)
    table_t = torch.from_numpy(table).double().requires_grad_(True)
    out = bg.interval_gather_cuda(torch.from_numpy(cum), table_t, n)
    out.sum(dim=0).dot(torch.arange(8, dtype=torch.float64)).backward()
    counts = np.diff(np.concatenate([[0], cum]))
    expected = counts[:, None] * np.arange(8)[None, :]
    np.testing.assert_array_equal(table_t.grad.numpy(), expected)
