"""A plain-torch model of K1's warp-cooperative bundle search
(``xrt_warp_bundle``, ``xicsrt_tpu_torch/csrc/bundle_lookup.cuh``), held
against ``torch.searchsorted(right=True)``, which the fused twin takes.

Each warp of 32 consecutive ray slots is one row of a (warps, 32) tensor: a
ballot is a boolean row, its popcount the row's sum, a shuffle a gather
along the row. The model follows the kernel step by step: the first live
lane's 32-ary search, the window of 32 entries and its per-lane binary
search by shuffles, and the serial search for lanes past the window or in
the warp's second iteration. The card tests hold the kernel itself against
its twin (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

INT_MAX = 2**31 - 1
LANES = torch.arange(32)


def serial_upper_bound(cum, j, lo, hi, x):
    """``xrt_upper_bound`` on each lane: the first b in [lo, hi) of row j
    with cum[b] > x, or hi."""
    lo, hi = lo.clone(), hi.clone()
    while bool((lo < hi).any()):
        go = lo < hi
        mid = lo + (hi - lo) // 2
        le = cum[j, mid.clamp(max=cum.shape[1] - 1)] <= x
        lo = torch.where(go & le, mid + 1, lo)
        hi = torch.where(go & ~le, mid, hi)
    return lo


def warp_bundles(cum, n_total: int, n_per_iter: int):
    """(alive, bundle, rounds, fallback lanes) of rays [0, n_total) as K1's
    warps find them; ``cum``: (iterations, B) inclusive photon counts."""
    n_bundles = cum.shape[1]
    n_warps = -(-n_total // 32)
    r = torch.arange(n_warps * 32).view(n_warps, 32)
    ray = r.clamp(max=n_total - 1)
    j = ray // n_per_iter
    local = ray - j * n_per_iter
    alive = (r < n_total) & (local < cum[j, n_bundles - 1])
    # The leader: the warp's first live lane; a warp with none stops here.
    has = alive.any(1)
    leader = torch.argmax(alive.int(), 1, keepdim=True)
    jl = j.gather(1, leader)[:, 0]
    x = local.gather(1, leader)[:, 0]
    lo = torch.zeros(n_warps, dtype=torch.int64)
    hi = torch.where(has, n_bundles, 0)
    rounds = 0
    while bool((lo < hi).any()):
        go = lo < hi
        s = (hi - lo + 31) // 32
        p = lo[:, None] + (LANES + 1) * s[:, None] - 1
        below = (p < hi[:, None]) & (cum[jl[:, None], p.clamp(max=n_bundles - 1)] <= x[:, None])
        new_lo = lo + below.sum(1) * s  # popc(ballot)
        hi = torch.where(go, torch.minimum(new_lo + s - 1, hi), hi)
        lo = torch.where(go, new_lo, lo)
        rounds += 1
    q = lo[:, None] + LANES
    w = torch.where(q < n_bundles, cum[jl[:, None], q.clamp(max=n_bundles - 1)], INT_MAX)
    k = torch.zeros_like(local)
    for step in (16, 8, 4, 2, 1):  # each lane reads lane k + step - 1
        k = torch.where(w.gather(1, k + step - 1) <= local, k + step, k)
    k = torch.where((w[:, 31:32] <= local) & (k == 31), 32, k)
    same = j == jl[:, None]
    fast = same & (k < 32)
    base = torch.where(same, lo[:, None] + 32, 0)
    late = serial_upper_bound(cum, j, torch.minimum(base, torch.tensor(n_bundles)),
                              torch.full_like(base, n_bundles), local)
    bundle = torch.where(alive, torch.where(fast, lo[:, None] + k, late), 0)
    return (alive.flatten()[:n_total], bundle.flatten()[:n_total], rounds,
            int((alive & ~fast).sum()))


def cum_rows(rng, n_bundles: int, n_iter: int, n_per_iter: int, mean: float):
    """(n_iter, B) int64 cumulative photon counts: Poisson bundles of the
    given mean, with runs of zero-photon bundles. The first iteration fills
    its ``n_per_iter`` slots, so the warp across its end has live lanes in
    two iterations; the others hold fewer photons, and the slots past their
    totals are dead."""
    rows = []
    for i in range(n_iter):
        counts = rng.poisson(mean, n_bundles)
        for _ in range(max(1, n_bundles // 200)):  # runs of empty bundles
            a = int(rng.integers(0, n_bundles))
            counts[a:a + int(rng.integers(1, 40))] = 0
        cum = np.cumsum(counts)
        total = n_per_iter if i == 0 else min(max(int(cum[-1]), n_per_iter // 2), n_per_iter) - 3
        cum = np.minimum(cum, total)
        cum[-1] = total
        rows.append(cum)
    return torch.from_numpy(np.stack(rows)).long()


@pytest.mark.parametrize("n_bundles", [1, 2, 31, 32, 33, 1000, 100000])
def test_warp_search_matches_searchsorted(n_bundles):
    rng = np.random.default_rng(n_bundles)
    n_per_iter = 32 * max(40, n_bundles // 25) + 17  # a warp spans two iterations
    n_iter = 3
    mean = 0.9 * n_per_iter / n_bundles
    cum = cum_rows(rng, n_bundles, n_iter, n_per_iter, mean)
    n_total = n_iter * n_per_iter
    alive, bundle, rounds, late = warp_bundles(cum, n_total, n_per_iter)
    ray = torch.arange(n_total)
    j, local = ray // n_per_iter, ray % n_per_iter
    want_alive = local < cum[j, -1]
    assert torch.equal(alive, want_alive)
    assert int((~alive).sum()) > 0  # dead tail lanes took part
    want = torch.stack([torch.searchsorted(cum[i], local[j == i], right=True)
                        for i in range(n_iter)]).flatten()
    assert torch.equal(bundle[alive], want[want_alive])
    assert rounds <= max(1, math.ceil(math.log2(n_bundles) / 5))
    assert late > 0  # second-iteration lanes, or lanes past the window


def test_window_takes_dense_bundles_without_fallback():
    """Bundles of many photons: every lane of a one-iteration run finds its
    bundle in the window, two rounds at 1000 bundles."""
    cum = torch.arange(1, 1001).long()[None] * 64
    alive, bundle, rounds, late = warp_bundles(cum, 64000, 64000)
    assert bool(alive.all()) and rounds == 2 and late == 0
    assert torch.equal(bundle, torch.searchsorted(cum[0], torch.arange(64000), right=True))
