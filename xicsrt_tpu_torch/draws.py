"""Where an element takes its random numbers.

The JAX package folds and splits keys; here an engine run owns one
``torch.Generator`` and every element draws from it in a fixed order. The
parity tests instead hand the elements explicit uniform rows, the numbers
the JAX package drew, through the same interface.

``fork`` and ``join`` let a recomputed pass (``Pipeline.make_run(...,
remat=True)``) draw the same numbers again: a fork starts where its parent
stands, and ``join`` moves the parent to where a fork ended.
"""

from __future__ import annotations

import torch

# cuRAND's Poisson sampler, which torch.poisson calls on CUDA, is exact only
# below rate 64 (the product method). Between 64 and 4000 it takes an
# approximate inverse incomplete gamma whose mean is biased (+0.31 at rate
# 4000 and +0.06 at rate 1000, 10 and 3.9 standard errors over 2^22 draws on
# an H100); above 4000 a rounded normal, which has no skew.
_EXACT_BELOW = 64.0


def poisson_counts(lam: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Independent Poisson counts (int64) of the rates ``lam``, exact at
    every rate on every device.

    Each rate of 64 or more is drawn as ``ceil(rate / 63)`` Poisson counts of
    equal rate below 64, and those are summed: a sum of independent Poisson
    counts is a Poisson count of the summed rate. The parts number at most
    ``sum(lam) / 63`` plus one per rate."""
    flat = lam.detach().reshape(-1)
    parts = torch.where(flat >= _EXACT_BELOW, torch.ceil(flat / (_EXACT_BELOW - 1.0)),
                        torch.ones_like(flat)).to(torch.int64)
    owner = torch.repeat_interleave(torch.arange(flat.numel(), device=flat.device), parts)
    drawn = torch.poisson((flat / parts)[owner], generator=generator).to(torch.int64)
    counts = torch.zeros(flat.shape, dtype=torch.int64, device=flat.device)
    return counts.index_add_(0, owner, drawn).reshape(lam.shape)


class Draws:
    """Uniform and normal rows and Poisson counts from a ``torch.Generator``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, n: int, dtype, device) -> torch.Tensor:
        """``n`` uniforms in [0, 1)."""
        return torch.rand(n, generator=self.generator, dtype=dtype, device=device)

    def normal(self, n: int, dtype, device) -> torch.Tensor:
        """``n`` standard normals."""
        return torch.randn(n, generator=self.generator, dtype=dtype, device=device)

    def poisson(self, rate: float) -> int:
        """One Poisson count of mean ``rate``."""
        lam = torch.tensor(float(rate), dtype=torch.float64,
                           device=self.generator.device)
        return int(poisson_counts(lam, self.generator).item())

    def poisson_counts(self, lam: torch.Tensor) -> torch.Tensor:
        """Independent Poisson counts of the rates ``lam`` (int64, on
        ``lam``'s device, which must be the generator's)."""
        return poisson_counts(lam, self.generator)

    def fork(self) -> "Draws":
        gen = torch.Generator(device=self.generator.device)
        gen.set_state(self.generator.get_state())
        return Draws(gen)

    def join(self, fork: "Draws") -> None:
        self.generator.set_state(fork.generator.get_state())


class ExplicitDraws:
    """Given rows (uniform or normal) handed out in order, and given Poisson
    counts: scalars for ``poisson``, vectors for ``poisson_counts``."""

    def __init__(self, rows, counts=()):
        self.rows = list(rows)
        self.counts = list(counts)

    def uniform(self, n: int, dtype, device) -> torch.Tensor:
        row = torch.tensor(self.rows.pop(0), dtype=dtype, device=device)
        if row.shape != (n,):
            raise ValueError(f"row of shape {tuple(row.shape)}, need ({n},)")
        return row

    normal = uniform

    def poisson(self, rate: float) -> int:
        return int(self.counts.pop(0))

    def poisson_counts(self, lam: torch.Tensor) -> torch.Tensor:
        counts = torch.as_tensor(self.counts.pop(0), dtype=torch.int64,
                                 device=lam.device)
        if counts.shape != lam.shape:
            raise ValueError(f"counts of shape {tuple(counts.shape)}, "
                             f"need {tuple(lam.shape)}")
        return counts

    def fork(self) -> "ExplicitDraws":
        return ExplicitDraws(self.rows, self.counts)

    def join(self, fork: "ExplicitDraws") -> None:
        self.rows, self.counts = list(fork.rows), list(fork.counts)
