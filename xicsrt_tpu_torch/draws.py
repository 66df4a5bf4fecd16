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


class Draws:
    """Uniform rows and Poisson counts from a ``torch.Generator``."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, n: int, dtype, device) -> torch.Tensor:
        """``n`` uniforms in [0, 1)."""
        return torch.rand(n, generator=self.generator, dtype=dtype, device=device)

    def poisson(self, rate: float) -> int:
        """One Poisson count of mean ``rate``."""
        lam = torch.tensor(float(rate), dtype=torch.float64,
                           device=self.generator.device)
        return int(torch.poisson(lam, generator=self.generator).item())

    def fork(self) -> "Draws":
        gen = torch.Generator(device=self.generator.device)
        gen.set_state(self.generator.get_state())
        return Draws(gen)

    def join(self, fork: "Draws") -> None:
        self.generator.set_state(fork.generator.get_state())


class ExplicitDraws:
    """Given uniform rows handed out in order (and given Poisson counts)."""

    def __init__(self, rows, counts=()):
        self.rows = list(rows)
        self.counts = list(counts)

    def uniform(self, n: int, dtype, device) -> torch.Tensor:
        row = torch.tensor(self.rows.pop(0), dtype=dtype, device=device)
        if row.shape != (n,):
            raise ValueError(f"uniform row of shape {tuple(row.shape)}, need ({n},)")
        return row

    def poisson(self, rate: float) -> int:
        return int(self.counts.pop(0))

    def fork(self) -> "ExplicitDraws":
        return ExplicitDraws(self.rows, self.counts)

    def join(self, fork: "ExplicitDraws") -> None:
        self.rows, self.counts = list(fork.rows), list(fork.counts)
