"""Seed → ``torch.Generator`` (the part of ``raft_tpu.random.rng`` the
build needs).

``RngState`` keeps the JAX package's (seed, subsequence) shape; where the
JAX package folds a key (``jax.random.fold_in``), the port derives a
fresh CPU generator from the pair. Torch and JAX give different numbers
from one seed, so tests make shared inputs with numpy. Where the port
draws as the JAX package draws (k-means' ``fit``), :meth:`RngState.key`
is the JAX package's threefry key of the pair (``random.threefry``).
"""

from __future__ import annotations

import dataclasses

import torch

from raft_tpu_torch.random import threefry


@dataclasses.dataclass
class RngState:
    seed: int = 0
    subsequence: int = 0

    def generator(self) -> torch.Generator:
        """A CPU generator for this (seed, subsequence)."""
        g = torch.Generator(device="cpu")
        g.manual_seed((int(self.seed) * 1_000_003 + int(self.subsequence))
                      % (2**63 - 1))
        return g

    def key(self) -> threefry.Key:
        """The JAX package's key of this state: ``fold_in(PRNGKey(seed),
        subsequence)`` (``raft_tpu/random/rng.py:24-25``)."""
        return threefry.fold_in(threefry.prng_key(int(self.seed)),
                                int(self.subsequence))

    def fold(self, n: int) -> "RngState":
        """Counterpart of ``jax.random.fold_in(key, n)``."""
        return RngState(self.seed, self.subsequence * 7919 + int(n) + 1)


def choice(state: RngState, n: int, k: int, device) -> torch.Tensor:
    """k distinct indices of range(n), without replacement (int64)."""
    return torch.randperm(n, generator=state.generator())[:k].to(device)
