"""RNG state and distributions (counterpart of ``raft_tpu.random.rng``,
after the reference's random/rng.cuh and rng_state.hpp).

``RngState`` keeps the JAX package's (seed, subsequence) shape, and
:meth:`RngState.key` is the JAX package's threefry key of the pair
(``random.threefry``), so every distribution below draws the numbers
``jax.random`` draws from the same state: integers bit for bit, floats
through the same formulas (their logs and tangents are torch's, so a value
may differ from JAX's in its last bits). A state is an :class:`RngState`
or a key (a pair of uint32 words, :func:`threefry.prng_key`).

The distributions create data, so they take ``device=`` (default
``"cuda"``: without a card they raise unless given ``device="cpu"``).
They draw float32 (the JAX package's default dtype, and its only one
under ``jax_enable_x64`` off) and int32.

:meth:`RngState.generator`, :meth:`RngState.fold` and :func:`choice` are
the port's own: torch generators for the builds that draw with torch
(their draws, and so the builds' sha checks, depend on them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tpu_torch.core.device import resolve_device
from raft_tpu_torch.random import threefry


@dataclasses.dataclass
class RngState:
    """Reproducible RNG state (reference: random/rng_state.hpp:29)."""

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

    def advance(self, n: int = 1) -> "RngState":
        """The state ``n`` subsequences on."""
        return RngState(self.seed, self.subsequence + n)

    def fold(self, n: int) -> "RngState":
        """The torch generators' counterpart of ``jax.random.fold_in(key,
        n)``."""
        return RngState(self.seed, self.subsequence * 7919 + int(n) + 1)


def choice(state: RngState, n: int, k: int, device) -> torch.Tensor:
    """k distinct indices of range(n), without replacement (int64)."""
    return torch.randperm(n, generator=state.generator())[:k].to(device)


def _as_key(state) -> threefry.Key:
    if isinstance(state, RngState):
        return state.key()
    return state  # already a key


def _float32(dtype) -> None:
    if dtype not in (None, torch.float32):
        raise ValueError(f"the draws are float32 (got dtype={dtype})")


def _draw(state, dtype, device):
    _float32(dtype)
    return _as_key(state), resolve_device(device)


def uniform(state, shape, lo=0.0, hi=1.0, dtype=torch.float32,
            device="cuda") -> torch.Tensor:
    key, dev = _draw(state, dtype, device)
    return threefry.uniform(key, shape, lo, hi, dev)


def uniform_int(state, shape, lo, hi, dtype=torch.int32, device="cuda"
                ) -> torch.Tensor:
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"the draws are int32 (got dtype={dtype})")
    return threefry.randint(_as_key(state), shape, int(lo), int(hi),
                            resolve_device(device)).to(dtype)


def normal(state, shape, mu=0.0, sigma=1.0, dtype=torch.float32,
           device="cuda") -> torch.Tensor:
    key, dev = _draw(state, dtype, device)
    return mu + sigma * threefry.normal(key, shape, dev)


def lognormal(state, shape, mu=0.0, sigma=1.0, dtype=torch.float32,
              device="cuda") -> torch.Tensor:
    return torch.exp(normal(state, shape, mu, sigma, dtype, device))


def gumbel(state, shape, mu=0.0, beta=1.0, dtype=torch.float32,
           device="cuda") -> torch.Tensor:
    key, dev = _draw(state, dtype, device)
    return mu + beta * threefry.gumbel(key, shape, dev)


def laplace(state, shape, mu=0.0, scale=1.0, dtype=torch.float32,
            device="cuda") -> torch.Tensor:
    key, dev = _draw(state, dtype, device)
    return mu + scale * threefry.laplace(key, shape, dev)


def exponential(state, shape, lam=1.0, dtype=torch.float32, device="cuda"
                ) -> torch.Tensor:
    key, dev = _draw(state, dtype, device)
    return threefry.exponential(key, shape, dev) / lam


def rayleigh(state, shape, sigma=1.0, dtype=torch.float32, device="cuda"
             ) -> torch.Tensor:
    key, dev = _draw(state, dtype, device)
    u = threefry.uniform(key, shape, float(np.float32(1e-7)), 1.0, dev)
    return sigma * torch.sqrt(-2.0 * torch.log(u))


def cauchy(state, shape, mu=0.0, scale=1.0, dtype=torch.float32,
           device="cuda") -> torch.Tensor:
    key, dev = _draw(state, dtype, device)
    return mu + scale * threefry.cauchy(key, shape, dev)


def bernoulli(state, shape, p=0.5, device="cuda") -> torch.Tensor:
    return threefry.bernoulli(_as_key(state), p, shape,
                              resolve_device(device))
