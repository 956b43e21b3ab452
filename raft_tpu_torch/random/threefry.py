"""``jax.random``'s default generator in torch: threefry2x32 keys, bits,
``uniform``, ``randint`` and ``normal``, as JAX computes them with
``jax_threefry_partitionable`` on (JAX's default since 0.5), so the port
makes the JAX package's synthetic data from the same seed.

A key is a pair of Python ints (two uint32 words). Bits are int64 tensors
holding uint32 values (torch has no full uint32 arithmetic). ``split``,
``fold_in``, ``random_bits``, ``uniform`` and ``randint`` give the same
numbers as ``jax.random`` bit for bit. ``normal`` maps the same uniforms
through the same erf⁻¹ polynomial (XLA's single-precision one, with its
multiply-adds fused); XLA's ``log1p`` is its own approximation, so a
normal may differ from JAX's in its last bit or two (about 1% of 96,000
draws differed, by 4.8e-7 at most, in the port's CPU test).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements generated at once: bounds the int64 temporaries
_PIECE = 1 << 24


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 hash of counter pairs (``x0``, ``x1``)."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _hash_pairs(key: Key, hi, lo) -> Tuple[int, int]:
    t = torch.tensor
    b0, b1 = threefry2x32(key, t([hi], dtype=torch.int64),
                          t([lo], dtype=torch.int64))
    return int(b0[0]), int(b1[0])


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``."""
    return (seed >> 32) & _M32, seed & _M32


def split(key: Key, num: int = 2):
    """``jax.random.split(key, num)``: key i hashes the counter (0, i)."""
    return [_hash_pairs(key, 0, i) for i in range(num)]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return _hash_pairs(key, 0, int(data) & _M32)


def random_bits(key: Key, n: int, device="cpu", start: int = 0
                ) -> torch.Tensor:
    """32 random bits for flat positions ``start … start + n − 1`` of a
    draw (JAX hashes each position's 64-bit index), as int64."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & _M32)
    return b0 ^ b1


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Bits → f32 in [0, 1): 23 mantissa bits under exponent 0, minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    n = int(np.prod(shape))
    lo = torch.tensor(np.float32(minval), device=device)
    hi = torch.tensor(np.float32(maxval), device=device)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for a in range(0, n, _PIECE):
        b = min(n, a + _PIECE)
        f = _unit_floats(random_bits(key, b - a, device, a))
        out[a:b] = torch.maximum(lo, f * (hi - lo) + lo)
    return out.view(*shape)


def randint(key: Key, shape, minval: int, maxval: int, device="cpu"
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` as int32 (two
    32-bit draws a value, folded modulo the span)."""
    n = int(np.prod(shape))
    ka, kb = split(key)
    span = max(1, maxval - minval) if maxval > minval else 1
    mult = (65536 % span) & _M32
    mult = (mult * mult) % span
    hi = random_bits(ka, n, device) % span
    lo = random_bits(kb, n, device) % span
    off = ((hi * mult) & _M32) + lo
    off = (off & _M32) % span
    return (off + minval).to(torch.int32).view(*shape)


_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision erf⁻¹ (Giles' polynomial), each multiply-add
    rounded once as XLA's fused one is."""
    w = -torch.log1p(-(x * x).double()).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    wd = w.double()
    c = torch.tensor

    def coef(i):
        return torch.where(lt, c(np.float32(_ERFINV_LT[i]), device=x.device),
                           c(np.float32(_ERFINV_GE[i]), device=x.device))

    p = coef(0)
    for i in range(1, 9):
        p = (coef(i).double() + p.double() * wd).float()
    r = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), r)


def normal(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` (module doc: within a
    few ulps of JAX's)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return erfinv(u) * float(np.float32(np.sqrt(2)))
