"""``jax.random``'s default generator in torch: threefry2x32 keys, bits,
``uniform``, ``randint`` and ``normal``, as JAX computes them with
``jax_threefry_partitionable`` on (JAX's default since 0.5), so the port
makes the JAX package's synthetic data from the same seed.

``gumbel`` is JAX's default ("low") mode, −log(−log(u)) of the same
uniforms u on [tiny, 1); its logs are torch's, so a value may differ from
JAX's in its last bit, never its order. ``exponential``, ``laplace``,
``cauchy`` and ``bernoulli`` map the same uniforms through JAX 0.9's
formulas (``jax/_src/random.py``), with torch's ``log1p`` and ``tan``.

A key is a pair of Python ints (two uint32 words). Bits are int64 tensors
holding uint32 values (torch has no full uint32 arithmetic). ``split``,
``fold_in``, ``random_bits``, ``uniform``, ``randint`` and ``permutation`` give the
same numbers as ``jax.random`` bit for bit, and so do ``split_rows`` and the
per-row keys' ``randint_rows`` and ``uniform_rows``. ``normal`` maps the same
uniforms through the same erf⁻¹ polynomial (XLA's single-precision one, with its
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
    out = torch.empty(n, dtype=torch.float32, device=device)
    for a in range(0, n, _PIECE):
        b = min(n, a + _PIECE)
        f = _unit_floats(random_bits(key, b - a, device, a))
        out[a:b] = _scaled(f, minval, maxval)
    return out.view(*shape)


def _scaled(f: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``max(lo, f·(hi − lo) + lo)`` in f32 bounds, the sum rounded once as
    XLA's fused multiply-add rounds it (the f32 product is exact in f64).
    With lo = 0 the f32 product is that one rounding. The bounds are host
    numbers, so no draw waits on the device."""
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(hi - lo)
    if lo == 0:
        return (f * span).clamp_min_(float(lo))
    return (f.double() * span + float(lo)).float().clamp_min_(float(lo))


def gumbel(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in JAX's default mode
    ("low": ``-log(-log(uniform(key, shape, tiny, 1)))``)."""
    tiny = float(np.finfo(np.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0, device)))


def exponential(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.exponential(key, shape, float32)``: ``-log1p(-u)`` of
    ``uniform(key, shape)`` (the log1p is torch's: last bits may differ)."""
    return -torch.log1p(-uniform(key, shape, device=device))


def laplace(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.laplace(key, shape, float32)``: ``sign(u)·log1p(−|u|)``
    of u uniform on [−1 + epsneg, 1)."""
    lo = float(np.float32(-1.0) + np.finfo(np.float32).epsneg)
    u = uniform(key, shape, lo, 1.0, device)
    return torch.sign(u) * torch.log1p(-u.abs())


def cauchy(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.cauchy(key, shape, float32)``: ``tan(π·(u − ½))`` of u
    uniform on [eps, 1)."""
    u = uniform(key, shape, float(np.finfo(np.float32).eps), 1.0, device)
    return torch.tan(float(np.float32(np.pi)) * (u - 0.5))


def bernoulli(key: Key, p: float, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode "low"): ``uniform(key,
    shape) < p`` with p in float32, as bools."""
    return uniform(key, shape, device=device) < float(np.float32(p))


def _fold_span(hi: torch.Tensor, lo: torch.Tensor, minval: int,
               maxval: int) -> torch.Tensor:
    """Two 32-bit draws a value → int32 in [minval, maxval): folded modulo
    the span in JAX's uint32 arithmetic, so 2³² mod span is (2¹⁶ mod
    span)² wrapped to 32 bits, then mod span."""
    span = max(1, maxval - minval) if maxval > minval else 1
    mult = (65536 % span) & _M32
    mult = ((mult * mult) & _M32) % span  # the square wraps in uint32
    off = ((hi % span * mult) & _M32) + lo % span
    return ((off & _M32) % span + minval).to(torch.int32)


def randint(key: Key, shape, minval: int, maxval: int, device="cpu"
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` as int32."""
    n = int(np.prod(shape))
    ka, kb = split(key)
    return _fold_span(random_bits(ka, n, device), random_bits(kb, n, device),
                      minval, maxval).view(*shape)


def permutation(key: Key, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as int32: JAX's ``_shuffle`` of
    ``arange(n)``, ⌈3·ln(n) / ln(2³² − 1)⌉ rounds, each splitting the key
    and stably sorting by 32 random bits an element from the subkey."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_M32)))
    x = torch.arange(n, dtype=torch.int32, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.sort(random_bits(sub, n, device), stable=True)[1]]
    return x


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


# ---------------------------------------------------------------------------
# one key per row: a tensor of keys, each pair of words a row's key
# ---------------------------------------------------------------------------

def fold_in_rows(key: Key, data: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.vmap(lambda i: jax.random.fold_in(key, i))(data)``: one key a
    row, returned as its two words (int64 tensors shaped like ``data``)."""
    d = data.to(torch.int64) & _M32
    return threefry2x32(key, torch.zeros_like(d), d)


def randint_rows(keys: Tuple[torch.Tensor, torch.Tensor], n: int,
                 minval: int, maxval: int) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.randint(k, (n,), minval, maxval))``
    over the row keys ``keys`` (two [t] word tensors) → [t, n] int32, each
    row what :func:`randint` gives for that row's key."""
    k1, k2 = keys
    zero = torch.zeros_like(k1)
    ka = threefry2x32((k1, k2), zero, zero)
    kb = threefry2x32((k1, k2), zero, zero + 1)
    return _fold_span(_row_bits(ka, n), _row_bits(kb, n), minval, maxval)


def _row_bits(keys: Tuple[torch.Tensor, torch.Tensor], n: int
              ) -> torch.Tensor:
    """32 random bits for flat positions 0 … n − 1 of each row key's draw
    (:func:`random_bits` a row) → [t, n] int64."""
    k1, k2 = keys
    idx = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    b0, b1 = threefry2x32((k1[:, None], k2[:, None]), idx >> 32, idx & _M32)
    return b0 ^ b1


def split_rows(key: Key, num: int, device="cpu"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.split(key, num)`` as its two words (int64 [num]
    tensors): key i hashes the counter (0, i)."""
    i = torch.arange(num, dtype=torch.int64, device=device)
    return threefry2x32(key, torch.zeros_like(i), i)


def uniform_rows(keys: Tuple[torch.Tensor, torch.Tensor], n: int,
                 minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.uniform(k, (n,), float32, minval,
    maxval))`` over the row keys ``keys`` (two [t] word tensors) → [t, n]
    f32, each row what :func:`uniform` gives for that row's key."""
    return _scaled(_unit_floats(_row_bits(keys, n)), minval, maxval)
