"""Pairwise distances — the expanded (Gram) and the generic row-tiled
engines (counterpart of ``raft_tpu.distance.pairwise``, after the
reference's ``raft::distance::pairwise_distance``,
distance/distance-inl.cuh:238).

- **expanded** metrics (L2, cosine, inner product, correlation, Hellinger,
  Jaccard, Dice, Russell–Rao) are one Gram product plus an epilogue. The
  product is an ordinary matrix product outside any Pallas kernel in the
  JAX package, so here it is ``torch.matmul`` in fp32 with TF32 off
  (``utils.precision``), as its ``Precision.HIGHEST`` asks; the formulas
  are the JAX package's.
- **unexpanded** metrics (L1, L2, L2-sqrt, Linf, Canberra, Lp, Bray–Curtis,
  Jensen–Shannon, Hamming, KL) broadcast [bm, n, d] row blocks of x
  against y and reduce over the feature axis, with the JAX package's
  conventions (``0·log 0 → 0``, the ``den > 0`` guards, Hamming as a mean).

:func:`pairwise_distance` is the traced entry point; the port's modules
call :func:`pairwise_distance_impl` where the JAX package calls it inside a
jitted program (``brute_force.knn``).
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core.device import resolve_device, to_device
from raft_tpu_torch.core.errors import expects
from raft_tpu_torch.core.tracing import traced
from raft_tpu_torch.distance.types import DistanceType, resolve_metric
from raft_tpu_torch.utils import precision as _precision

# Elements of one [bm, n, d] broadcast block of the generic engine. The
# CPU keeps the JAX package's 2^26 (~256 MB f32). On the card a block
# takes a 32nd of the free memory in f32 elements (free bytes / 128): the
# block's difference, its absolute value and the per-metric temporaries
# (Jensen–Shannon makes about six of the block's size) must fit beside it.
_GENERIC_BUDGET_ELEMS = 1 << 26


def _budget_elems(dev: torch.device) -> int:
    if dev.type != "cuda":
        return _GENERIC_BUDGET_ELEMS
    free, _ = torch.cuda.mem_get_info(dev)
    return max(_GENERIC_BUDGET_ELEMS, free // 128)


# ---------------------------------------------------------------------------
# expanded family: Gram product + epilogue
# ---------------------------------------------------------------------------

def _gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x @ y.T


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(1)


def l2_expanded(x, y, sqrt: bool):
    """‖x − y‖² = ‖x‖² + ‖y‖² − 2⟨x, y⟩, clamped at 0."""
    d2 = (_sq_norms(x)[:, None] + _sq_norms(y)[None, :]
          - 2.0 * _gram(x, y)).clamp_min(0.0)
    return torch.sqrt(d2) if sqrt else d2


def cosine_expanded(x, y):
    """1 − ⟨x, y⟩ / (‖x‖‖y‖)."""
    nx = torch.sqrt(_sq_norms(x).clamp_min(1e-30))
    ny = torch.sqrt(_sq_norms(y).clamp_min(1e-30))
    return 1.0 - _gram(x, y) / (nx[:, None] * ny[None, :])


def inner_product(x, y):
    """The raw inner product: a similarity (select the largest)."""
    return _gram(x, y)


def correlation_expanded(x, y):
    """1 − Pearson correlation: the cosine of the row-centred rows."""
    return cosine_expanded(x - x.mean(1, keepdim=True),
                           y - y.mean(1, keepdim=True))


def hellinger_expanded(x, y):
    """sqrt(1 − Σ √(xᵢyᵢ)) through the Gram of √x."""
    g = _gram(torch.sqrt(x.clamp_min(0.0)), torch.sqrt(y.clamp_min(0.0)))
    return torch.sqrt((1.0 - g).clamp_min(0.0))


def _supports(x, y):
    xb = (x != 0).float()
    yb = (y != 0).float()
    return xb, yb, _gram(xb, yb)


def jaccard_expanded(x, y):
    """1 − |x ∩ y| / |x ∪ y| on the non-zero supports."""
    xb, yb, inter = _supports(x, y)
    union = xb.sum(1)[:, None] + yb.sum(1)[None, :] - inter
    return torch.where(union > 0, 1.0 - inter / union.clamp_min(1.0),
                       torch.zeros_like(inter))


def dice_expanded(x, y):
    """1 − 2|x ∩ y| / (|x| + |y|) on the non-zero supports."""
    xb, yb, inter = _supports(x, y)
    denom = xb.sum(1)[:, None] + yb.sum(1)[None, :]
    return torch.where(denom > 0, 1.0 - 2.0 * inter / denom.clamp_min(1.0),
                       torch.zeros_like(inter))


def russelrao_expanded(x, y):
    """(d − Σ xᵢyᵢ) / d, for binary rows."""
    d = x.shape[1]
    return (d - _gram(x, y)) / d


# ---------------------------------------------------------------------------
# generic row-tiled engine (unexpanded metrics)
# ---------------------------------------------------------------------------

def _row_tile(m: int, n: int, d: int, budget: int) -> int:
    bm = min(m, max(1, budget // max(n * d, 1)))
    if bm >= 8:
        bm -= bm % 8
    return max(bm, 1)


def _tiled_over_rows(x: torch.Tensor, y: torch.Tensor,
                     core: Callable, budget: int) -> torch.Tensor:
    """``core(x_block[bm, 1, d], y[1, n, d]) → [bm, n]`` over row blocks
    of x, so that one broadcast block holds at most ``budget`` elements."""
    m, d = x.shape
    n = y.shape[0]
    bm = _row_tile(m, n, d, budget)
    yb = y[None, :, :]
    if bm >= m:
        return core(x[:, None, :], yb)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    for a in range(0, m, bm):
        out[a:a + bm] = core(x[a:a + bm, None, :], yb)
    return out


def _core_l1(a, b):
    return (a - b).abs().sum(-1)


def _core_l2(a, b):
    diff = a - b
    return (diff * diff).sum(-1)


def _core_l2_sqrt(a, b):
    return torch.sqrt(_core_l2(a, b))


def _core_linf(a, b):
    return (a - b).abs().amax(-1)


def _core_canberra(a, b):
    num = (a - b).abs()
    den = a.abs() + b.abs()
    return torch.where(den > 0, num / den.clamp_min(1e-30),
                       torch.zeros_like(num)).sum(-1)


def _core_lp(p: float):
    def core(a, b):
        return ((a - b).abs() ** p).sum(-1) ** (1.0 / p)
    return core


def _core_braycurtis(a, b):
    num = (a - b).abs().sum(-1)
    den = (a + b).abs().sum(-1)
    return torch.where(den > 0, num / den.clamp_min(1e-30),
                       torch.zeros_like(num))


def _xlogx_over(p, q):
    """p·log(p/q), with 0·log 0 → 0."""
    safe = (p > 0) & (q > 0)
    return torch.where(
        safe, p * torch.log(p.clamp_min(1e-30) / q.clamp_min(1e-30)),
        torch.zeros((), dtype=p.dtype, device=p.device))


def _core_jensenshannon(a, b):
    mid = 0.5 * (a + b)
    s = (_xlogx_over(a, mid) + _xlogx_over(b, mid)).sum(-1)
    return torch.sqrt((0.5 * s).clamp_min(0.0))


def _core_hamming(a, b):
    return (a != b).float().mean(-1)


def _core_kl(a, b):
    return _xlogx_over(a, b).sum(-1)


def haversine(x, y):
    """Great-circle distance between (lat, lon) radian pairs; the feature
    dim must be 2."""
    expects(x.shape[1] == 2 and y.shape[1] == 2,
            "haversine requires 2-D points")
    lat1, lon1 = x[:, 0][:, None], x[:, 1][:, None]
    lat2, lon2 = y[:, 0][None, :], y[:, 1][None, :]
    sdlat = torch.sin(0.5 * (lat2 - lat1))
    sdlon = torch.sin(0.5 * (lon2 - lon1))
    a = sdlat ** 2 + torch.cos(lat1) * torch.cos(lat2) * sdlon ** 2
    return 2.0 * torch.asin(torch.sqrt(a.clamp(0.0, 1.0)))


_EXPANDED = {
    DistanceType.L2Expanded: lambda x, y: l2_expanded(x, y, False),
    DistanceType.L2SqrtExpanded: lambda x, y: l2_expanded(x, y, True),
    DistanceType.CosineExpanded: cosine_expanded,
    DistanceType.InnerProduct: inner_product,
    DistanceType.CorrelationExpanded: correlation_expanded,
    DistanceType.HellingerExpanded: hellinger_expanded,
    DistanceType.JaccardExpanded: jaccard_expanded,
    DistanceType.DiceExpanded: dice_expanded,
    DistanceType.RusselRaoExpanded: russelrao_expanded,
    DistanceType.Haversine: haversine,
}
_CORES = {
    DistanceType.L1: _core_l1,
    DistanceType.L2Unexpanded: _core_l2,
    DistanceType.L2SqrtUnexpanded: _core_l2_sqrt,
    DistanceType.Linf: _core_linf,
    DistanceType.Canberra: _core_canberra,
    DistanceType.BrayCurtis: _core_braycurtis,
    DistanceType.JensenShannon: _core_jensenshannon,
    DistanceType.HammingUnexpanded: _core_hamming,
    DistanceType.KLDivergence: _core_kl,
}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@traced("raft_tpu_torch.pairwise_distance")
def pairwise_distance(x, y, metric="euclidean", metric_arg: float = 2.0,
                      device="cuda") -> torch.Tensor:
    """All-pairs distances [m, n] f32 between the rows of x [m, d] and y
    [n, d]. ``metric``: a :class:`DistanceType` or an alias
    ("euclidean", "cosine", …); ``metric_arg``: the exponent p of "lp"."""
    dev = resolve_device(device)
    return pairwise_distance_impl(to_device(x, dev, torch.float32),
                                  to_device(y, dev, torch.float32),
                                  metric, metric_arg)


def pairwise_distance_impl(x: torch.Tensor, y: torch.Tensor,
                           metric="euclidean", metric_arg: float = 2.0
                           ) -> torch.Tensor:
    """:func:`pairwise_distance` of f32 tensors on one device, without
    its span."""
    mt = resolve_metric(metric)
    expects(x.dim() == 2 and y.dim() == 2,
            "inputs must be 2-D [rows, features]")
    expects(x.shape[1] == y.shape[1], "feature dims differ: %d vs %d",
            x.shape[1], y.shape[1])
    if mt == DistanceType.Precomputed:
        raise ValueError("Precomputed is a marker metric; pass distances "
                         "directly")
    if mt in _EXPANDED:
        _precision.enforce()
        return _EXPANDED[mt](x, y)
    core = (_core_lp(float(metric_arg)) if mt == DistanceType.LpUnexpanded
            else _CORES[mt])
    return _tiled_over_rows(x, y, core, _budget_elems(x.device))


@traced("raft_tpu_torch.distance")
def distance(x, y, metric="euclidean", metric_arg: float = 2.0,
             device="cuda") -> torch.Tensor:
    """The reference's ``raft::distance::distance``
    (distance/distance-inl.cuh:67): :func:`pairwise_distance`."""
    return pairwise_distance(x, y, metric=metric, metric_arg=metric_arg,
                             device=device)
