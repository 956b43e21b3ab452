"""The port's six kernels: each plain PyTorch version against its Pallas
kernel (interpret mode on the CPU), on the same seeded numpy inputs. The
CUDA kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances (f32 throughout; the two sides sum in different orders):

- select_k: exact, values and positions, with duplicated values that pin
  down the tie rule (lowest position first);
- fused_l2_argmin: distances rtol 1e-5, atol 1e-4; argmins equal except
  on rows whose best two distances are within 1e-5 relative;
- LUT scan: keys rtol 1e-4, atol 1e-3; ids equal wherever the key gap to
  the bin's neighbouring rank exceeds that tolerance;
- gather-refine: keys rtol 1e-5; ids equal;
- segmented and grouped scans: live slots' keys rtol = atol = 1e-4 (rtol
  also scaled by ‖q‖², which the expanded l2 form cancels), ids or
  positions equal wherever the key is finite and not tied.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_common as jic
from raft_tpu.ops import pallas_kernels as pk
from raft_tpu_torch.neighbors import ivf_common as tic
from raft_tpu_torch.ops import kernels as K

from torch_parity import (SCAN_OPERANDS, assert_bins_match,
                          assert_scan_match, flat_scan_case,
                          flat_scan_operands, pair_rows, refine_case,
                          scan_case, scan_reference_keys, tied_scores)


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# select_k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_select_k_plain_matches_pallas(k, select_min):
    s = tied_scores(12, 700, seed=k)
    jv, ji = pk.select_k_pallas(jnp.asarray(s), k, select_min=select_min,
                                interpret=True)
    tv, ti = K.select_k_cuda(_t(s), k, select_min)   # CPU → plain version
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# (len, aligned) → (vec, per_lane, smem_bytes) of select_k_plan
SELECT_K_PLANS = [((20, True), (4, 4, 0)), ((256, True), (4, 8, 0)),
                  ((256, False), (1, 8, 0)), ((320, True), (4, 16, 0)),
                  ((1024, True), (4, 32, 0)), ((7, True), (1, 1, 0)),
                  ((1025, True), (1, 0, 4100)), ((8192, True), (1, 0, 32768)),
                  ((10240, False), (1, 0, 40960)), ((10241, True), (1, 0, 0)),
                  ((100003, True), (1, 0, 0))]


@pytest.mark.parametrize("args,plan", SELECT_K_PLANS)
def test_select_k_plan(args, plan):
    """The select_k kernel's variant and shared memory by row length: a
    warp per row up to 1024 (16-byte loads on aligned rows, a power of
    two of keys a lane that covers the row), a block per row beyond,
    its keys staged in at most 40 KB of shared memory."""
    length, _ = args
    assert K.select_k_plan(*args) == plan
    vec, per_lane, smem = plan
    if per_lane:
        assert length <= 32 * per_lane
        assert per_lane == vec or 16 * per_lane < length
        assert per_lane % vec == 0 and per_lane & (per_lane - 1) == 0
    assert smem in (0, 4 * length) and smem <= 4 * K.SELECT_K_STAGE_MAX


@pytest.mark.parametrize("n,k", [(9000, 16), (300, 100), (70000, 80),
                                 (256, 10), (1024, 64)])
def test_select_k_dispatch_matches_jax(n, k):
    """matrix.select_k's tiers (kernel, sort, tiled) against the JAX
    package's select_k, ties included, with input_indices."""
    from raft_tpu.matrix.select_k import select_k as jselect
    from raft_tpu_torch.matrix.select_k import select_k as tselect

    s = tied_scores(3, n, seed=n)
    ids = np.random.default_rng(1).permutation(3 * n).reshape(3, n).astype(
        np.int32)
    for select_min in (True, False):
        jv, ji = jselect(jnp.asarray(s), k, select_min=select_min,
                         input_indices=jnp.asarray(ids))
        tv, ti = tselect(_t(s), k, select_min=select_min,
                         input_indices=_t(ids))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# fused_l2_argmin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,d", [(600, 300, 32), (100, 1100, 96)])
def test_fused_l2_argmin_plain_matches_pallas(m, n, d):
    rng = np.random.default_rng(m + n)
    x = rng.standard_normal((m, d)).astype(np.float32) * 3.0
    y = rng.standard_normal((n, d)).astype(np.float32) * 3.0
    y[7] = y[3]  # duplicated center: the first index must win
    x[:5] = y[3]
    jd, ji = pk.fused_l2_argmin(jnp.asarray(x), jnp.asarray(y),
                                interpret=True)
    td, ti = K.fused_l2_argmin(_t(x), _t(y))
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-4)
    assert (ti.numpy()[:5] == 3).all() and (ji[:5] == 3).all()
    d2 = ((x[:, None, :].astype(np.float64) - y[None].astype(np.float64)) ** 2
          ).sum(-1)
    best2 = np.sort(d2, axis=1)[:, :2]
    close = best2[:, 1] - best2[:, 0] <= 1e-5 * np.abs(best2[:, 1])
    assert ((ti.numpy() == ji) | close).all()


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to the nearest
    value with 10 explicit mantissa bits, ties away from zero."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("d", [96, 128])
def test_fused_l2_argmin_3xtf32_keeps_the_tolerance(d):
    """The B4 kernel's numerics, emulated on the CPU: ⟨x, y⟩ as
    x_hi·y_hi + x_hi·y_lo + x_lo·y_hi with TF32 parts (exact products, f32
    sums, as the tensor cores give them) keeps every distance within the
    smoke's 1e-4 + 1e-5·(‖x‖² + ‖y‖²) of the f64 distance on DEEP-shaped
    data (8192 centers in [0, 10)^d, rows at σ 0.5 around them, with
    planted near-ties), and its argmins differ from f64's only at ties;
    one TF32 product does not."""
    rng = np.random.default_rng(d)
    y = rng.uniform(0, 10, (8192, d)).astype(np.float32)
    j = rng.integers(0, 8192, 1024)
    x = (y[j] + 0.5 * rng.standard_normal((1024, d))).astype(np.float32)
    # near-ties: a second center 1e-3 off each of 64 rows' own center
    tie = rng.choice(8192, 64, replace=False)
    y[tie] = y[j[:64]] + 1e-3 * rng.standard_normal((64, d)).astype(
        np.float32)
    xt, yt = torch.tensor(x), torch.tensor(y)
    x64, y64 = xt.double(), yt.double()
    d64 = ((x64 * x64).sum(1)[:, None] + (y64 * y64).sum(1)[None, :]
           - 2.0 * x64 @ y64.T).clamp_min(0.0)
    xsq, ysq = (xt * xt).sum(1), (yt * yt).sum(1)
    tol = 1e-4 + 1e-5 * (xsq[:, None] + ysq[None, :]).double()
    xh, yh = _tf32(xt), _tf32(yt)
    xl, yl = _tf32(xt - xh), _tf32(yt - yh)

    def dist(prod):
        return (xsq[:, None] + ysq[None, :] - 2.0 * prod).clamp_min(0.0)

    d3 = dist(xl @ yh.T + xh @ yl.T + xh @ yh.T).double()
    assert bool(((d3 - d64).abs() <= tol).all())
    m64, a64 = d64.min(1)
    a3 = d3.argmin(1)
    rows = torch.arange(1024)
    assert bool((d64[rows, a3] - m64 <= tol[rows, a3]).all())
    assert int((a64[:64] != torch.tensor(j[:64])).sum()) + int(
        (a64[:64] != torch.tensor(tie)).sum()) == 64   # ties are planted
    d1 = dist(xh @ yh.T).double()
    m1, a1 = d1.min(1)
    assert bool(((d1 - d64).abs() > tol).any())
    assert bool(((m1 - m64).abs() > tol[rows, a64]).any())


def test_fused_l2_nn_argmin_matches_jax():
    from raft_tpu.distance.fused_l2_nn import fused_l2_nn_argmin as jnn
    from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_argmin as tnn

    rng = np.random.default_rng(3)
    x = rng.standard_normal((500, 24)).astype(np.float32)
    y = rng.standard_normal((40, 24)).astype(np.float32)
    for sqrt in (False, True):
        jd, ji = jnn(jnp.asarray(x), jnp.asarray(y), sqrt=sqrt)
        td, ti = tnn(_t(x), _t(y), sqrt=sqrt)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# IVF-PQ LUT scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pq_bits", [4, 5, 8])
def test_lut_scan_plain_matches_pallas(pq_bits, lut_dtype, metric):
    """The port's [B, P, 256] pair-ordered bins against the JAX kernel's
    [n_seg, seg, 256] table read at each pair's slot; lists of size 0, 1
    and L are probed."""
    c = scan_case(pq_bits)
    qv = c["q_rot"][np.clip(c["seg_q"], 0, c["q_rot"].shape[0] - 1)]
    jk, ji = pk.ivfpq_lut_scan_topk(
        jnp.asarray(c["seg_list"]), jnp.asarray(qv), jnp.asarray(c["packed"]),
        jnp.asarray(c["ids"]), jnp.asarray(c["norms"]),
        jnp.asarray(c["centers_rot"]), jnp.asarray(c["cb"]), metric,
        pq_bits=pq_bits, pq_dim=c["S"], L=c["L"], lut_dtype=lut_dtype,
        interpret=True)
    tk, ti = K.ivfpq_lut_scan_topk(
        *[_t(c[n]) for n in SCAN_OPERANDS], metric, pq_bits=pq_bits,
        pq_dim=c["S"], L=c["L"], lut_dtype=lut_dtype)
    B, n_probes = c["pair_seg"].shape
    assert tk.shape == (B, n_probes, 256) and ti.dtype == torch.int32
    assert set(c["list_sizes"][:3]) == {0, 1, c["L"]}
    cb_used = K.lut_codebook(_t(c["cb"]), lut_dtype).numpy()
    ref = scan_reference_keys(c, cb_used, metric)
    assert_bins_match(tk.numpy(), ti.numpy(), pair_rows(c, jk),
                      pair_rows(c, ji), ref, rtol=1e-4, atol=1e-3)
    empty = c["seg_list"][c["pair_seg"]] == 0   # pairs probing list 0
    assert empty.any() and np.isinf(tk.numpy()[empty]).all()
    assert (ti.numpy()[empty] == -1).all()


@pytest.mark.parametrize("B,n_probes,n_lists", [(40, 8, 16), (300, 5, 7),
                                                (3, 16, 64)])
def test_lut_slot_rows_invert_the_pair_addresses(B, n_probes, n_lists):
    """The LUT scan's slot → pair map: every pair's slot names that pair,
    pad slots name none, and a live slot's query is its pair's."""
    rng = np.random.default_rng(B)
    probes = np.stack([rng.choice(n_lists, n_probes, replace=False)
                       for _ in range(B)]).astype(np.int32)
    n_seg = tic.n_segments(B * n_probes, n_lists, 128)
    _, seg_q, ps, pl = tic.segment_probes(_t(probes), n_lists, 128, n_seg)
    rows = K.lut_slot_rows(ps, pl, n_seg, 128)
    assert rows.shape == (n_seg, 128) and rows.dtype == torch.int32
    pair = torch.arange(B * n_probes, dtype=torch.int32).view(B, n_probes)
    assert torch.equal(rows[ps.long(), pl.long()], pair)
    assert torch.equal(rows >= 0, seg_q >= 0)
    live = seg_q >= 0
    assert torch.equal(rows[live] // n_probes, seg_q[live])


def test_lut_scan_reads_no_row_past_the_list_size():
    """Rows at or past a list's size are pads whatever they hold: giving
    them valid ids changes nothing, and the bins equal those of the
    same lists with the rows' ids −1."""
    c = scan_case(5, seed=3)
    ops = [_t(c[n]) for n in SCAN_OPERANDS]
    kw = dict(pq_bits=5, pq_dim=c["S"], L=c["L"])
    tk, ti = K.ivfpq_lut_scan_topk(*ops, "l2", **kw)
    stale = c["ids"].copy()
    past = np.arange(c["L"])[None, :] >= c["list_sizes"][:, None]
    stale[past] = 7
    ops[SCAN_OPERANDS.index("ids")] = _t(stale)
    sk, si = K.ivfpq_lut_scan_topk(*ops, "l2", **kw)
    assert past.sum() > c["L"] and torch.equal(tk, sk) and torch.equal(ti, si)
    assert not (si.numpy() == 7).any()


@pytest.mark.parametrize("S", [32, 64, 96, 128])
def test_lut_rotated_lookup_order(S):
    """The rotated look-up of 8-bit codes (lut_scan_common.cuh:
    adc_words_rot), emulated in numpy: lane l rotates its row's code words
    by l // 4 words and funnel-shifts by 8·(l mod 4), so byte j of word k
    is subspace (4k + j + l) mod S; every lane visits each (subspace,
    code) of its row once, and at every step the 32 lanes' LUT words
    ([code][S]-major) lie in 32 distinct banks, whatever the codes."""
    assert K.lut_rotated(S, 8) and not K.lut_rotated(S, 6)
    rng = np.random.default_rng(S)
    W = S // 4
    codes = rng.integers(0, 256, (32, S)).astype(np.uint8)   # a row a lane
    words = codes.view("<u4").reshape(32, W).astype(np.uint64)
    banks = np.zeros((S, 32), np.int64)
    for l in range(32):
        q, sh = l >> 2, 8 * (l & 3)
        a = [words[l, (k + q) % W] for k in range(W)]
        seen = []
        for k in range(W):
            word = ((a[(k + 1) % W] << np.uint64(32)) | a[k]) >> np.uint64(sh)
            for j in range(4):
                s = (4 * k + j + l) % S
                code = int(word >> np.uint64(8 * j)) & 0xFF
                assert code == codes[l, s]
                seen.append(s)
                banks[4 * k + j, l] = (code * S + s) % 32
        assert sorted(seen) == list(range(S))
    assert all(len(set(row)) == 32 for row in banks)
    cb = torch.arange(S * 256 * 2, dtype=torch.float32).view(S, 256, 2)
    kcb = K.lut_kernel_codebook(cb, True)
    assert kcb.shape == (256, S, 2) and torch.equal(kcb[5, 3], cb[3, 5])
    assert K.lut_kernel_codebook(cb, True) is kcb       # made once
    cb[3, 5] += 1.0
    assert torch.equal(K.lut_kernel_codebook(cb, True)[5, 3], cb[3, 5])
    assert K.lut_kernel_codebook(cb, False) is cb


@pytest.mark.parametrize("pq_bits", [4, 5, 6, 7, 8])
def test_ring_scan_admission_keeps_every_shape(pq_bits):
    """The fused scan-in-ring kernel (one LUT a block since its query-major
    redesign) admits every shape the per-hop kernel before it admitted:
    wherever a LUT-scan block of ≤ 4 LUTs and 128·R threads held a chunk of
    mc ≤ 512 rows (``lut_scan_fit``), a local block of some warp count
    fits (``ring_lut_scan_fit``), at every k ≤ 64 and NS ≤ 512."""
    K_ = 1 << pq_bits
    n_old = 0
    for S in (8, 16, 24, 32, 48, 64, 96, 120, 128, 160, 200, 256):
        nb = (S * pq_bits + 7) // 8
        rotated = K.lut_rotated(S, pq_bits)
        for P in (1, 2, 4):
            rot = S * P
            for mc in (8, 64, 130, 512):
                if K.lut_scan_fit(S, K_, rot, mc, nb) is None:
                    continue
                n_old += 1
                for NS in (1, 256, 512):
                    for k in (1, 10, 64):
                        assert K.ring_lut_scan_fit(S, K_, rot, NS, nb, k,
                                                   rotated) is not None, (
                            S, P, mc, NS, k)
    assert n_old > 0


def test_lut_codebook_rounding_matches_jax():
    """The codebook operand's bf16 / fp8→bf16 rounding equals the JAX
    package's (ml_dtypes) on in-range values."""
    rng = np.random.default_rng(0)
    cb = (rng.standard_normal((8, 16, 4)) * 3).astype(np.float32)
    for lut_dtype, chain in (("bfloat16", [jnp.bfloat16]),
                             ("float8_e4m3", [jnp.float8_e4m3fn,
                                              jnp.bfloat16])):
        j = jnp.asarray(cb)
        for dt in chain:
            j = j.astype(dt)
        np.testing.assert_array_equal(
            K.lut_codebook(_t(cb), lut_dtype).numpy(),
            np.asarray(j.astype(jnp.float32)))


def test_lut_scan_rejects_folded_codes():
    c = scan_case(8, L=256)
    folded = c["packed"].reshape(16, 32, -1)  # not [n_lists, L, nb]
    ops = [_t(c[n]) for n in SCAN_OPERANDS]
    ops[SCAN_OPERANDS.index("packed")] = _t(folded)
    with pytest.raises(Exception, match="folded"):
        K.ivfpq_lut_scan_topk(*ops, "l2", pq_bits=8, pq_dim=c["S"], L=c["L"])


# ---------------------------------------------------------------------------
# gather-refine
# ---------------------------------------------------------------------------

# (k, metric, ties): every metric at k 10 and 64 on random rows (keys rtol
# 1e-5), and the same on small integer rows, whose keys are exact and tie
# often: there keys and ids are held equal bit for bit (the first-index tie
# rule of the TPU kernel's extraction merge against the stable sort)
_REFINE_CASES = [pytest.param(k, metric, ties,
                              id=f"{k}-{metric}" + ("-ties" if ties else ""))
                 for ties in (False, True) for k in (10, 64)
                 for metric in ("l2", "ip", "cos")]


@pytest.mark.parametrize("k,metric,ties", _REFINE_CASES)
def test_gather_refine_plain_matches_pallas(k, metric, ties):
    data, q, cand = refine_case(seed=k, ties=ties, d=16 if ties else 40)
    jk, ji = pk.gather_refine_topk(jnp.asarray(data), jnp.asarray(q),
                                   jnp.asarray(cand), k, metric,
                                   interpret=True)
    tk, ti = K.gather_refine_topk(_t(data), _t(q), _t(cand), k, metric)
    if ties:
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        # the case ties: many keys at each of the k best levels
        assert (np.diff(tk.numpy()[1:], axis=1) == 0).mean() > 0.1
    else:
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy()[0, 4:] == -1).all()


def test_fused_refine_rule_is_the_jax_rule(monkeypatch):
    """refine's fused-tier rule against pallas_gather_refine_wanted (as on
    a TPU) up to C 60,000: k within 64, C at least 256, and C at least 400
    or a gather of 1 GB. No C cap: the kernel keeps no [C] array."""
    from raft_tpu_torch.neighbors import refine as trefine

    monkeypatch.setattr(pk, "_on_tpu", lambda: True)
    monkeypatch.delenv("RAFT_TPU_PALLAS_REFINE", raising=False)
    cases = 0
    for d in (96, 128, 960):
        data = torch.zeros((16, d), dtype=torch.float32)
        for m in (1, 500, 12_000):
            q = torch.zeros((1, d)).expand(m, d)
            for C in (200, 256, 300, 400, 2000, 60_000):
                cand = torch.zeros((1, 1), dtype=torch.int32).expand(m, C)
                for k in (1, 10, 64, 65):
                    want = pk.pallas_gather_refine_wanted(m, C, d, k)
                    assert trefine._fused_refine_wanted(data, q, cand, k) == \
                        want, (m, C, d, k)
                    cases += want
    assert cases > 0


# ---------------------------------------------------------------------------
# the top-k selection of gather_refine.cu and grouped_scan.cu
# (csrc/select_common.cuh), replayed in numpy
# ---------------------------------------------------------------------------

_SENTINEL = (float("inf"), 2**31 - 1)


def _less(a, b) -> bool:
    return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])


class _LaneRun:
    """LaneRun: a warp's sorted run, slot j in lane j (and 32 + j when kk >
    32); a key goes in by shifting the slots after it down one, slots past
    kk keep what falls off the end."""

    def __init__(self, buf, kk):
        self.kk = kk
        self.slots = list(buf) + [_SENTINEL] * ((32 if kk <= 32 else 64) - kk)

    def insert(self, x):
        old = self.slots
        self.slots = [(old[s - 1] if s > 0 and _less(x, old[s - 1]) else x)
                      if _less(x, old[s]) else old[s] for s in range(len(old))]

    def last(self) -> float:
        return self.slots[self.kk - 1][0]

    def buffer(self):
        assert self.slots[:self.kk] == sorted(self.slots[:self.kk])
        return self.slots[:self.kk]


class _SharedTopK:
    """gather_refine.cu's shared buffer and threshold; ``read`` returns a
    stale threshold (any earlier value), as a warp may see it."""

    def __init__(self, kk, rng):
        self.kk, self.rng = kk, rng
        self.buf = [_SENTINEL] * kk
        self.history = [float("inf")]

    def read(self) -> float:
        return self.history[-1 - int(self.rng.integers(0, min(
            3, len(self.history))))]

    def flush(self, items):
        """warp_flush: the queue's entries not above the kk-th key go into
        the run one by one, in queue order."""
        assert len(items) <= 32
        run = _LaneRun(self.buf, self.kk)
        for x in [x for x in items if x[0] <= run.last()]:
            run.insert(x)
        self.buf = run.buffer()
        assert self.buf[-1][0] <= self.history[-1]   # it only falls
        self.history.append(self.buf[-1][0])


def _interleave(n_warps, n_steps, rng):
    """A schedule of (warp, step) in which each warp runs its steps in
    order and the warps drift apart at random."""
    left = [list(range(n_steps)) for _ in range(n_warps)]
    order = []
    while any(left):
        w = int(rng.choice([w for w in range(n_warps) if left[w]]))
        order.append((w, left[w].pop(0)))
    return order


def _model_gather_refine(keys, k, cap, rng):
    """gather_refine.cu: 4 warps take 16 candidates a step (warp w's steps
    at 16 w + 64 s); a candidate is offered when its key is finite and <=
    the (stale) threshold; a warp merges its queue of ``cap`` entries
    under the lock before a step's offers would overflow it, then filters
    them again; each warp merges what is left."""
    n_warps, step = 4, 16
    top = _SharedTopK(k, rng)
    queue = [[] for _ in range(n_warps)]
    n_steps = -(-len(keys) // (n_warps * step))
    for w, s in _interleave(n_warps, n_steps, rng):
        c0 = (s * n_warps + w) * step
        offer = [(float(keys[c]), c) for c in range(c0, min(c0 + step,
                                                            len(keys)))
                 if np.isfinite(keys[c])]
        t = top.read()
        passing = [e for e in offer if e[0] <= t]
        if passing and len(queue[w]) + len(passing) > cap:
            top.flush(queue[w])
            queue[w] = []
            t = top.history[-1]
            passing = [e for e in passing if e[0] <= t]
        queue[w] += passing
    for w in rng.permutation(n_warps):
        if queue[w]:
            top.flush(queue[w])
    return top.buf


def _model_grouped_scan(keys, kk):
    """grouped_scan.cu, one query, by the warp that owns it: each 128-row
    tile's keys (lane l holds rows l, l + 32, l + 64, l + 96) against the
    threshold, the buffer's kk-th key; in tile 0 the kk-th smallest of the
    32 lane minima bounds them (kk <= 32); the keys that pass go into the
    run in (row // 32, lane) order."""
    run = _LaneRun([_SENTINEL] * kk, kk)
    thr = float("inf")
    n_tiles = -(-len(keys) // 128)
    padded = np.full(n_tiles * 128, np.inf, dtype=np.float32)
    padded[:len(keys)] = keys
    for tile in range(n_tiles):
        v = padded[tile * 128:(tile + 1) * 128]
        b = thr
        if tile == 0 and kk <= 32:
            b = min(b, float(np.sort(v.reshape(4, 32).min(0))[kk - 1]))
        passing = [(float(v[r]), tile * 128 + r) for r in range(128)
                   if np.isfinite(v[r]) and v[r] <= b]
        if tile == 0:   # the bound keeps the tile's kk best
            best = sorted((float(v[r]), r) for r in range(128)
                          if np.isfinite(v[r]))
            assert set(best[:kk]) <= set(passing)
        for x in passing:
            run.insert(x)
        thr = run.last()
    return run.buffer()


def _tie_heavy_keys(kk, L, descending=False):
    rng = np.random.default_rng(kk * 10_000 + L)
    keys = rng.integers(-3, 9, L).astype(np.float32)
    keys[rng.random(L) < 0.1] = np.inf
    if descending:   # keys that fall along the list: each tile's pass
        keys = np.sort(keys)[::-1].copy()
    elif L > 300:    # a descending run: the threshold keeps falling
        keys[128:300] = np.arange(172, 0, -1) % 9 - 4
    return rng, keys


def _stable_topk(keys, kk):
    order = np.argsort(keys, kind="stable")[:kk]
    want = [(float(keys[p]), int(p)) if np.isfinite(keys[p]) else _SENTINEL
            for p in order]
    return want + [_SENTINEL] * (kk - len(want))


@pytest.mark.parametrize("cap", ["kernel", "smallest"])
@pytest.mark.parametrize("L", [77, 400, 1536, 4992])
@pytest.mark.parametrize("kk", [1, 10, 64])
def test_streamed_selection_model_is_a_stable_sort(kk, L, cap):
    """gather_refine.cu's order of offers, stale thresholds and queue
    flushes (at the kernel's queue of 32 and at the smallest it admits,
    16: one step of a warp) on integer keys with many ties and masked rows
    give the stable sort's top-k in (key, position) order."""
    rng, keys = _tie_heavy_keys(kk, L)
    got = _model_gather_refine(keys, kk, 32 if cap == "kernel" else 16, rng)
    assert got == _stable_topk(keys, kk)


@pytest.mark.parametrize("order", ["random", "descending"])
@pytest.mark.parametrize("L", [77, 400, 1536, 4992])
@pytest.mark.parametrize("kk", [1, 10, 64])
def test_tile_selection_model_is_a_stable_sort(kk, L, order):
    """grouped_scan.cu's tiles (the tile-0 bound, the owner's threshold,
    the shifting insert) on integer keys with many ties and masked rows,
    in random order and falling along the list (every tile's keys pass),
    give the stable sort's top-kk in (key, position) order."""
    _, keys = _tie_heavy_keys(kk, L, descending=order == "descending")
    assert _model_grouped_scan(keys, kk) == _stable_topk(keys, kk)


def test_segment_probes_matches_jax():
    rng = np.random.default_rng(4)
    for B, P, n_lists in ((40, 8, 16), (300, 5, 7), (3, 16, 64)):
        probes = np.stack([rng.choice(n_lists, P, replace=False)
                           for _ in range(B)]).astype(np.int32)
        n_seg = jic.n_segments(B * P, n_lists, 128)
        assert tic.n_segments(B * P, n_lists, 128) == n_seg
        j = jic.segment_probes(jnp.asarray(probes), n_lists, 128, n_seg)
        t = tic.segment_probes(_t(probes), n_lists, 128, n_seg)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# segmented and grouped list scans (IVF-Flat)
# ---------------------------------------------------------------------------

def _jax_scan_inputs(c):
    """The JAX kernels' operands: gathered per-segment queries (pad slots
    repeat query 0) and the list data in its own dtype."""
    qv = c["q"][np.clip(c["seg_q"], 0, None)]
    packed = jnp.asarray(c["packed"])
    if c["bf16"]:
        packed = packed.astype(jnp.bfloat16)
    return jnp.asarray(qv), packed


# every metric, L of {1408, 300 (not a multiple of 128), 96 (< 128)}, d of
# {16, 64}, both list dtypes — not their full product (interpret-mode cost)
SEGK_CASES = [("l2", 1408, 64, False), ("l2", 300, 16, True),
              ("l2", 96, 16, False), ("ip", 1408, 16, True),
              ("ip", 300, 64, False), ("ip", 96, 64, True),
              ("cos", 1408, 64, True), ("cos", 300, 16, False),
              ("cos", 96, 64, False)]


@pytest.mark.parametrize("metric,L,d,bf16", SEGK_CASES)
def test_segmented_scan_plain_matches_pallas(metric, L, d, bf16):
    c = flat_scan_case(L, d, bf16)
    qv, packed = _jax_scan_inputs(c)
    jk, ji = pk.segmented_scan_topk(jnp.asarray(c["seg_list"]), qv, packed,
                                    jnp.asarray(c["ids"]), metric,
                                    interpret=True)
    tk, ti = K.segmented_scan_topk(*flat_scan_operands(c), metric)
    assert tk.shape == jk.shape and ti.dtype == torch.int32
    assert_scan_match(tk.numpy(), ti.numpy(), np.asarray(jk), np.asarray(ji),
                      c, metric, "ids")


# (metric, kk, ties): every metric at kk 1, 10 and 64 on random rows, and
# l2 and ip on small integer rows (exact keys, tie-heavy), held to the JAX
# kernel bit for bit, ties to the lowest position
_GROUPED_CASES = [pytest.param(metric, kk, ties,
                               id=f"{metric}-{kk}" + ("-ties" if ties else ""))
                  for ties in (False, True) for metric in ("l2", "ip", "cos")
                  for kk in (1, 10, 64) if not (ties and metric == "cos")]


@pytest.mark.parametrize("metric,kk,ties", _GROUPED_CASES)
def test_grouped_scan_plain_matches_pallas(metric, kk, ties):
    L, d, bf16 = {1: (96, 16, False), 10: (300, 64, True),
                  64: (1408, 16, False)}[kk]
    c = flat_scan_case(L, 16 if ties else d, bf16, seed=kk, ties=ties)
    qv, packed = _jax_scan_inputs(c)
    G = c["seg_list"]
    mask = np.where(c["ids"] >= 0, 0.0, np.inf).astype(np.float32)[G]
    jk, jp = pk.grouped_scan_topk(qv, packed[G], jnp.asarray(mask), kk,
                                  metric, bq=qv.shape[1], interpret=True)
    tk, tp = K.grouped_scan_topk(*flat_scan_operands(c), kk, metric)
    assert tk.shape == jk.shape and tp.dtype == torch.int32
    if ties:
        live = c["seg_q"] >= 0
        np.testing.assert_array_equal(tk.numpy()[live], np.asarray(jk)[live])
        np.testing.assert_array_equal(tp.numpy()[live], np.asarray(jp)[live])
        if kk > 1:
            fin = np.isfinite(tk.numpy()[live])
            assert (np.diff(tk.numpy()[live], axis=1)[fin[:, 1:]]
                    == 0).mean() > 0.1
    assert_scan_match(tk.numpy(), tp.numpy(), np.asarray(jk), np.asarray(jp),
                      c, metric, "pos")


def test_scan_wrappers_check_their_operands():
    args = flat_scan_operands(flat_scan_case(96, 16))
    with pytest.raises(Exception, match="outside"):
        K.grouped_scan_topk(*args, 65)
    with pytest.raises(Exception, match="metric"):
        K.segmented_scan_topk(*args, "l1")
    with pytest.raises(Exception, match="float32 or bfloat16"):
        K.segmented_scan_topk(*args[:3], args[3].double(), args[4])


def _scan_keys_split(q, x, metric: str, products: int):
    """The scan kernels' keys as the card computes them (csrc/
    scan_common.cuh), emulated: ⟨q, x⟩ per 32-deep k slice as the split
    products q_lo·x_hi + q_hi·x_lo + q_hi·x_hi (``products`` 3; 2 drops
    q_hi·x_lo, exact for bf16 x; 1 is q_hi·x_hi alone), each slice's sum in
    f32 then added to the running f32 dot; ‖q‖², ‖x‖² f32 sums; the key of
    scan_key. q [m, d], x [n, d] f32 → [m, n]."""
    qh, xh = _tf32(q), _tf32(x)
    ql, xl = _tf32(q - qh), _tf32(x - xh)
    dot = torch.zeros((q.shape[0], x.shape[0]))
    for a in range(0, q.shape[1], K.SCAN_K_SLICE):
        s = slice(a, a + K.SCAN_K_SLICE)
        part = qh[:, s] @ xh[:, s].T
        if products >= 2:
            part = ql[:, s] @ xh[:, s].T + part
        if products == 3:
            part = qh[:, s] @ xl[:, s].T + part
        dot = dot + part
    if metric == "ip":
        return -dot
    qsq, xsq = (q * q).sum(1)[:, None], (x * x).sum(1)[None, :]
    if metric == "cos":
        return 1.0 - dot * torch.rsqrt(qsq.clamp_min(1e-30)) * torch.rsqrt(
            xsq.clamp_min(1e-30))
    return (qsq + xsq - 2.0 * dot).clamp_min(0.0)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", [16, 96, 100, 128, 960])
def test_scan_3xtf32_keeps_the_tolerance(d, bf16, metric):
    """B5/B6's numerics, emulated on the CPU: keys from 3xTF32 split
    products (2 for bf16 lists, whose rows are exact in TF32) in fresh
    32-deep slices stay within the card test's 1e-4 + 1e-5·(|key| + ‖q‖²)
    of the f64 keys, at every d of the card tests' FLAT_CASES (100 is not a
    multiple of 8; the last slice is zero-filled) — on flat-case rows and on
    SIFT-scaled rows (uniform in [0, 128)); one TF32 product does not keep
    it on the l2 keys of wide rows."""
    rng = np.random.default_rng(d + 7 * bf16)
    for scale, shift in ((1.0, 0.0), (64.0, 64.0)):
        q = (rng.standard_normal((32, d)) * scale + shift).astype(np.float32)
        x = (rng.standard_normal((256, d)) * scale + shift).astype(np.float32)
        if shift:
            q, x = np.abs(q), np.abs(x)
        qt, xt = torch.tensor(q), torch.tensor(x)
        if bf16:
            xt = xt.to(torch.bfloat16).float()
            assert torch.equal(_tf32(xt), xt)       # x_lo = 0
        q64, x64 = qt.double(), xt.double()
        dot64 = q64 @ x64.T
        qsq64, xsq64 = (q64 * q64).sum(1)[:, None], (x64 * x64).sum(1)[None]
        ref = {"ip": -dot64,
               "l2": (qsq64 + xsq64 - 2.0 * dot64).clamp_min(0.0),
               "cos": 1.0 - dot64 / (qsq64.sqrt() * xsq64.sqrt())}[metric]
        tol = 1e-4 + 1e-5 * (ref.abs() + qsq64)
        got = _scan_keys_split(qt, xt, metric, 2 if bf16 else 3).double()
        assert bool(((got - ref).abs() <= tol).all()), float(
            ((got - ref).abs() / tol).max())
        if metric == "l2" and d >= 96:
            one = _scan_keys_split(qt, xt, metric, 1).double()
            assert bool(((one - ref).abs() > tol).any())


def test_scan_fragment_ownership():
    """B5's bins in registers (csrc/scan_common.cuh), modelled in numpy:
    thread (warp w, lane 4g + t) holds accumulator c of fragment (i, j) of
    mma.sync m16n8k8 (rows = queries, columns = list rows), i.e. query 16i
    + g + 8(c // 2) against tile row 16w + 8j + 2t + c % 2. Every (query,
    bin) of a block's 32 x 128 has exactly one owner; the owner depends on
    the tile row alone, and tile row r of every 128-row tile is strided bin
    r, so it is the same owner in every tile and the positions it sees
    rise; the quad sum of |x|^2 over B-fragment row 16w + 8j + g reaches
    the lanes whose columns hold that row by a shuffle from lane 4g; an
    output pair (c, c + 1) is two adjacent columns (one 8-byte store)."""
    n_q, n_rows = K.SCAN_QUERIES, K.LUT_SCAN_LANES
    owner = -np.ones((n_q, n_rows), np.int64)
    for w in range(K.SCAN_WARPS):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for i in range(n_q // 16):
                for j in range(n_rows // (8 * K.SCAN_WARPS)):
                    for c in range(4):
                        qi = 16 * i + g + 8 * (c >> 1)
                        row = 16 * w + 8 * j + 2 * t + (c & 1)
                        assert owner[qi, row] == -1
                        owner[qi, row] = (w * 32 + lane) * 16 + (i * 2 + j) * 4 + c
                        # |x|^2 of this column comes from lane (2t + c%2) << 2,
                        # whose B-fragment row g' = 2t + c%2 is this row
                        src = (2 * t + (c & 1)) << 2
                        assert 16 * w + 8 * j + (src >> 2) == row
                        if c & 1:
                            left = owner[qi, row - 1]
                            assert left == owner[qi, row] - 1   # same thread
    assert (owner >= 0).all()
    L = 1000
    pos = np.arange(L)
    for qi in (0, 7, 31):
        for b in (0, 77, 127):
            seen = pos[pos % n_rows == b]
            holders = {owner[qi, p % n_rows] for p in seen}
            assert len(holders) == 1 and (np.diff(seen) > 0).all()


@pytest.mark.parametrize("k,n_probes", [(10, 3), (300, 1)])
@pytest.mark.parametrize("select_min", [True, False])
def test_merge_bin_results_matches_jax(k, n_probes, select_min):
    """The per-pair bin merge, including k > n_probes·kk (padding). Keys
    come from a scan of random data, so they hold no exact ties: the JAX
    package's per-slot ``lax.approx_min_k`` orders tied keys as it likes
    on the CPU, the port by the lowest bin."""
    c = flat_scan_case(300, 16, seed=3, n_probes=n_probes)
    B = c["q"].shape[0]
    probes = np.stack([np.random.default_rng(b).choice(6, n_probes,
                                                       replace=False)
                       for b in range(B)]).astype(np.int32)
    n_seg = tic.n_segments(B * n_probes, 6, 16)
    sl, sq, ps, pl = tic.segment_probes(torch.tensor(probes), 6, 16, n_seg)
    c.update(seg_list=sl.numpy(), seg_q=sq.numpy())
    keys, kids = K.segmented_scan_topk(*flat_scan_operands(c),
                                       "l2" if select_min else "ip")
    invalid = float("inf") if select_min else float("-inf")
    jv, ji = jic.merge_bin_results(jnp.asarray(keys.numpy()),
                                   jnp.asarray(kids.numpy()),
                                   jnp.asarray(ps.numpy()),
                                   jnp.asarray(pl.numpy()), k, select_min,
                                   invalid, 0.95)
    tv, ti = tic.merge_bin_results(keys, kids, ps, pl, k, select_min,
                                   invalid)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if k > n_probes * 256:
        assert (ti.numpy()[:, n_probes * 256:] == -1).all()
