"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card: the kernels
build and run only there. The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch and the CUDA
toolkit::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: select_k exact (values bit for bit); fused_l2_argmin distances
rtol 1e-5, atol 1e-4 (the first case) or within 1e-4 + 1e-5·(‖x‖² + ‖y‖²)
with differing argmins tied in f64 (the smoke's check); LUT scan keys rtol 1e-4, atol 1e-3 with ids equal
away from key ties; gather-refine keys rtol 1e-5 with ids equal away from
key ties; segmented and grouped scans keys within 1e-4 + 1e-5·(|key| +
‖q‖²) (the expanded l2 form cancels ‖q‖² + ‖x‖²), the same finite/infinite
pattern, ids or positions equal away from key ties, sentinels on pad slots;
gather-refine and the grouped scan on small integer rows (exact keys, many
ties) keys and ids or positions bit for bit;
the ring merge exact (values and ids, ties included); the fused
scan-in-ring keys rtol 1e-4, atol 1e-3 with ids equal away from key ties
(the f64 key of the kernel's pick within that tolerance of the plain key),
and on integer-valued cases (exact keys, many ties) keys and ids equal.
The filtered kernels keep their unfiltered tolerances, and an all-ones
filter gives the unfiltered kernel's output bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu_torch.ops import kernels as K

from torch_parity import (FILTER_KINDS, SCAN_OPERANDS, assert_bins_match,
                          assert_scan_match, blobs, cuda_device,
                          filter_keep, flat_scan_case,
                          flat_scan_operands, refine_case, ring_scan_case,
                          ring_scan_key64, ring_scan_ops, ring_tables,
                          scan_case, scan_reference_keys, tied_scores)

pytestmark = pytest.mark.cuda


def test_cuda_select_k_matches_plain():
    dev = cuda_device()
    s = torch.tensor(tied_scores(64, 9000, seed=5)).to(dev)
    for k in (1, 33, 64):
        for select_min in (True, False):
            v, i = K.select_k_cuda(s, k, select_min)
            pv, pi = K.select_k_plain(s, k, select_min)
            assert torch.equal(v, pv) and torch.equal(i, pi)


def _select_rows(m: int, n: int, seed: int) -> np.ndarray:
    """Tie-heavy rows, then a row of +inf, one mixing −inf and +inf, one of
    signed zeros (−0.0 ties +0.0: position decides) and one mixing ±inf
    into finite ties."""
    s = tied_scores(m, n, seed)
    rng = np.random.default_rng(seed)
    s[0] = np.inf
    s[1] = np.where(rng.random(n) < 0.5, -np.inf, np.inf)
    s[2] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    s[3, rng.random(n) < 0.3] = np.inf
    s[3, rng.random(n) < 0.1] = -np.inf
    return s


@pytest.mark.parametrize("n", [20, 256, 320, 1024, 8192, 100_003])
def test_cuda_select_k_rows_bit_equal_plain(n):
    """Both variants (a warp per row up to 1024, a block with a radix
    select beyond), at k 1 to 64 and both select modes: positions equal
    to the stable sort's and values equal bit for bit, on aligned rows
    and (short rows) on rows whose base is not 16-byte aligned."""
    dev = cuda_device()
    m = 40 if n < 100_000 else 9
    s = torch.tensor(_select_rows(m, n, seed=n)).to(dev)
    cases = [s]
    if n <= K.SELECT_K_SHORT_MAX:
        buf = torch.empty(m * n + 1, dtype=torch.float32, device=dev)
        buf[1:] = s.flatten()
        cases.append(buf[1:].view(m, n))
        assert K.select_k_plan(n, cases[1].data_ptr() % 16 == 0)[0] == 1
    for x in cases:
        for k in (1, 10, 16, 33, 64):
            if k > n:
                continue
            for select_min in (True, False):
                v, i = K.select_k_cuda(x, k, select_min)
                pv, pi = K.select_k_plain(x, k, select_min)
                assert torch.equal(i, pi), (k, select_min)
                assert torch.equal(v.view(torch.int32),
                                   pv.view(torch.int32)), (k, select_min)


# (rows, len, k, +inf share): the IVF-Flat path's short rows — bin rows of
# 256 that are mostly +inf, a merge's [B, P·kk] rows, predict_topk's Gram
# rows — and short rows at k up to 64 (the kernel wrapper itself)
SHORT_ROWS = [(5000, 256, 10, 0.7), (700, 256, 64, 0.9), (37, 320, 10, 0.1),
              (300, 1024, 6, 0.0), (1, 1024, 16, 0.0), (300, 1024, 64, 0.0),
              (9, 64, 64, 0.5)]


@pytest.mark.parametrize("m,n,k,inf_share", SHORT_ROWS)
def test_cuda_select_k_short_rows_match_plain(m, n, k, inf_share):
    """The kernel on short rows gives the stable sort's values and
    positions, +inf ties included; matrix.select_k launches it there at
    every k ≤ 64."""
    from raft_tpu_torch.matrix.select_k import select_k

    dev = cuda_device()
    s = tied_scores(m, n, seed=n + k)
    s[np.random.default_rng(k).random((m, n)) < inf_share] = np.inf
    s = torch.tensor(s).to(dev)
    for select_min in (True, False):
        v, i = K.select_k_cuda(s, k, select_min)
        pv, pi = K.select_k_plain(s, k, select_min)
        assert torch.equal(v, pv) and torch.equal(i, pi)
        K.reset_launch_counts()
        v, i = select_k(s, k, select_min)
        assert K.launch_counts()["select_k"] == 1
        assert torch.equal(v, pv) and torch.equal(i, pi)


def _check_argmin(x, y):
    """fused_l2_argmin on the card against its plain version (both on the
    card): distances within 1e-4 + 1e-5·(‖x‖² + ‖y‖²), and a differing
    argmin's f64 distance ties the minimum within that tolerance (the
    smoke's check). Returns the kernel's (distances, argmins)."""
    d, i = K.fused_l2_argmin(x, y)
    pd, pi = K.fused_l2_argmin_plain(x, y)
    xsq, ysq = (x * x).sum(1), (y * y).sum(1)
    tol = 1e-4 + 1e-5 * (xsq + ysq[pi.long()])
    assert bool(((d - pd).abs() <= tol).all()), float((d - pd).abs().max())
    bad = i != pi
    if bool(bad.any()):
        xb, yb = x[bad].double(), y[i[bad].long()].double()
        d64 = ((xb - yb) ** 2).sum(1)
        assert bool(((d64 - pd[bad].double()).abs()
                     <= 1e-4 + 1e-5 * (xsq[bad] + (yb * yb).sum(1))
                     .double()).all())
    return d, i


def test_cuda_fused_l2_argmin_matches_plain():
    dev = cuda_device()
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((5000, 96)).astype(np.float32))
    y = torch.tensor(rng.standard_normal((700, 96)).astype(np.float32))
    y[9] = y[4]
    x[:3] = y[4]
    d, i = K.fused_l2_argmin(x.to(dev), y.to(dev))
    pd, pi = K.fused_l2_argmin_plain(x, y)
    torch.testing.assert_close(d.cpu(), pd, rtol=1e-5, atol=1e-4)
    assert (i.cpu()[:3] == 4).all()
    d2 = torch.cdist(x.double(), y.double()) ** 2
    best2 = d2.topk(2, largest=False).values
    close = best2[:, 1] - best2[:, 0] <= 1e-5 * best2[:, 1]
    assert bool(((i.cpu() == pi) | close).all())


# (m, n, d): d 24 / 96 / 100 / 128 (k padded to 32 with zeros), m ragged to
# the 128-row tile, n = 1, n not a multiple of 8 or of the 128-row y tile,
# the widest d of the resident x tile (256), and wider d whose x slices
# stream through the ring (1237: not a multiple of 4, so rows are not
# 16-byte aligned)
ARGMIN_SHAPES = [(1000, 1, 24), (5001, 700, 96), (333, 1027, 100),
                 (4097, 129, 128), (130, 13, 24), (777, 300, 256),
                 (300, 200, 544), (100, 150, 1152), (1000, 300, 1216),
                 (130, 1000, 1237), (257, 129, 1536), (300, 200, 2048)]


@pytest.mark.parametrize("m,n,d", ARGMIN_SHAPES)
def test_cuda_fused_l2_argmin_shapes(m, n, d):
    """3xTF32 on the tensor cores against the plain f32 version at ragged
    shapes, with duplicated y rows (the first index wins) and x rows on
    them."""
    dev = cuda_device()
    rng = np.random.default_rng(m + n + d)
    y = rng.uniform(0, 10, (n, d)).astype(np.float32)
    x = (y[rng.integers(0, n, m)] + 0.5 * rng.standard_normal((m, d))
         ).astype(np.float32)
    if n > 5:
        y[n - 1] = y[2]
        x[:4] = y[2]
    K.reset_launch_counts()
    d_, i = _check_argmin(torch.tensor(x).to(dev), torch.tensor(y).to(dev))
    assert K.launch_counts()["fused_l2_argmin"] == 1
    assert d_.shape == (m,) and i.dtype == torch.int32
    if n > 5:
        assert (i[:4].cpu() == 2).all()


@pytest.mark.parametrize("d", [96, 128])
def test_cuda_fused_l2_argmin_path_shapes(d):
    """The IVF-PQ build's assignment (96) and a sharded rank's Lloyd sweep
    (128), cut to 1M rows: DEEP-shaped rows around 8192 centers in
    [0, 10)^d, as chip_smoke.py's data."""
    from raft_tpu_torch.bench.dataset import DeviceSynthetic

    dev = cuda_device()
    ds = DeviceSynthetic(1_000_000, d, n_centers=10_000, seed=d, std=0.5,
                         scale=10.0, device=dev)
    x = ds.base()
    _check_argmin(x, x[::122][:8192].contiguous())


def _lut_ops(c, dev):
    return [torch.tensor(c[n]).to(dev) for n in SCAN_OPERANDS]


@pytest.mark.parametrize("S", [16, 64])
@pytest.mark.parametrize("pq_bits", [4, 5, 6, 8])
@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16"])
def test_cuda_lut_scan_matches_plain(pq_bits, lut_dtype, S):
    """The kernel's [B, P, 256] pair rows against the plain version's,
    lists of size 0, 1 and L and shorter than a tile, empty trailing
    segments; S 64 with 8-bit codes takes the rotated look-up."""
    dev = cuda_device()
    c = scan_case(pq_bits, S=S)
    args = _lut_ops(c, dev)
    cb_used = K.lut_codebook(args[-1], lut_dtype)
    for metric in ("l2", "ip"):
        K.reset_launch_counts()
        tk, ti = K.ivfpq_lut_scan_topk(*args, metric, pq_bits=pq_bits,
                                       pq_dim=c["S"], L=c["L"],
                                       lut_dtype=lut_dtype)
        assert K.launch_counts()["ivfpq_lut_scan_topk"] == 1
        pk, pi = K.ivfpq_lut_scan_topk_plain(
            *[args[SCAN_OPERANDS.index(n)] for n in
              ("seg_list", "pair_seg", "q_rot", "packed", "ids", "norms",
               "list_sizes", "centers_rot")], cb_used, metric, pq_bits)
        assert tk.shape == pk.shape == (*c["pair_seg"].shape, 256)
        ref = scan_reference_keys(c, cb_used.cpu().numpy(), metric)
        assert_bins_match(tk.cpu().numpy(), ti.cpu().numpy(),
                          pk.cpu().numpy(), pi.cpu().numpy(), ref, rtol=1e-4,
                          atol=1e-3)


@pytest.mark.parametrize("S", [16, 64])
def test_cuda_lut_scan_reads_no_row_past_the_list_size(S):
    """Valid ids past a list's size change nothing on the card either."""
    dev = cuda_device()
    c = scan_case(8, seed=5, S=S)
    kw = dict(pq_bits=8, pq_dim=c["S"], L=c["L"])
    tk, ti = K.ivfpq_lut_scan_topk(*_lut_ops(c, dev), "l2", **kw)
    c["ids"][np.arange(c["L"])[None, :] >= c["list_sizes"][:, None]] = 7
    sk, si = K.ivfpq_lut_scan_topk(*_lut_ops(c, dev), "l2", **kw)
    assert torch.equal(tk, sk) and torch.equal(ti, si)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
@pytest.mark.parametrize("k", [10, 64])
def test_cuda_gather_refine_matches_plain(metric, k):
    dev = cuda_device()
    data, q, cand = (torch.tensor(a).to(dev)
                     for a in refine_case(seed=1, C=400))
    v, i = K.gather_refine_topk(data, q, cand, k, metric)
    pv, pi = K.gather_refine_topk_plain(data, q, cand, k, metric)
    torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)
    tol = 1e-5 * (1.0 + pv.abs())
    gap = (pv[:, 1:] - pv[:, :-1]).abs() <= tol[:, 1:]
    tie = torch.zeros_like(pv, dtype=torch.bool)
    tie[:, 1:] |= gap
    tie[:, :-1] |= gap
    tie[:, -1] = True
    assert bool(((i == pi) | tie).all())
    assert bool((i[0, 4:] == -1).all())


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# (m, C, d, k): every m of {1, 7, 500}, C of {256, 400, 2000, 60,000}, d of
# {16, 37, 96, 128, 960} and k of {1, 10, 64}, not their product (the plain
# version gathers [m, C, d]); d 37 takes 4-byte loads, the others 16-byte
REFINE_SHAPES = [(1, 256, 16, 1), (7, 400, 37, 10), (500, 400, 96, 10),
                 (500, 400, 128, 64), (7, 2000, 960, 64), (1, 60_000, 37, 10),
                 (7, 60_000, 96, 64), (500, 256, 16, 1), (500, 2000, 128, 10),
                 (7, 256, 960, 1), (1, 2000, 96, 64), (500, 400, 37, 1),
                 (1, 60_000, 128, 1), (7, 400, 16, 64)]


@pytest.mark.parametrize("m,C,d,k", REFINE_SHAPES)
def test_cuda_gather_refine_shapes(m, C, d, k):
    """Any C (the kernel keeps no [C] array), invalid and out-of-range ids
    (refine_case), every metric: on random rows keys rtol 1e-5 and ids
    equal away from key ties; on small integer rows (exact keys, many
    ties) keys and ids bit for bit."""
    dev = cuda_device()
    for ties in (False, True):
        data, q, cand = (torch.tensor(a).to(dev) for a in refine_case(
            seed=m + C + d + k, m=m, C=C, n=20_000, d=d, ties=ties))
        for metric in ("l2", "ip", "cos"):
            v, i = K.gather_refine_topk(data, q, cand, k, metric)
            pv, pi = K.gather_refine_topk_plain(data, q, cand, k, metric)
            assert v.shape == (m, k) and i.dtype == torch.int32
            if ties:
                assert torch.equal(_bits(v), _bits(pv)), (metric, ties)
                assert torch.equal(i, pi), (metric, ties)
                continue
            torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)
            tol = 1e-5 * (1.0 + pv.abs())
            gap = (pv[:, 1:] - pv[:, :-1]).abs() <= tol[:, 1:]
            tie = torch.zeros_like(pv, dtype=torch.bool)
            tie[:, 1:] |= gap
            tie[:, :-1] |= gap
            tie[:, -1] = True
            assert bool(((i == pi) | tie).all()), metric
            assert bool((i[0, 4:] == -1).all())


# (d, L, bf16 list data): every d of {16, 96, 128, 960} and L of {96, 300,
# 1536}, both list dtypes; each case holds empty trailing segments. d 100
# and 37 are not multiples of 8: their rows take 8- and 4-byte copies, and
# bf16 rows of 37 (74 bytes) plain loads; L 77 is one partial tile
FLAT_CASES = [(16, 96, False), (96, 300, True), (128, 1536, False),
              (960, 300, False), (960, 1536, True), (128, 96, True),
              (100, 77, True), (37, 300, False), (37, 77, True)]


@pytest.mark.parametrize("d,L,bf16", FLAT_CASES)
def test_cuda_segmented_scan_matches_plain(d, L, bf16):
    dev = cuda_device()
    c = flat_scan_case(L, d, bf16)
    args = flat_scan_operands(c, dev)
    for metric in ("l2", "ip", "cos"):
        tk, ti = K.segmented_scan_topk(*args, metric)
        pk, pi = K.segmented_scan_topk_plain(*args, metric)
        assert tk.shape == (len(c["seg_list"]), c["seg_q"].shape[1], 256)
        assert_scan_match(tk.cpu(), ti.cpu(), pk.cpu(), pi.cpu(), c, metric,
                          "ids", rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d,L,bf16", FLAT_CASES)
def test_cuda_grouped_scan_matches_plain(d, L, bf16):
    dev = cuda_device()
    c = flat_scan_case(L, d, bf16, seed=1)
    args = flat_scan_operands(c, dev)
    for metric in ("l2", "ip", "cos"):
        for kk in (1, 10, 64):
            tk, tp = K.grouped_scan_topk(*args, kk, metric)
            pk, pp = K.grouped_scan_topk_plain(*args, kk, metric)
            assert tk.shape == (len(c["seg_list"]), c["seg_q"].shape[1], kk)
            assert_scan_match(tk.cpu(), tp.cpu(), pk.cpu(), pp.cpu(), c,
                              metric, "pos", rtol=1e-5, atol=1e-4)


# (d, L, bf16): integer rows whose keys are exact on both sides (the
# 3xTF32 split of a small integer is exact): L 1536 and 4992 walk 12 and 39
# tiles, so at kk 64 the queues fill and merge many times
FLAT_INT_CASES = [(16, 1536, False), (128, 1536, True), (37, 300, False),
                  (96, 4992, False), (128, 77, False)]


@pytest.mark.parametrize("d,L,bf16", FLAT_INT_CASES)
def test_cuda_grouped_scan_integer_keys_bit_for_bit(d, L, bf16):
    dev = cuda_device()
    c = flat_scan_case(L, d, bf16, seed=3, ties=True)
    args = flat_scan_operands(c, dev)
    for metric in ("l2", "ip"):
        for kk in (1, 10, 64):
            tk, tp = K.grouped_scan_topk(*args, kk, metric)
            pk, pp = K.grouped_scan_topk_plain(*args, kk, metric)
            assert torch.equal(_bits(tk), _bits(pk)), (metric, kk)
            assert torch.equal(tp, pp), (metric, kk)


def test_cuda_launch_counts_move():
    dev = cuda_device()
    K.reset_launch_counts()
    s = torch.tensor(tied_scores(4, 9000, seed=1)).to(dev)
    K.select_k_cuda(s, 8)
    K.fused_l2_argmin(s[:, :64].contiguous(), s[:2, :64].contiguous())
    args = flat_scan_operands(flat_scan_case(96, 16), dev)
    K.segmented_scan_topk(*args)
    K.grouped_scan_topk(*args, 10)
    counts = K.launch_counts()
    assert counts["select_k"] == 1 and counts["fused_l2_argmin"] == 1
    assert counts["segmented_scan_topk"] == 1
    assert counts["grouped_scan_topk"] == 1


def _ring_devices(n: int):
    """n ranks on one card."""
    cuda_device()
    return [torch.device("cuda", torch.cuda.current_device())] * n


def _check_ring_topk(devices, m, k, select_min, variant, seed):
    n = len(devices)
    vals, ids = ring_tables(n, m, k, seed, select_min, variant)
    K.reset_launch_counts()
    tv, ti = K.ring_topk_merge([torch.tensor(vals[r]).to(d)
                                for r, d in enumerate(devices)],
                               [torch.tensor(ids[r]).to(d)
                                for r, d in enumerate(devices)],
                               k, select_min)
    # one launch per call, whatever the rank count
    assert K.launch_counts()["ring_topk_merge"] == 1
    pv, pi = K.ring_topk_merge([torch.tensor(v) for v in vals],
                               [torch.tensor(i) for i in ids], k, select_min)
    mc = K.ring_chunk_rows(m, n)
    for r in range(n):
        assert tv[r].device == devices[r] and tv[r].shape == (mc, k)
        assert torch.equal(tv[r].cpu(), pv[r]) and torch.equal(ti[r].cpu(),
                                                               pi[r])


# (m, k, select_min, variant): ragged m, k 1/10/64, max-select, ties,
# duplicate ids, empty ranks
RING_CASES = [(27, 1, True, "plain"), (500, 10, True, "ties"),
              (77, 64, False, "sentinels"), (9, 10, False, "ties"),
              (130, 64, True, "dup"), (8, 10, True, "sentinels")]


@pytest.mark.parametrize("n", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("m,k,select_min,variant", RING_CASES)
def test_cuda_ring_topk_merge_matches_plain(m, k, select_min, variant, n):
    """n ranks sharing one card: values and ids equal to the plain ring
    schedule, ties included, in one launch."""
    _check_ring_topk(_ring_devices(n), m, k, select_min, variant,
                     seed=m + k + n)


def test_cuda_ring_topk_merge_narrows_other_types():
    """f64 keys and int64 ids are narrowed to the kernel's f32 / int32, as
    the plain version narrows them; wider rows (kin 150 > k) merge in
    batches of 64."""
    devices = _ring_devices(4)
    vals, ids = ring_tables(4, 61, 150, 9, True, "ties")
    tv, ti = K.ring_topk_merge(
        [torch.tensor(v, dtype=torch.float64).to(d)
         for v, d in zip(vals, devices)],
        [torch.tensor(i, dtype=torch.int64).to(d)
         for i, d in zip(ids, devices)], 10)
    pv, pi = K.ring_topk_merge([torch.tensor(v) for v in vals],
                               [torch.tensor(i) for i in ids], 10)
    for r in range(4):
        assert torch.equal(tv[r].cpu(), pv[r]) and torch.equal(ti[r].cpu(),
                                                               pi[r])


def _check_ring_scan(devices, pq_bits, k, metric, lut_dtype, seed, S=16,
                     ties=False):
    n = len(devices)
    c = ring_scan_case(pq_bits, n_dev=n, seed=seed, S=S, ties=ties)
    kw = dict(pq_bits=pq_bits, pq_dim=c["S"], L=c["L"], lut_dtype=lut_dtype)
    K.reset_launch_counts()
    tk, ti = K.ring_lut_scan_merge(*ring_scan_ops(c, devices), k, metric, **kw)
    # the local top-ks, then the chains: two launches whatever the ranks
    assert K.launch_counts()["ring_lut_scan_merge"] == 2
    pk, pi = K.ring_lut_scan_merge(*ring_scan_ops(c, ["cpu"] * n), k, metric,
                                   **kw)
    cb_used = K.lut_codebook(torch.tensor(c["cb"]), lut_dtype).numpy()
    for r in range(n):
        a, b = tk[r].cpu().numpy(), pk[r].numpy()
        ia, ib = ti[r].cpu().numpy(), pi[r].numpy()
        if ties:   # keys exact in f32: the tie order is held bit for bit
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ia, ib)
            continue
        assert (np.isinf(a) == np.isinf(b)).all()
        assert (ia[np.isinf(a)] == -1).all()
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-4, atol=1e-3)
        for row, j in zip(*np.nonzero((ia != ib) & fin)):
            k64 = ring_scan_key64(c, cb_used, metric, r, row, ia[row, j])
            assert abs(k64 - b[row, j]) <= 1e-3 + 1e-4 * abs(b[row, j]), (
                r, row, j)
    assert sum(int((i >= 0).sum()) for i in pi) > 0


# (pq_bits, k, metric, lut_dtype, S, ties): S 64 and 32 with 8-bit codes
# take the rotated look-up; ties: integer keys, many tied (exact compare)
RING_SCAN_CASES = [(8, 10, "l2", "float32", 16, False),
                   (4, 1, "ip", "float32", 16, False),
                   (8, 64, "l2", "bfloat16", 16, False),
                   (5, 10, "ip", "bfloat16", 16, False),
                   (6, 64, "l2", "float32", 16, False),
                   (8, 10, "l2", "bfloat16", 64, False),
                   (8, 10, "ip", "float32", 32, False),
                   (8, 10, "l2", "float32", 64, True),
                   (5, 64, "ip", "float32", 16, True)]


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("pq_bits,k,metric,lut_dtype,S,ties", RING_SCAN_CASES)
def test_cuda_ring_lut_scan_matches_plain(pq_bits, k, metric, lut_dtype, S,
                                          ties, n):
    """The fused scan-in-ring kernel, n ranks on one card, against its
    plain version (the LUT scan's plain version per chunk, then the plain
    ring), each list walked to its size; on integer keys bit for bit, tie
    order included."""
    _check_ring_scan(_ring_devices(n), pq_bits, k, metric, lut_dtype,
                     seed=k + n, S=S, ties=ties)


def test_cuda_ring_kernels_over_peer_pointers():
    """Ranks alternating over two cards: both ring kernels raise, naming
    ROADMAP A15 (their peer-pointer reads are not shown right yet), and
    launch nothing (skips unless two cards are visible)."""
    cuda_device()
    if torch.cuda.device_count() < 2:
        pytest.skip("ranks on several cards need two cards")
    devices = [torch.device("cuda", r % 2) for r in range(4)]
    vals, ids = ring_tables(4, 77, 10, 3, True, "ties")
    c = ring_scan_case(8, n_dev=4, seed=3)
    K.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="A15"):
        K.ring_topk_merge([torch.tensor(v).to(d)
                           for v, d in zip(vals, devices)],
                          [torch.tensor(i).to(d)
                           for i, d in zip(ids, devices)], 10)
    with pytest.raises(NotImplementedError, match="A15"):
        K.ring_lut_scan_merge(*ring_scan_ops(c, devices), 10, "l2",
                              pq_bits=8, pq_dim=c["S"], L=c["L"])
    counts = K.launch_counts()
    assert counts["ring_topk_merge"] == counts["ring_lut_scan_merge"] == 0


def test_cuda_ring_scan_smem_formula_matches_the_kernel():
    """ops.kernels.ring_lut_scan_smem_bytes (the fused tier's admission
    rule) is the kernel's own shared-memory formula."""
    from raft_tpu_torch.ops.build import LIBRARIES

    cuda_device()
    lib = LIBRARIES.get("ring_lut_scan")
    for W in K.RING_SCAN_WARPS:
        for S, Kb, rot, NS, nb, k in ((64, 256, 128, 512, 64, 10),
                                      (16, 16, 32, 130, 8, 64),
                                      (96, 32, 96, 7, 60, 1)):
            for rotated in (False, True):
                want = K.ring_lut_scan_smem_bytes(W, S, Kb, rot, NS, nb, k,
                                                  rotated)
                assert lib.rtt_ring_lut_scan_smem_bytes(
                    W, S, Kb, rot, NS, nb, k, int(rotated)) == want


def test_cuda_lut_scan_smem_formula_matches_the_kernel():
    """ops.kernels.lut_scan_smem_bytes (the fused tier's admission rule)
    is the kernel's own shared-memory formula."""
    from raft_tpu_torch.ops.build import LIBRARIES

    cuda_device()
    lib = LIBRARIES.get("ivfpq_lut_scan")
    for qg in (1, 3, 4):
        for R in (1, 4):
            for S, Kb, rot, seg, nb in ((64, 256, 128, 8, 64),
                                        (16, 16, 32, 130, 8),
                                        (96, 32, 96, 512, 60)):
                want = K.lut_scan_smem_bytes(qg, R, S, Kb, rot, seg, nb)
                assert lib.rtt_lut_scan_smem_bytes(qg, R, S, Kb, rot, seg,
                                                   nb) == want


# ---------------------------------------------------------------------------
# the scans over IVF-PQ's bf16 reconstruction cache, and save/load of card
# indexes
# ---------------------------------------------------------------------------

_CARD_INDEXES = {}


def _recon_index(dev):
    """An IVF-PQ index built on the card at the cache shape of the
    ``ivf_pq.n1024.d64`` configuration, cut in lists: 16 lists of L 1536
    (spill, cap factor 1.5 over 1024 rows a list), d 128, pq_dim 64, the
    bf16 cache built by the default rule."""
    from raft_tpu_torch.neighbors import ivf_pq

    if "pq" not in _CARD_INDEXES:
        x = torch.tensor(blobs(16 * 1024, 128, 64, seed=8, std=2.0)).to(dev)
        _CARD_INDEXES["pq"] = (ivf_pq.build(x, ivf_pq.IndexParams(
            n_lists=16, pq_dim=64, spill=True, list_size_cap_factor=1.5,
            kmeans_n_iters=10), device=dev), x)
    return _CARD_INDEXES["pq"]


def _recon_scan_case(dev, metric):
    from raft_tpu_torch.neighbors import ivf_common, ivf_pq

    index, _ = _recon_index(dev)
    q = torch.tensor(blobs(300, 128, 64, seed=9, std=2.0)).to(dev)
    _, probes = ivf_pq._coarse_probes(index, q, 8, metric == "ip")
    seg = ivf_common.SEGMENT_SIZE
    n_seg = ivf_common.n_segments(300 * 8, index.n_lists, seg)
    seg_list, seg_q, _, _ = ivf_common.segment_probes(probes, index.n_lists,
                                                      seg, n_seg)
    q_rot = (q @ index.rotation.T).contiguous()
    args = [seg_list, seg_q, q_rot, index.packed_recon, index.packed_ids]
    c = dict(seg_list=seg_list.cpu().numpy(), seg_q=seg_q.cpu().numpy(),
             q=q_rot.cpu().numpy(),
             packed=index.packed_recon.float().cpu().numpy(),
             ids=index.packed_ids.cpu().numpy(), bf16=True)
    return args, c


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_scans_over_the_recon_cache_match_plain(metric):
    """B5 and B6 over a card-built bf16 cache (L 1536, d 128; kk 40 =
    k 10 · refine_ratio 4) against their plain versions."""
    dev = cuda_device()
    index, _ = _recon_index(dev)
    assert index.packed_recon.dtype == torch.bfloat16
    assert tuple(index.packed_recon.shape) == (16, 1536, 128)
    args, c = _recon_scan_case(dev, metric)
    tk, ti = K.segmented_scan_topk(*args, metric)
    pk, pi = K.segmented_scan_topk_plain(*args, metric)
    assert_scan_match(tk.cpu(), ti.cpu(), pk.cpu(), pi.cpu(), c, metric,
                      "ids", rtol=1e-5, atol=1e-4)
    for kk in (40, 64):
        tk, tp = K.grouped_scan_topk(*args, kk, metric)
        pk, pp = K.grouped_scan_topk_plain(*args, kk, metric)
        assert_scan_match(tk.cpu(), tp.cpu(), pk.cpu(), pp.cpu(), c, metric,
                          "pos", rtol=1e-5, atol=1e-4)


def test_cuda_index_save_load_round_trip(tmp_path):
    """A card index saved and loaded back onto the card: every array equal,
    the cache rebuilt bit for bit, the same search results; IVF-Flat
    likewise."""
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    dev = cuda_device()
    index, x = _recon_index(dev)
    path = str(tmp_path / "card.ivfpq")
    ivf_pq.save(index, path)
    back = ivf_pq.load(path)
    for name in ("centers", "centers_rot", "rotation", "codebooks",
                 "packed_codes", "packed_ids", "packed_norms", "list_sizes"):
        a, b = getattr(back, name), getattr(index, name)
        assert a.device.type == "cuda" and torch.equal(a, b), name
    assert torch.equal(back.packed_recon.view(torch.int16),
                       index.packed_recon.view(torch.int16))
    q = x[:500] + 0.1
    for sel in ("approx", "exact"):
        sp = ivf_pq.SearchParams(n_probes=8, scan_mode="grouped",
                                 scan_select=sel)
        da, ia = ivf_pq.search(index, q, 10, sp)
        db, ib = ivf_pq.search(back, q, 10, sp)
        assert torch.equal(ia, ib) and torch.equal(da, db)
    flat = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=16,
                                                  kmeans_n_iters=5))
    fpath = str(tmp_path / "card.ivfflat")
    ivf_flat.save(flat, fpath)
    fback = ivf_flat.load(fpath)
    for name in ("centers", "packed_data", "packed_ids", "packed_norms",
                 "list_sizes"):
        assert torch.equal(getattr(fback, name), getattr(flat, name)), name


# ---------------------------------------------------------------------------
# filtered kernels: B1 and B8 with keep bytes, B2 with the bitset's words,
# B5 and B6 over a masked id table
# ---------------------------------------------------------------------------

def _keep_bits(keep: np.ndarray, dev):
    """The bitset of a keep mask; all kept: ``make_filter``'s all-pass
    bitset, whose pad bits are set too (ids past the mask pass, as they do
    unfiltered)."""
    from raft_tpu_torch.core import bitset
    from raft_tpu_torch.neighbors import sample_filter

    if keep.all():
        return sample_filter.make_filter(keep.shape[0], device=dev)
    return bitset.from_mask(torch.tensor(keep), device=dev)


@pytest.mark.parametrize("kind", FILTER_KINDS)
@pytest.mark.parametrize("pq_bits,S", [(5, 16), (8, 64)])
def test_cuda_lut_scan_filtered_matches_plain(pq_bits, S, kind):
    """B1 with keep bytes (L 300: a ragged last byte; the two ids past the
    permutation sit in the bitset's last word) against its plain version;
    no returned id has its bit clear; all-ones equals no filter bit for
    bit; none kept gives only sentinels. S 64 takes the rotated look-up."""
    from raft_tpu_torch.neighbors import sample_filter

    dev = cuda_device()
    c = scan_case(pq_bits, seed=7, S=S)
    n_ids = int(c["ids"].max()) + 1
    keep = filter_keep(n_ids, kind, seed=pq_bits)
    args = _lut_ops(c, dev)
    ids = args[SCAN_OPERANDS.index("ids")]
    fbytes = sample_filter.list_filter_bytes(_keep_bits(keep, dev), ids)
    assert fbytes.shape == (c["ids"].shape[0], (c["L"] + 7) // 8)
    kw = dict(pq_bits=pq_bits, pq_dim=c["S"], L=c["L"])
    for metric in ("l2", "ip"):
        K.reset_launch_counts()
        tk, ti = K.ivfpq_lut_scan_topk(*args, metric, filter_bytes=fbytes,
                                       **kw)
        assert K.launch_counts()["ivfpq_lut_scan_topk"] == 1
        assert K.filtered_launch_counts()["ivfpq_lut_scan_topk"] == 1
        pk, pi = K.ivfpq_lut_scan_topk(*[a.cpu() for a in args], metric,
                                       filter_bytes=fbytes.cpu(), **kw)
        ref = scan_reference_keys(c, c["cb"], metric)
        ref = {key: np.where(keep[np.clip(c["ids"][c["seg_list"][
            c["pair_seg"][key]]], 0, None)], v, np.inf)
            for key, v in ref.items()}
        tk, ti = tk.cpu().numpy(), ti.cpu().numpy()
        assert_bins_match(tk, ti, pk.numpy(), pi.numpy(), ref, rtol=1e-4,
                          atol=1e-3)
        got = ti[ti >= 0]
        assert keep[got].all(), metric
        if kind == "none":
            assert not got.size and np.isinf(tk).all()
        if kind == "all":
            uk, ui = K.ivfpq_lut_scan_topk(*args, metric, **kw)
            assert np.array_equal(ui.cpu().numpy(), ti)
            assert np.array_equal(uk.cpu().numpy(), tk)


@pytest.mark.parametrize("kind", FILTER_KINDS)
def test_cuda_gather_refine_filtered_matches_plain(kind):
    """B2 with the bitset's words (out-of-range and invalid candidates in
    the table, ids in the last word) against its plain version, every
    metric, random rows (ids equal away from key ties) and integer rows
    (bit for bit); no returned id has its bit clear; all-ones equals no
    filter bit for bit."""
    dev = cuda_device()
    for ties in (False, True):
        data, q, cand = refine_case(seed=4, C=400, n=2000, ties=ties)
        keep = filter_keep(2000, kind, seed=3)
        bits = _keep_bits(keep, dev)
        data, q, cand = (torch.tensor(a).to(dev) for a in (data, q, cand))
        for metric in ("l2", "ip", "cos"):
            K.reset_launch_counts()
            v, i = K.gather_refine_topk(data, q, cand, 10, metric,
                                        filter_bits=bits)
            assert K.filtered_launch_counts()["gather_refine_topk"] == 1
            pv, pi = K.gather_refine_topk_plain(data, q, cand, 10, metric,
                                                bits)
            got = i[i >= 0].cpu().numpy()
            # an id past the rows (clipped for its fetch) tests a pad bit,
            # set only in the all-pass bitset
            assert np.append(keep, [keep.all()] * 32)[got].all(), metric
            if kind == "all":
                uv, ui = K.gather_refine_topk(data, q, cand, 10, metric)
                assert torch.equal(_bits(uv), _bits(v)) and torch.equal(ui, i)
            if ties:
                assert torch.equal(_bits(v), _bits(pv)), metric
                assert torch.equal(i, pi), metric
                continue
            torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)
            fin = torch.isfinite(pv)
            tol = 1e-5 * (1.0 + torch.where(fin, pv, 0.0).abs())
            gap = (pv[:, 1:] - pv[:, :-1]).abs() <= tol[:, 1:]
            tie = torch.zeros_like(pv, dtype=torch.bool)
            tie[:, 1:] |= gap
            tie[:, :-1] |= gap
            tie[:, -1] = True
            assert bool(((i == pi) | tie | ~fin).all()), metric
            assert bool((i[~fin] == -1).all())


@pytest.mark.parametrize("kind", ["every_other", "sel0.1", "last_word"])
def test_cuda_scans_over_a_masked_id_table_match_plain(kind):
    """B5 and B6 take a filter as their id table with the cleared ids set
    to −1 (the JAX package's masked table and mask_add): against their
    plain versions over the same masked table, no pick a filtered id."""
    dev = cuda_device()
    c = flat_scan_case(300, 96, seed=2)
    keep = filter_keep(int(c["ids"].max()) + 1, kind, seed=5)
    c["ids"] = np.where(keep[np.clip(c["ids"], 0, None)], c["ids"], -1)
    args = flat_scan_operands(c, dev)
    for metric in ("l2", "ip"):
        tk, ti = K.segmented_scan_topk(*args, metric)
        pk, pi = K.segmented_scan_topk_plain(*args, metric)
        assert_scan_match(tk.cpu(), ti.cpu(), pk.cpu(), pi.cpu(), c, metric,
                          "ids", rtol=1e-5, atol=1e-4)
        got = ti[ti >= 0].cpu().numpy()
        assert keep[got].all()
        tk, tp = K.grouped_scan_topk(*args, 10, metric)
        pk, pp = K.grouped_scan_topk_plain(*args, 10, metric)
        assert_scan_match(tk.cpu(), tp.cpu(), pk.cpu(), pp.cpu(), c, metric,
                          "pos", rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", FILTER_KINDS)
@pytest.mark.parametrize("pq_bits,S,ties", [(8, 64, False), (5, 16, False),
                                            (8, 64, True)])
def test_cuda_ring_lut_scan_filtered_matches_plain(pq_bits, S, ties, kind):
    """B8, 4 ranks on one card, each with its keep bytes over its own id
    table, against the plain version; no returned id has its bit clear;
    all-ones equals no filter bit for bit; integer keys bit for bit."""
    from raft_tpu_torch.neighbors import sample_filter

    devices = _ring_devices(4)
    c = ring_scan_case(pq_bits, n_dev=4, seed=11, S=S, ties=ties)
    keep = filter_keep(int(c["ids"].max()) + 1, kind, seed=pq_bits)
    bits = _keep_bits(keep, devices[0])
    kw = dict(pq_bits=pq_bits, pq_dim=c["S"], L=c["L"])
    ops = ring_scan_ops(c, devices)
    fb = [sample_filter.list_filter_bytes(bits, ids) for ids in ops[4]]
    K.reset_launch_counts()
    tk, ti = K.ring_lut_scan_merge(*ops, 10, "l2", filter_bytes=fb, **kw)
    assert K.launch_counts()["ring_lut_scan_merge"] == 2
    assert K.filtered_launch_counts()["ring_lut_scan_merge"] == 2
    pk, pi = K.ring_lut_scan_merge(*ring_scan_ops(c, ["cpu"] * 4), 10, "l2",
                                   filter_bytes=[f.cpu() for f in fb], **kw)
    cb_used = K.lut_codebook(torch.tensor(c["cb"]), "float32").numpy()
    if kind == "all":
        uk, ui = K.ring_lut_scan_merge(*ops, 10, "l2", **kw)
    for r in range(4):
        a, b = tk[r].cpu().numpy(), pk[r].numpy()
        ia, ib = ti[r].cpu().numpy(), pi[r].numpy()
        assert keep[ia[ia >= 0]].all(), r
        if kind == "all":
            assert np.array_equal(uk[r].cpu().numpy(), a)
            assert np.array_equal(ui[r].cpu().numpy(), ia)
        if ties:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ia, ib)
            continue
        assert (np.isinf(a) == np.isinf(b)).all()
        assert (ia[np.isinf(a)] == -1).all()
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-4, atol=1e-3)
        for row, j in zip(*np.nonzero((ia != ib) & fin)):
            k64 = ring_scan_key64(c, cb_used, "l2", r, row, ia[row, j])
            assert abs(k64 - b[row, j]) <= 1e-3 + 1e-4 * abs(b[row, j]), (
                r, row, j)


# ---------------------------------------------------------------------------
# the host-memory tier and the degradation ladder on the card
# ---------------------------------------------------------------------------

def test_cuda_tiered_prefetch_matches_inline_fetch_on_a_side_stream():
    """The prefetcher's reader copies on a CUDA stream of its own: with the
    default stream held busy by a spinning kernel, a block fetched on the
    reader thread lands, and reads back right on its stream, while the
    default stream is still busy (a copy queued on the default stream
    would wait for the spin). Its landed blocks equal the inline fetch and
    numpy's gather over more sub-batches than it has staging buffers, so
    every buffer is reused; and a tiered search equals the serialized host
    gather and its prefetch=False leg bit for bit."""
    from raft_tpu_torch.neighbors import ivf_pq, tiered

    dev = cuda_device()
    rng = np.random.default_rng(0)
    n, d = 50_000, 96
    x = rng.standard_normal((n, d)).astype(np.float32)
    blocks = [rng.integers(-1, n + 5, (64, 400)).astype(np.int32)
              for _ in range(3 * (tiered.PREFETCH_DEPTH + 2))]
    fetch = tiered.host_row_reader(x, device=dev)
    default = torch.cuda.default_stream(dev)
    assert fetch.stream is not None and fetch.stream != default
    # fill every staging buffer and the side stream's cached blocks first,
    # so that the checked fetch allocates nothing
    for c in blocks[:tiered.PREFETCH_DEPTH + 2]:
        fetch(c)
    torch.cuda.synchronize(dev)
    c = blocks[-1]
    pf = tiered.RowPrefetcher(fetch)
    try:
        with torch.cuda.stream(default):
            torch.cuda._sleep(2_000_000_000)  # about a second at 1.98 GHz
        pf.submit(c)
        got = pf.get()
        assert got.stream is fetch.stream and got.event is not None
        got.event.synchronize()
        with torch.cuda.stream(fetch.stream):
            landed = got.rows.cpu()
        assert not default.query(), "the default stream finished first"
    finally:
        pf.close()
        torch.cuda.synchronize(dev)
    assert torch.equal(landed, torch.from_numpy(x[np.clip(c, 0, n - 1)]))

    pf = tiered.RowPrefetcher(fetch)
    pf_inline = tiered.RowPrefetcher(tiered.host_row_reader(x, device=dev),
                                     prefetch=False)
    try:
        for c in blocks:
            ids = torch.from_numpy(c).to(dev)
            pf.submit(tiered.stage_ids(ids))
            pf_inline.submit(tiered.stage_ids(ids))
        for c in blocks:
            got = pf.get()
            assert got.stream is fetch.stream and got.event is not None
            want = pf_inline.get().ready()
            rows = got.ready()
            assert rows.device.type == "cuda"
            assert torch.equal(rows, want)
            assert torch.equal(rows.cpu(), torch.from_numpy(
                x[np.clip(c, 0, n - 1)]))
    finally:
        pf.close()
        pf_inline.close()

    base = torch.from_numpy(x).to(dev)
    index = ivf_pq.build(base, ivf_pq.IndexParams(
        n_lists=256, pq_dim=32, cache_reconstruction="never"))
    q = base[:500] + 0.01
    sp = ivf_pq.SearchParams(n_probes=32, scan_select="pallas",
                             lut_dtype="bfloat16", refine="f32_regen",
                             refine_ratio=20)
    out = {tr: ivf_pq.search(index, q, 10, ivf_pq.SearchParams(
        **{**sp.__dict__, "refine_transfer": tr}), dataset=x)
        for tr in ("tiered", "serial")}
    out["no_prefetch"] = tiered.search_refined_tiered(
        ivf_pq.search, index, q, 10, 200,
        ivf_pq.SearchParams(**{**sp.__dict__, "refine": "none"}), None, x,
        index.metric, prefetch=False)
    for other in ("serial", "no_prefetch"):
        assert torch.equal(out["tiered"][1], out[other][1]), other
        assert torch.equal(out["tiered"][0], out[other][0]), other


def test_cuda_real_oom_is_classified_and_the_ladder_recovers():
    """A real ``torch.cuda.OutOfMemoryError`` under a memory fraction is a
    RESOURCE_EXHAUSTED to the ladder (no fault fired), the walk halves
    until the allocation fits, and the fraction is restored after."""
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.robust import degrade

    cuda_device()
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(dev).total_memory
    cap = torch.cuda.memory_reserved(dev) + (512 << 20)
    spans.reset()

    def call(knobs):
        buf = torch.empty(knobs["n"], dtype=torch.uint8, device=dev)
        return int(buf.numel())

    ladder = degrade.Ladder([degrade.Step(
        "halve", lambda kn: {**kn, "n": kn["n"] // 2}, repeatable=True)])
    try:
        torch.cuda.set_per_process_memory_fraction(cap / total, dev)
        with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
            call({"n": 2 << 30})
        assert degrade.is_resource_exhausted(ei.value)
        del ei
        got = degrade.run_with_degradation(call, {"n": 2 << 30}, ladder,
                                           site="card")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    assert got <= 512 << 20
    assert spans.total("degrade.steps", site="card",
                       reason="resource_exhausted") >= 2
    assert spans.total("degrade.recovered", site="card") == 1
    assert spans.total("faults.fired") == 0
    big = torch.empty(2 << 30, dtype=torch.uint8, device=dev)
    assert big.numel() == 2 << 30
