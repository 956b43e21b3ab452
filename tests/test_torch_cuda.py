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

import time

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


# (d, L, rows): 1-byte list rows over the whole int8 / uint8 range: d 128
# and 960 take 16-byte copies, 100 8-byte, 37 (not a multiple of 4) plain
# loads; L 77 is one partial tile, 1536 twelve tiles
BYTE_CASES = [(128, 1536, "int8"), (128, 1536, "uint8"), (960, 300, "uint8"),
              (100, 77, "int8"), (37, 300, "uint8"), (16, 96, "int8")]


@pytest.mark.parametrize("d,L,rows", BYTE_CASES)
def test_cuda_scans_over_byte_lists_match_plain(d, L, rows):
    """B5 and B6 read int8 and uint8 lists as they are stored (ROADMAP
    A19), widened in registers, against their plain versions at l2, ip and
    cos: keys within tolerance, picks equal away from key ties."""
    dev = cuda_device()
    c = flat_scan_case(L, d, seed=4, rows=rows)
    args = flat_scan_operands(c, dev)
    assert args[3].dtype == (torch.int8 if rows == "int8" else torch.uint8)
    for metric in ("l2", "ip", "cos"):
        tk, ti = K.segmented_scan_topk(*args, metric)
        pk, pi = K.segmented_scan_topk_plain(*args, metric)
        assert_scan_match(tk.cpu(), ti.cpu(), pk.cpu(), pi.cpu(), c, metric,
                          "ids", rtol=1e-5, atol=1e-4)
        for kk in (1, 10, 64):
            tk, tp = K.grouped_scan_topk(*args, kk, metric)
            pk, pp = K.grouped_scan_topk_plain(*args, kk, metric)
            assert_scan_match(tk.cpu(), tp.cpu(), pk.cpu(), pp.cpu(), c,
                              metric, "pos", rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_cuda_gather_refine_bf16_rows_match_plain(metric):
    """B2 on bf16 rows (ROADMAP A8) against its plain version on the same
    rows, without and with a filter: keys within 1e-5, ids equal away from
    key ties; no kept-out id returned; the filtered launch counted."""
    dev = cuda_device()
    data, q, cand = refine_case(seed=6, C=400, n=2000, d=96)
    data = torch.tensor(data).to(dev).to(torch.bfloat16)
    q, cand = torch.tensor(q).to(dev), torch.tensor(cand).to(dev)
    keep = filter_keep(2000, "sel0.1", seed=2)
    for bits in (None, _keep_bits(keep, dev)):
        K.reset_launch_counts()
        v, i = K.gather_refine_topk(data, q, cand, 10, metric,
                                    filter_bits=bits)
        assert K.launch_counts()["gather_refine_topk"] == 1
        assert K.filtered_launch_counts()["gather_refine_topk"] == int(
            bits is not None)
        pv, pi = K.gather_refine_topk_plain(data, q, cand, 10, metric, bits)
        torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)
        fin = torch.isfinite(pv)
        tol = 1e-5 * (1.0 + torch.where(fin, pv, 0.0).abs())
        gap = (pv[:, 1:] - pv[:, :-1]).abs() <= tol[:, 1:]
        tie = torch.zeros_like(pv, dtype=torch.bool)
        tie[:, 1:] |= gap
        tie[:, :-1] |= gap
        tie[:, -1] = True
        assert bool(((i == pi) | tie | ~fin).all()), metric
        if bits is not None:
            got = i[i >= 0].cpu().numpy()
            assert np.append(keep, [False] * 32)[got].all()


def test_cuda_per_cluster_search_matches_the_cpu():
    """A per_cluster IVF-PQ index (ROADMAP A9) built on the CPU, searched on
    the card and on the CPU: per_query, approx and exact grouped tiers over
    its recon cache (B5, B6), ids equal but at f64 ties of the cache rows
    (the per_query tier's look-up tables: distances within 1e-4)."""
    from raft_tpu_torch.bench.dataset import tie_swaps
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    dev = cuda_device()
    x = blobs(6000, 32, 40, seed=5)
    q = blobs(200, 32, 40, seed=6)
    idx = tpq.build(x, tpq.IndexParams(
        n_lists=32, pq_dim=16, codebook_kind="per_cluster",
        cache_reconstruction="always"), device="cpu")
    card = tpq.from_numpy(*tpq.to_numpy(idx), device=dev)
    assert torch.equal(card.packed_recon.cpu(), idx.packed_recon)
    valid = idx.packed_ids.view(-1) >= 0
    by_id = torch.zeros((x.shape[0], idx.rot_dim))
    by_id[idx.packed_ids.view(-1)[valid].long()] = \
        idx.packed_recon.view(-1, idx.rot_dim)[valid].float()
    q_rot = torch.tensor(q) @ idx.rotation.T
    K.reset_launch_counts()
    for mode, select in (("per_query", "exact"), ("grouped", "approx"),
                         ("grouped", "exact")):
        sp = tpq.SearchParams(n_probes=8, scan_mode=mode, scan_select=select)
        d_c, i_c = tpq.search(card, torch.tensor(q).to(dev), 10, sp,
                              device=dev)
        d_p, i_p = tpq.search(idx, torch.tensor(q), 10, sp, device="cpu")
        if mode == "per_query":
            torch.testing.assert_close(d_c.cpu(), d_p, rtol=1e-4, atol=1e-4)
            continue
        tie_swaps(q_rot, by_id, i_c.cpu(), d_c.cpu(), i_p, d_p)
    counts = K.launch_counts()
    assert counts["segmented_scan_topk"] and counts["grouped_scan_topk"]
    assert counts["ivfpq_lut_scan_topk"] == 0


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


def _leg3_ring_operands(dev, n_dev=4, n_lists=8192, L=2440, S=64, P=2,
                        mc=8, n_probes=64, seed=5):
    """B8's operands at the shape of ``chip_smoke.py``'s ``[shard leg 3]``
    (4 ranks on one card, a batch of 32 in chunks of 8, n_probes 64, 512
    union lists a chunk, 8192 lists of about 610 real rows of 64 one-byte
    codes, rot 128), made on the card: random codes, ids unique over the
    ranks, sizes 400–820, Gaussian queries, centers and codebooks."""
    from raft_tpu_torch.parallel.ivf import _chunk_unions

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rot = S * P
    NS = min(mc * n_probes, n_lists)
    probes = torch.rand((n_dev * mc, n_lists), generator=g, device=dev
                        ).argsort(1)[:, :n_probes].to(torch.int32)
    lists, ind = _chunk_unions(probes.view(n_dev, mc, n_probes), NS)
    qv = torch.randn((n_dev, mc, rot), generator=g, device=dev) * 4
    centers_rot = torch.randn((n_lists, rot), generator=g, device=dev) * 4
    cb = torch.randn((S, 256, P), generator=g, device=dev)
    packed, ids, norms, sizes = [], [], [], []
    for r in range(n_dev):
        packed.append(torch.randint(0, 256, (n_lists, L, S), generator=g,
                                    device=dev, dtype=torch.uint8))
        ids.append((torch.randperm(n_lists * L, generator=g, device=dev)
                    .view(n_lists, L) + r * n_lists * L).to(torch.int32))
        norms.append(torch.rand((n_lists, L), generator=g, device=dev) * 50
                     + 10)
        sizes.append(torch.randint(400, 821, (n_lists,), generator=g,
                                   device=dev, dtype=torch.int32))
    rep = lambda t: [t] * n_dev  # noqa: E731
    return ((rep(lists), rep(ind), rep(qv), packed, ids, norms, sizes,
             rep(centers_rot), rep(cb)),
            dict(pq_bits=8, pq_dim=S, L=L, lut_dtype="float32"))


def test_cuda_ring_lut_scan_is_deterministic():
    """ROADMAP C5: B8's output for one input is defined by its (key, union
    position · 256 + column) order, so 200 calls at ``[shard leg 3]``'s
    shape must give keys and ids bit-equal to the first call's, whatever
    order the warps take their work items in."""
    dev = _ring_devices(1)[0]
    ops, kw = _leg3_ring_operands(dev)
    first = K.ring_lut_scan_merge(*ops, 10, "l2", **kw)
    torch.cuda.synchronize()
    assert sum(int((i >= 0).sum()) for i in first[1]) == 4 * 8 * 10
    differ = []
    for call in range(1, 200):
        kv, ki = K.ring_lut_scan_merge(*ops, 10, "l2", **kw)
        if not all(torch.equal(a, b) for a, b in zip(kv + ki,
                                                      first[0] + first[1])):
            differ.append(call)
    assert not differ, f"{len(differ)} of 199 calls differ from the first"


def test_cuda_fused_ring_search_is_deterministic(monkeypatch):
    """ROADMAP C5, end to end: ``search_ivf_pq`` on the fused scan-in-ring
    tier (``RAFT_TPU_RING_FUSED=auto`` on a 4-rank mesh sharing the card,
    batch 32, n_probes 64, f32 LUT) gives one answer 200 times."""
    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.parallel import ivf as pivf
    from raft_tpu_torch.parallel import make_mesh

    dev = _ring_devices(1)[0]
    monkeypatch.setenv("RAFT_TPU_RING_FUSED", "auto")
    ds = DeviceSynthetic(2_000_000, 128, n_centers=2000, seed=3, device=dev)
    mesh = make_mesh(4, device=f"cuda:{dev.index}")
    index = pivf.build_ivf_pq(ivf_pq.IndexParams(
        n_lists=2048, pq_dim=64, pq_bits=8, kmeans_n_iters=10,
        cache_reconstruction="never", seed=3), ds.base(), mesh)
    q = ds.queries(32)
    sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                             lut_dtype="float32")
    spans.reset()
    v0, i0 = pivf.search_ivf_pq(sp, index, q, 10, mesh)
    assert spans.counts()["parallel.merge.dispatch"] == {"ring_fused_scan": 1}
    differ = []
    for call in range(1, 200):
        v, i = pivf.search_ivf_pq(sp, index, q, 10, mesh)
        if not (torch.equal(v, v0) and torch.equal(i, i0)):
            differ.append(call)
    assert not differ, f"{len(differ)} of 199 searches differ from the first"


def test_cuda_build_chunked_peak_is_a_chunk_not_the_base():
    """``ivf_pq.build_chunked`` on a device-chunk provider holds a chunk of
    rows on the card, never the base: its allocation peak stays below the
    peak of ``ivf_pq.build`` on the same rows by more than half the base's
    bytes. Each index holds each id once, and the chunked one holds every
    row it did not count as dropped (the list cap drops about 1 % of
    these rows, a share that moves from build to build on the card)."""
    from raft_tpu_torch.bench.dataset import DeviceSyntheticChunks
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.obs import spans

    dev = _ring_devices(1)[0]
    n, d = 4_000_000, 96
    ds = DeviceSyntheticChunks(n, d, n_centers=2000, seed=5,
                               chunk_rows=1 << 18, device=dev)
    p = ivf_pq.IndexParams(n_lists=1024, pq_dim=32, kmeans_n_iters=5,
                           cache_reconstruction="never", seed=5)
    peaks = {}
    for how in ("chunked", "full"):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base0 = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        spans.reset()
        if how == "chunked":
            index = ivf_pq.build_chunked(ds, p, chunk_rows=1 << 18,
                                         max_train_rows=1 << 19, device=dev)
        else:
            index = ivf_pq.build(ds[0:n], p, device=dev)
        torch.cuda.synchronize(dev)
        peaks[how] = torch.cuda.max_memory_allocated(dev) - base0
        ids = index.packed_ids[index.packed_ids >= 0].long()
        assert ids.numel() == index.size
        if how == "chunked":
            assert ids.numel() + spans.total(
                "ivf_pq.build.dropped", site="ivf_pq.build_chunked") == n
        assert torch.equal(torch.unique(ids), torch.sort(ids)[0])
        del index, ids
    assert peaks["chunked"] + n * d * 4 // 2 < peaks["full"], peaks


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


# ---------------------------------------------------------------------------
# observability on the card (ROADMAP A13)
# ---------------------------------------------------------------------------

def test_cuda_sync_span_times_a_lut_scan_as_cuda_events_do():
    """Sync-mode spans around B1 launches (500 queries × 64 probes over 256
    lists of 4,000 rows, 8-bit codes, S 64), one launch a span, measure
    what CUDA events around the same launches measure: the medians of five
    agree within 10 %, for root spans (their clock stops only once the
    card has finished) and for spans nested in one root (timed by their own
    events on the stream, read when the root has waited)."""
    from raft_tpu_torch import obs
    from raft_tpu_torch.obs import trace

    dev = cuda_device()
    c = scan_case(8, S=64, n_lists=256, L=4000, B=500, n_probes=64)
    args = _lut_ops(c, dev)

    def launch():
        return K.ivfpq_lut_scan_topk(*args, "l2", pq_bits=8, pq_dim=c["S"],
                                     L=c["L"], lut_dtype="float32")

    launch()
    torch.cuda.synchronize()
    reg = obs.MetricsRegistry()
    buf = trace.EventBuffer()
    prev = trace.set_buffer(buf)
    event_ms = []
    obs.enable(sync=True, events=True, registry=reg, hbm=False)
    try:
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with obs.span("scan") as sp:
                start.record()
                out = launch()
                end.record()
                sp.attach(out)
            assert end.query(), "the span exited before the launch ended"
            event_ms.append(start.elapsed_time(end))
    finally:
        obs.disable()
        trace.set_buffer(prev)
    span_ms = [e["dur"] * 1e3 for e in buf.snapshot() if e["ph"] == "X"]
    assert reg.snapshot()["histograms"]["span.scan"]["count"] == 5
    s_med, e_med = sorted(span_ms)[2], sorted(event_ms)[2]
    assert e_med > 0.5, event_ms
    assert abs(s_med - e_med) <= 0.10 * e_med, (span_ms, event_ms)

    buf.clear()
    event_ms = []
    obs.enable(sync=True, events=True, registry=reg, hbm=False)
    prev = trace.set_buffer(buf)
    try:
        with obs.span("batch") as root:
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with obs.span("scan") as sp:
                    start.record()
                    out = launch()
                    end.record()
                    sp.attach(out)
                event_ms.append((start, end))
            root.attach(out)
    finally:
        obs.disable()
        trace.set_buffer(prev)
    event_ms = [a.elapsed_time(b) for a, b in event_ms]
    span_ms = [e["dur"] * 1e3 for e in buf.snapshot()
               if e["ph"] == "X" and e["name"] == "batch.scan"]
    assert reg.snapshot()["histograms"]["span.batch.scan"]["count"] == 5
    s_med, e_med = sorted(span_ms)[2], sorted(event_ms)[2]
    assert abs(s_med - e_med) <= 0.10 * e_med, (span_ms, event_ms)


def test_cuda_hbm_gauges_equal_memory_stats():
    """The ``hbm.*`` gauges are the caching allocator's readings, and
    ``bytes_limit`` follows the per-process memory fraction."""
    from raft_tpu_torch import obs
    from raft_tpu_torch.obs import hbm

    dev = cuda_device()
    i = torch.cuda.current_device()
    keep = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    reg = obs.MetricsRegistry()
    got = hbm.sample(reg)
    stats = torch.cuda.memory_stats(i)
    g = reg.snapshot()["gauges"]
    assert got["bytes_in_use"] == stats["allocated_bytes.all.current"]
    assert g["hbm.bytes_in_use"] == stats["allocated_bytes.all.current"]
    assert g[f"hbm.bytes_in_use{{device={i}}}"] == g["hbm.bytes_in_use"]
    assert g["hbm.peak_bytes"] == stats["allocated_bytes.all.peak"]
    total = torch.cuda.get_device_properties(i).total_memory
    assert hbm.bytes_limit(dev) == total
    try:
        torch.cuda.set_per_process_memory_fraction(0.5, i)
        assert hbm.bytes_limit(dev) == int(total * 0.5)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, i)
    assert hbm.bytes_limit(torch.device("cpu")) is None
    del keep


def test_cuda_span_inside_graph_capture_records_nothing():
    """Inside a CUDA-graph capture a sync-mode span records nothing and
    raises nothing (a synchronize there would end the capture)."""
    from raft_tpu_torch import obs

    dev = cuda_device()
    x = torch.ones(1 << 20, device=dev)
    reg = obs.MetricsRegistry()
    obs.enable(sync=True, events=True, registry=reg)
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            y = x * 2.0  # warm up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            with obs.span("captured") as sp:
                y = x * 2.0
                sp.attach(y)
        g.replay()
        torch.cuda.synchronize()
        with obs.span("outside") as sp:
            sp.attach(x * 3.0)
    finally:
        obs.disable()
    h = reg.snapshot()["histograms"]
    assert "span.captured" not in h and h["span.outside"]["count"] == 1
    assert float(y[0]) == 2.0


def test_cuda_no_host_transfers_raises_on_item():
    """``sanitize.no_host_transfers`` turns a synchronizing ``.item()`` on
    a card tensor into an error, and restores the sync-debug mode."""
    from raft_tpu_torch.obs import sanitize

    dev = cuda_device()
    t = torch.arange(8, device=dev, dtype=torch.float32)
    before = torch.cuda.get_sync_debug_mode()
    with sanitize.no_host_transfers():
        u = t * 2.0  # no sync: allowed
        with pytest.raises(RuntimeError):
            u.sum().item()
    assert torch.cuda.get_sync_debug_mode() == before
    assert float(u.sum()) == 56.0


# ---------------------------------------------------------------------------
# the serving plane on the card (ROADMAP A14)
# ---------------------------------------------------------------------------

def _card_tenant(dev, n=20_000, d=32, seed=3):
    """A refined IVF-PQ tenant on the card: index, base, params (k_cand
    400: the re-rank takes the gather kernel from 256 candidates on)."""
    from raft_tpu_torch.neighbors import ivf_pq

    x = torch.from_numpy(blobs(n, d, 64, seed)).to(dev)
    index = ivf_pq.build(x, ivf_pq.IndexParams(
        n_lists=64, pq_dim=16, cache_reconstruction="never"), device=dev)
    sp = ivf_pq.SearchParams(n_probes=16, scan_select="pallas",
                             refine="f32_regen", refine_ratio=40)
    return index, x, sp


def _outcomes(futs):
    """Every future's outcome, each awaited with a timeout (an unresolved
    one fails the test by timing out)."""
    from raft_tpu_torch import serve

    out = []
    for f in futs:
        try:
            d, i = f.result(timeout=60)
            out.append(("ok", d, i))
        except serve.ShedError as e:
            out.append(("shed", e.reason))
        except serve.DeadlineExceeded:
            out.append(("deadline",))
    return out


def test_cuda_server_serves_what_a_direct_search_returns():
    """Single-query submits on a card registry: one coalesced batch equals
    a direct search of the same padded bucket bit for bit, the kernels of
    the path launch, and the results reach the client as host arrays."""
    from raft_tpu_torch import serve
    from raft_tpu_torch.neighbors import ivf_pq

    dev = cuda_device()
    index, x, sp = _card_tenant(dev)
    reg = serve.IndexRegistry(device=dev)
    assert reg.device.type == dev.type
    reg.admit("t", index, params=sp, default_k=10, dataset=x)
    srv = serve.MicroBatchServer(reg, serve.ServerConfig(
        max_batch=16, linger_s=0.002, default_slo_s=None))
    q = x[:13].cpu().numpy() + 0.01
    try:
        srv.start()
        K.reset_launch_counts()
        with srv._cond:  # one batch of 13 (bucket 16)
            futs = [srv.submit("t", r, 10) for r in q]
        got = _outcomes(futs)
    finally:
        srv.stop()
    launches = K.launch_counts()
    assert [o[0] for o in got] == ["ok"] * 13
    assert all(isinstance(o[2], np.ndarray) for o in got)
    padded = torch.zeros((16, q.shape[1]))
    padded[:13] = torch.from_numpy(q)
    d_ref, i_ref = ivf_pq.search(index, padded.to(dev), 10, sp, dataset=x,
                                 device=dev)
    np.testing.assert_array_equal(np.stack([o[2] for o in got]),
                                  i_ref[:13].cpu().numpy())
    np.testing.assert_array_equal(np.stack([o[1] for o in got]),
                                  d_ref[:13].cpu().numpy())
    for name in ("ivfpq_lut_scan_topk", "select_k", "gather_refine_topk"):
        assert launches[name] >= 1, launches


def test_cuda_no_unresolved_future_under_faults():
    """On the card: an injected OOM walks the ladder and still answers, a
    stall past a request's budget sheds it by deadline, and a stop with
    work queued sheds it as draining — every future resolves, typed."""
    from raft_tpu_torch import serve
    from raft_tpu_torch.robust import faults

    dev = cuda_device()
    index, x, sp = _card_tenant(dev)
    reg = serve.IndexRegistry(device=dev)
    reg.admit("t", index, params=sp, default_k=10, dataset=x)
    srv = serve.MicroBatchServer(reg, serve.ServerConfig(
        max_batch=8, linger_s=0.002, default_slo_s=0.1, drain_s=5.0))
    q = x[:8].cpu().numpy()
    try:
        srv.start()
        faults.install_plan({"faults": [{"site": "ivf_pq.search",
                                         "kind": "oom", "times": 1}]})
        walked = _outcomes([srv.submit("t", r, 10, slo_s=None) for r in q])
        faults.clear_plan()
        assert [o[0] for o in walked] == ["ok"] * 8
        assert reg.peek("t").state == "degraded"
        faults.install_plan({"faults": [{"site": "serve.dispatch",
                                         "kind": "sleep", "sleep_s": 0.3,
                                         "times": 0}]})
        slow = srv.submit("t", q[0], 10, slo_s=None)
        time.sleep(0.05)
        doomed = srv.submit("t", q[1], 10)
        queued = [srv.submit("t", r, 10, slo_s=None) for r in q]
        time.sleep(0.4)
        srv.stop(drain=False)
        out = _outcomes([slow, doomed] + queued)
    finally:
        faults.clear_plan()
        srv.stop(drain=False)
    kinds = [o[0] if o[0] != "shed" else o[1] for o in out]
    assert kinds[0] == "ok" and kinds[1] == "deadline"
    assert set(kinds[2:]) <= {"ok", "draining"} and "draining" in kinds


def test_cuda_registry_demotion_frees_the_base():
    """A second tenant past the budget demotes the first's raw vectors to
    host: the card's allocated bytes fall by the base's, the tiers read
    right, and the demoted tenant's dispatch equals its resident answers
    but at f32 ties."""
    from raft_tpu_torch import serve
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.serve import dispatch

    dev = cuda_device()
    index, x, sp = _card_tenant(dev, n=100_000)
    s_idx = serve.index_device_bytes(index, dev)
    s_raw = x.numel() * 4
    reg = serve.IndexRegistry(budget_bytes=2 * s_idx + s_raw + s_raw // 2,
                              headroom_frac=0.0, device=dev)
    reg.admit("a", index, params=sp, default_k=10, dataset=x.clone())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    reg.admit("b", index, params=sp, default_k=10, dataset=x)
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated() == s_raw
    a = reg.peek("a")
    assert a.demoted and a.placement.raw == "host"
    assert isinstance(a.dataset, np.ndarray)
    assert serve.index_bytes_by_tier(index, a.dataset, dev) == {
        "hbm": s_idx, "host": s_raw}
    q = x[:64] + 0.01
    d_h, i_h = dispatch.dispatch_batch(a, q, 10)
    d_r, i_r = ivf_pq.search(index, q, 10, sp, dataset=x, device=dev)
    diff = torch.nonzero(i_h != i_r).tolist()
    for r, j in diff:  # ties only: equal f64 distances within f32 rounding
        qa = q[r].double()
        da = float(((qa - x[i_h[r, j]].double()) ** 2).sum())
        db = float(((qa - x[i_r[r, j]].double()) ** 2).sum())
        assert abs(da - db) <= 1e-4 + 1e-5 * float((qa * qa).sum())


# ---------------------------------------------------------------------------
# the sharded tier's other half: the hier tier, the prefetcher, the
# distributed build (parallel.merge, parallel.build)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dcn,ici,m,select_min,variant", [
    (2, 2, 500, True, "sentinels"), (2, 2, 27, False, "sentinels"),
    (2, 4, 96, True, "ties")])
def test_cuda_hier_ring_per_pod_matches_plain(dcn, ici, m, select_min,
                                              variant):
    """The hier tier launches B7 once per pod, handed the pod's ranks: each
    pod's blocks equal B7's plain version on the same tables (exact, ties
    included), and on tie-free keys the tier's result equals the same
    merge on CPU ranks (the plain schedule) and the allgather tier."""
    from raft_tpu_torch.parallel import hier_mesh, merge

    dev = cuda_device()
    n, k = dcn * ici, 10
    vals, ids = ring_tables(n, m, k, seed=m + n, select_min=select_min,
                            variant=variant)
    mesh = hier_mesh(ici, dcn, devices=str(dev))
    for pod in mesh.groups(("ici",)):
        K.reset_launch_counts()
        kv, ki = K.ring_topk_merge([torch.tensor(vals[r]).to(dev)
                                    for r in pod],
                                   [torch.tensor(ids[r]).to(dev)
                                    for r in pod], k, select_min)
        assert K.launch_counts()["ring_topk_merge"] == 1
        pv, pi = K.ring_topk_merge([torch.tensor(vals[r]) for r in pod],
                                   [torch.tensor(ids[r]) for r in pod], k,
                                   select_min)
        for j in range(ici):
            assert torch.equal(kv[j].cpu(), pv[j])
            assert torch.equal(ki[j].cpu(), pi[j])
    if variant == "ties":
        return
    out = {}
    for where in ("cuda", "cpu"):
        mesh = hier_mesh(ici, dcn, devices=str(dev) if where == "cuda"
                         else "cpu")
        d = mesh.devices[0]
        K.reset_launch_counts()
        for tier in ("hier", "allgather"):
            rv, ri = merge.merge_topk(
                [torch.tensor(v).to(d) for v in vals],
                [torch.tensor(i).to(d) for i in ids], mesh, m, k, n,
                select_min, tier=tier, impl=tier, axis=("dcn", "ici"))
            spec = merge.merge_out_spec(tier, ("dcn", "ici"))
            out[where, tier] = (
                merge.assemble(spec, rv, m, torch.device("cpu"), mesh),
                merge.assemble(spec, ri, m, torch.device("cpu"), mesh))
        if where == "cuda":
            assert K.launch_counts()["ring_topk_merge"] == dcn
    for key in (("cpu", "hier"), ("cuda", "allgather")):
        assert torch.equal(out["cuda", "hier"][0], out[key][0])
        assert torch.equal(out["cuda", "hier"][1].long(),
                           out[key][1].long())


def test_cuda_prefetcher_side_stream_handoff():
    """50 chunks generated on the prefetcher's own stream (each after a
    spin of the card, so a missing event wait would read rows not yet
    written) equal the same rows generated directly; the consumer's
    stream is kept busy between gets."""
    from raft_tpu_torch.bench.dataset import DeviceSyntheticChunks
    from raft_tpu_torch.parallel import ChunkPrefetcher

    dev = cuda_device()
    prov = DeviceSyntheticChunks(50 * 4096, 64, n_centers=100, seed=3,
                                 chunk_rows=4096, device=dev)

    def read(a, b):
        torch.cuda._sleep(2_000_000)
        return prov[a:b]

    ranges = [(a, a + 4096) for a in range(0, 50 * 4096, 4096)]
    busy = torch.randn((2048, 2048), device=dev)
    pf = ChunkPrefetcher(read, ranges, device=dev)
    try:
        for a, b in ranges:
            busy = busy @ busy.T / 2048.0
            x = pf.get()
            assert torch.equal(x, prov[a:b]), (a, b)
    finally:
        pf.close()


def test_cuda_distributed_build_is_build_chunked_deterministically(
        monkeypatch):
    """Under ``torch.use_deterministic_algorithms(True)`` a small
    distributed build (4 ranks on the card, each rank's rows a multiple of
    the chunk) assembles to ``build_chunked``'s index: equal shas."""
    from raft_tpu_torch.bench.dataset import DeviceSyntheticChunks
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.parallel import (assemble_ivf_pq, index_sha16,
                                         make_mesh)

    dev = cuda_device()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    chunk = 8192
    prov = DeviceSyntheticChunks(4 * 2 * chunk, 32, n_centers=300, seed=5,
                                 chunk_rows=chunk, device=dev)
    params = ivf_pq.IndexParams(n_lists=64, pq_dim=16, kmeans_n_iters=6,
                                seed=5, cache_reconstruction="never")
    torch.use_deterministic_algorithms(True)
    try:
        sharded = ivf_pq.build_distributed(
            prov, params, mesh=make_mesh(4, device=str(dev)),
            chunk_rows=chunk)
        chunked = ivf_pq.build_chunked(prov, params, chunk_rows=chunk,
                                       device=dev)
    finally:
        torch.use_deterministic_algorithms(False)
    asm = assemble_ivf_pq(sharded, device="cpu")
    assert index_sha16(asm) == index_sha16(chunked)
    assert asm.size == chunked.size > 0.99 * prov.shape[0]


# ---------------------------------------------------------------------------
# CAGRA (neighbors/cagra.py): its own code is plain torch; the default
# build runs B4 through the balanced k-means
# ---------------------------------------------------------------------------

def _cagra_graph(n: int, D: int, seed: int) -> torch.Tensor:
    """A kNN-like id table with repeated ids and a hub (node 7 in the
    forward half of a third of the rows)."""
    rng = np.random.default_rng(seed)
    g = np.sort((np.arange(n)[:, None] + rng.integers(1, 6 * D, (n, D))) % n,
                axis=1)
    rows = rng.choice(n, n // 10, replace=False)
    g[rows, D // 2:] = g[rows, :D - D // 2]
    hub = rng.choice(n, n // 3, replace=False)
    g[hub, rng.integers(0, D // 4, hub.size)] = 7
    return torch.from_numpy(g.astype(np.int32))


def test_cuda_cagra_optimize_graph_matches_cpu():
    from raft_tpu_torch.neighbors import cagra

    dev = cuda_device()
    g = _cagra_graph(20_000, 128, seed=1)
    want = cagra.optimize_graph(g, 64, device="cpu")
    got = cagra.optimize_graph(g.to(dev), 64, device=dev)
    assert torch.equal(got.cpu(), want)


def test_cuda_cagra_blocked_scan_matches_cpu():
    """The blocked scan on the card against the CPU on the same packed
    inputs: each sampled row's ids equal where its k-th candidate is
    tie-free in f64."""
    from raft_tpu_torch.cluster import kmeans_balanced as kb
    from raft_tpu_torch.neighbors import cagra, ivf_common as ic

    from torch_parity import blocked_tie_free_rows

    dev = cuda_device()
    x = blobs(40_000, 32, 64, seed=3, std=0.5)
    xt = torch.from_numpy(x)
    n_lists, T, k = 78, 6, 32
    km = kb.KMeansBalancedParams(n_iters=6, seed=0)
    centers = kb.fit(xt, n_lists, km)
    labels = kb.predict(centers, xt, km)
    L = ic._fit_list_size(torch.bincount(labels.long()).numpy(),
                          len(x) // n_lists, 4.0)
    (packed,), pids, _, _, (rl, rs) = ic.pack_lists(
        [xt], labels, torch.arange(len(x), dtype=torch.int32), n_lists, L,
        [0.0])
    args = (packed, pids, centers, rl, rs.clamp(0, L - 1))
    want = cagra._cluster_blocked_knn(*args, k, n_lists, T, 16, False)
    got = cagra._cluster_blocked_knn(*(a.to(dev) for a in args), k, n_lists,
                                     T, 5, False).cpu()
    p = {"centers": centers.numpy(), "row_list": rl.numpy(),
         "pids": pids.numpy()}
    rows = np.random.default_rng(0).choice(len(x), 500, replace=False)
    checked = blocked_tie_free_rows(x, p, rows, T, k)
    assert len(checked) > 300
    for r, ref in checked:
        assert set(got[r].tolist()) == ref == set(want[r].tolist()), r


def test_cuda_cagra_build_launches_b4():
    from raft_tpu_torch.neighbors import cagra

    dev = cuda_device()
    x = blobs(30_000, 48, 64, seed=5, std=0.5)
    K.reset_launch_counts()
    inter = {}
    index = cagra.build(x, cagra.IndexParams(
        intermediate_graph_degree=64, graph_degree=32,
        knn_rows_per_list=512, quantize_dataset=True), device=dev,
        intermediates=inter)
    assert K.launch_counts()["fused_l2_argmin"] > 0
    g = index.graph.cpu()
    assert g.dtype == torch.int32 and tuple(g.shape) == (30_000, 32)
    assert not bool((g == torch.arange(30_000)[:, None]).any())
    assert bool(((g >= -1) & (g < 30_000)).all())
    knn = inter["knn_graph"].cpu()
    assert all(set(a[:16].tolist()) <= set(b.tolist())
               for a, b in zip(g, knn))
    assert index.centers.device.type == index.dataset.device.type == dev.type
    assert index.dataset_q.dtype == torch.int8


@pytest.mark.parametrize("variant", ["f32", "int8", "filtered"])
def test_cuda_cagra_search_matches_cpu(variant):
    """One index searched on the card and on the CPU: distances within
    1e-4 relative, ids equal but at f64 ties."""
    from raft_tpu_torch.bench.dataset import tie_swaps
    from raft_tpu_torch.core import bitset
    from raft_tpu_torch.neighbors import cagra

    dev = cuda_device()
    x = blobs(30_000, 64, 64, seed=6, std=0.5)
    q = blobs(300, 64, 64, seed=7, std=0.5)
    index = cagra.build(x, cagra.IndexParams(
        intermediate_graph_degree=64, graph_degree=32, knn_rows_per_list=512,
        quantize_dataset=True), device=dev)
    on_cpu = cagra.from_numpy(*cagra.to_numpy(index), device="cpu")
    sp = cagra.SearchParams(itopk_size=64, search_width=8, max_iterations=6,
                            traverse="int8" if variant == "int8" else "f32")
    bits = None
    if variant == "filtered":
        bits = bitset.from_mask(filter_keep(len(x), "sel0.1", seed=3),
                                device=dev)
    dc, ic_ = cagra.search(index, q, 10, sp, filter_bitset=bits, device=dev)
    dp, ip_ = cagra.search(on_cpu, q, 10, sp, filter_bitset=bits,
                           device="cpu")
    assert ic_.dtype == torch.int32
    tie_swaps(q, x, ic_, dc, ip_, dp)


# ---------------------------------------------------------------------------
# the distance layer, ball cover and NN-Descent (plain torch on both
# devices; ball cover's probe rounds merge through B3)
# ---------------------------------------------------------------------------

_PAIRWISE_CASES = [
    ("sqeuclidean", "real"), ("euclidean", "real"), ("cosine", "real"),
    ("inner_product", "real"), ("correlation", "real"),
    ("hellinger", "prob"), ("jaccard", "sparse"), ("dice", "sparse"),
    ("russelrao", "binary"), ("l1", "real"), ("l2_unexpanded", "real"),
    ("l2_sqrt_unexpanded", "real"), ("linf", "real"), ("canberra", "sparse"),
    ("lp", "real"), ("braycurtis", "sparse"), ("jensenshannon", "prob"),
    ("hamming", "binary"), ("kl_divergence", "prob"), ("haversine", "geo"),
]


def _pairwise_rows(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "geo":
        scale = np.array([np.pi, 2 * np.pi], np.float32)
        return [(rng.random((r, 2), dtype=np.float32) - 0.5) * scale
                for r in (300, 700)]
    x = rng.random((300, 24), dtype=np.float32)
    y = rng.random((700, 24), dtype=np.float32)
    if kind == "binary":
        return (x > 0.5).astype(np.float32), (y > 0.5).astype(np.float32)
    if kind == "prob":
        x[x < 0.2] = 0.0
        y[y < 0.2] = 0.0
        return x / x.sum(1, keepdims=True), y / y.sum(1, keepdims=True)
    if kind == "sparse":
        x[x < 0.6] = 0.0
        y[y < 0.6] = 0.0
        x[0] = y[0] = 0.0
    return x, y


@pytest.mark.parametrize("metric,kind", _PAIRWISE_CASES,
                         ids=[m for m, _ in _PAIRWISE_CASES])
def test_cuda_pairwise_distance_matches_cpu(metric, kind):
    """Every metric on the card against its CPU result: within 1e-5
    relative (1e-6 absolute for values near 0); Lp with exponent 3.
    Haversine: 2·asin(√h) has the slope 1/√(1 − h), unbounded toward
    antipodal pairs, so past 2 radians a last-bit difference in sin or cos
    moves the distance by up to ~1e-4 relative; there h = sin²(d/2) is
    held within 1e-6 instead."""
    from raft_tpu_torch.distance import pairwise_distance

    dev = cuda_device()
    x, y = _pairwise_rows(kind, 21)
    want = pairwise_distance(x, y, metric, metric_arg=3.0,
                             device="cpu").numpy()
    got = pairwise_distance(x, y, metric, metric_arg=3.0, device=dev)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    got = got.cpu().numpy()
    near = want <= 2.0 if metric == "haversine" else np.ones_like(want, bool)
    np.testing.assert_allclose(got[near], want[near], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.sin(got[~near] / 2) ** 2,
                               np.sin(want[~near] / 2) ** 2, rtol=0,
                               atol=1e-6)


def test_cuda_ball_cover_knn_matches_cpu():
    """One index built on the card, searched there and on the CPU (the
    same arrays): distances within 1e-5 relative, ids equal away from
    ties; the probe rounds' merge launches select_k."""
    from raft_tpu_torch.neighbors import ball_cover

    from torch_parity import assert_ids_match_away_from_ties

    dev = cuda_device()
    x = blobs(60_000, 3, 40, seed=8, std=1.0)
    q = blobs(500, 3, 40, seed=9, std=1.0)
    index = ball_cover.build(x, seed=2, device=dev)
    on_cpu = ball_cover.from_numpy(*ball_cover.to_numpy(index), device="cpu")
    for k, rl in ((10, 0), (64, 4)):
        K.reset_launch_counts()
        dc, ic_ = ball_cover.knn(index, q, k, round_lists=rl, device=dev)
        assert K.launch_counts()["select_k"] > 0
        dp, ip_ = ball_cover.knn(on_cpu, q, k, round_lists=rl, device="cpu")
        assert ic_.dtype == torch.int32 and ic_.device.type == "cuda"
        assert_ids_match_away_from_ties(ic_.cpu().numpy(), dc.cpu().numpy(),
                                        ip_.numpy(), dp.numpy(), rtol=1e-5,
                                        atol=1e-6)


def test_cuda_ball_cover_eps_nn_matches_cpu():
    """Integer rows (exact distances): the card's build equals the CPU's
    (radii within 1e-6 relative), the packed keep mask and ids equal the
    CPU's exactly, and ``eps_neighbors_l2sq`` too."""
    from raft_tpu_torch.neighbors import ball_cover, epsilon_neighborhood

    dev = cuda_device()
    rng = np.random.default_rng(10)
    x = rng.integers(-30, 31, size=(20_000, 3)).astype(np.float32)
    q = rng.integers(-30, 31, size=(200, 3)).astype(np.float32) + 0.5
    index = ball_cover.build(x, seed=3, device=dev)
    on_cpu = ball_cover.from_numpy(*ball_cover.to_numpy(index), device="cpu")
    ref = ball_cover.build(x, seed=3, device="cpu")
    for name in ("landmarks", "packed_data", "packed_ids", "list_sizes"):
        assert torch.equal(getattr(ref, name), getattr(on_cpu, name)), name
    torch.testing.assert_close(on_cpu.radii, ref.radii, rtol=1e-6, atol=0)
    kc, idc = ball_cover.eps_nn(index, q, 4.0, device=dev)
    kp, idp = ball_cover.eps_nn(on_cpu, q, 4.0, device="cpu")
    assert torch.equal(kc.cpu(), kp) and torch.equal(idc.cpu(), idp)
    assert int(kp.sum()) > 0
    ac, vc = epsilon_neighborhood.eps_neighbors_l2sq(q, x, 20.0, device=dev)
    ap, vp = epsilon_neighborhood.eps_neighbors_l2sq(q, x, 20.0,
                                                     device="cpu")
    assert torch.equal(ac.cpu(), ap) and torch.equal(vc.cpu(), vp)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_cuda_nn_descent_matches_cpu_bit_for_bit(metric, monkeypatch):
    """Small-integer rows (every f32 sum exact): the card's graph and
    distances equal the CPU's bit for bit, chunked differently."""
    from raft_tpu_torch.neighbors import nn_descent

    dev = cuda_device()
    x = np.random.default_rng(11).integers(-8, 9, size=(5000, 16)).astype(
        np.float32)
    ic_, dc = nn_descent.build_knn_graph_with_distances(
        x, 16, metric=metric, n_iters=6, seed=4, device=dev)
    monkeypatch.setattr(nn_descent, "_chunk_rows", lambda *a: 777)
    ip_, dp = nn_descent.build_knn_graph_with_distances(
        x, 16, metric=metric, n_iters=6, seed=4, device="cpu")
    assert torch.equal(ic_.cpu(), ip_)
    assert torch.equal(dc.cpu().view(torch.int32), dp.view(torch.int32))


# ---------------------------------------------------------------------------
# the LUT tier's index tables replayed from CUDA graphs (utils.graphs)
# ---------------------------------------------------------------------------

def test_cuda_graphed_tables_equal_eager_tables():
    """``segment_probes`` and the LUT scan's launch tables replayed from a
    graph equal the eager operations bit for bit, for new inputs at every
    replay, apart and in the one graph of the LUT tier; CPU tensors run
    eagerly."""
    from raft_tpu_torch.neighbors import ivf_common as ic
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.utils import graphs

    dev = cuda_device()
    graphs.clear()
    n_lists, seg, B, P = 512, ic.SEGMENT_SIZE, 300, 32
    n_seg = ic.n_segments(B * P, n_lists, seg)
    g = torch.Generator(device=dev).manual_seed(3)
    for _ in range(3):
        probes = torch.randint(0, n_lists, (B, P), generator=g, device=dev,
                               dtype=torch.int32)
        want = ic.segment_probes(probes, n_lists, seg, n_seg)
        tw = K.lut_scan_tables(want[1], want[2], want[3], 16)
        with graphs.replayed(ic.segment_probes, (probes,), n_lists, seg,
                             n_seg) as got:
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            with graphs.replayed(K.lut_scan_tables,
                                 (got[1], got[2], got[3]), 16) as tg:
                assert all(torch.equal(a, b) for a, b in zip(tg, tw))
        # both in one graph, as the LUT tier replays them
        with graphs.replayed(ivf_pq._index_tables, (probes,), n_lists, seg,
                             n_seg, 16) as both:
            assert all(torch.equal(a, b)
                       for a, b in zip(both, tuple(want) + tuple(tw)))
    cpu = probes.cpu()
    with graphs.replayed(ic.segment_probes, (cpu,), n_lists, seg,
                         n_seg) as out:
        assert out[0].device.type == "cpu"
        assert all(torch.equal(b, a.cpu()) for a, b in zip(want, out))


def test_cuda_lut_tier_threads_share_no_tables():
    """Twelve threads (more than the host's cores) search one index on one
    stream at once, each its own batches through the LUT tier, whose
    tables replay from graphs they share: every result equals the same
    search run alone, ids and distances bit for bit (a replay outside the
    graph's lock would let one thread overwrite the tables another
    thread's kernel was about to read)."""
    import sys
    import threading

    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import ivf_pq

    dev = cuda_device()
    ds = DeviceSynthetic(200_000, 64, n_centers=500, seed=4, device=dev)
    index = ivf_pq.build(ds.base(), ivf_pq.IndexParams(
        n_lists=512, pq_dim=32, pq_bits=8, cache_reconstruction="never",
        seed=4), device=dev)
    qs = ds.queries(12 * 4 * 200).view(12, 4, 200, 64)
    sp = ivf_pq.SearchParams(n_probes=32, scan_select="pallas",
                             lut_dtype="float32")
    want = [[ivf_pq.search(index, q, 10, sp, device=dev) for q in batch]
            for batch in qs]
    got = [None] * 12
    errors = []

    def work(t):
        try:
            got[t] = [(b, ivf_pq.search(index, q, 10, sp, device=dev))
                      for _ in range(5) for b, q in enumerate(qs[t])]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    torch.cuda.synchronize()
    assert not errors, errors
    for t in range(12):
        assert len(got[t]) == 20
        for b, (gv, gi) in got[t]:
            wv, wi = want[t][b]
            assert torch.equal(gi, wi) and torch.equal(gv, wv), (t, b)


# ---------------------------------------------------------------------------
# B3's bias row, B4 under k-means, a handle's stream, the
# tri-states' "off"
# ---------------------------------------------------------------------------

def test_cuda_select_k_bias_row_matches_plain():
    """B3 with a bias row ranks bias − 2·scores bit for bit as its plain
    version and as the kernel over ``torch.sub(bias, scores, alpha=2)``
    (2·score is exact), on short and long rows, aligned and not."""
    dev = cuda_device()
    g = torch.Generator(device=dev).manual_seed(19)
    for m, n in ((500, 1024), (300, 1000), (64, 8192), (32, 20000),
                 (7, 1027)):
        s = torch.randn((m, n), generator=g, device=dev)
        b = torch.rand((n,), generator=g, device=dev) * 4.0
        for k in (1, 20, 64):
            v, i = K.select_k_cuda(s, k, True, bias=b)
            pv, pi = K.select_k_plain(s, k, True, bias=b)
            assert torch.equal(v, pv) and torch.equal(i, pi), (m, n, k)
            wv, wi = K.select_k_cuda(torch.sub(b, s, alpha=2.0), k, True)
            assert torch.equal(v, wv) and torch.equal(i, wi), (m, n, k)
    # a row view [1, n] is taken as the bias too
    v2, i2 = K.select_k_cuda(s, 8, True, bias=b[None, :])
    assert torch.equal(v2, K.select_k_cuda(s, 8, True, bias=b)[0])


def test_cuda_kmeans_fit_runs_b4_and_matches_plain():
    """``kmeans.fit`` on the card launches B4 once a sweep. Against the CPU
    (the plain version) on well-separated blobs: the same k-means++ seed
    rows (the threefry draws); one sweep from them gives centroids and
    inertia within 1e-5 relative; the whole fit's cost within 1e-4 of the
    CPU fit's; B4's labels on the card fit's final centers equal its plain
    version's but at f32 ties: where they differ, the two picked centers lie
    at f64 distances within 1e-4 + 1e-5·(‖x‖² + ‖c‖²) of each other (the
    rule of ``chip_smoke.py``'s B4 checks). The sweep counts and the final
    centers may differ from run to run: the card's cluster sums
    (``index_add_`` atomics) move the tol test's last bits."""
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.random import threefry
    from raft_tpu_torch.random.rng import RngState

    dev = cuda_device()
    x = torch.from_numpy(blobs(20_000, 32, 16, seed=5, std=0.5))
    xd = x.to(dev)
    p = kmeans.KMeansParams(n_clusters=16, max_iter=30, seed=3)
    K.reset_launch_counts()
    c, inertia, n_iter = kmeans.fit(p, xd, device=dev)
    assert K.launch_counts()["fused_l2_argmin"] == int(n_iter)
    key = threefry.fold_in(RngState(3).key(), 0)
    seeds = kmeans.init_plus_plus(key, x, 16)
    assert torch.equal(kmeans.init_plus_plus(key, xd, 16).cpu(), seeds)
    one = kmeans.KMeansParams(n_clusters=16, max_iter=1, init="array")
    c1, in1, _ = kmeans.fit(one, xd, init_centroids=seeds, device=dev)
    p1, pin1, _ = kmeans.fit(one, x, init_centroids=seeds, device="cpu")
    torch.testing.assert_close(c1.cpu(), p1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(float(in1), float(pin1), rtol=1e-5, atol=0.0)
    pc, _, _ = kmeans.fit(p, x, device="cpu")
    cost = float(kmeans.cluster_cost(c, xd, device=dev))
    pcost = float(kmeans.cluster_cost(pc, x, device="cpu"))
    assert abs(cost - pcost) <= 1e-4 * pcost, (cost, pcost)
    _, lab = K.fused_l2_argmin(xd, c)
    _, plab = K.fused_l2_argmin_plain(xd, c)
    bad = lab != plab
    xb, cd = xd[bad].double(), c.double()
    ck, cp = cd[lab[bad].long()], cd[plab[bad].long()]
    d_k, d_p = ((xb - ck) ** 2).sum(1), ((xb - cp) ** 2).sum(1)
    tol = 1e-4 + 1e-5 * ((xb * xb).sum(1) + (ck * ck).sum(1))
    assert bool(((d_k - d_p).abs() <= tol).all()), (
        int(bad.sum()), float((d_k - d_p).abs().max()))


def test_cuda_handle_stream_sync_waits():
    """A handle's own stream: work enqueued inside ``stream_context`` runs
    there (not on the default stream), ``sync()`` waits for it, and a
    pool of two handles gives two streams."""
    from raft_tpu_torch.core import resources

    dev = cuda_device()
    h = resources.DeviceResources(device=dev)
    s = h.stream
    assert s is not None and s != torch.cuda.default_stream(dev)
    with h.stream_context():
        assert torch.cuda.current_stream(dev) == s
        torch.cuda._sleep(200_000_000)        # ~0.1 s of the card's clock
        done = torch.ones(8, device=dev).sum()
    assert not s.query()
    h.sync()
    assert s.query() and float(done) == 8.0
    m = resources.DeviceResourcesManager()
    m.set_pool_size(2)
    a, b = m.get_resources(dev), m.get_resources(dev)
    assert a.stream != b.stream and m.get_resources(dev) is a


@pytest.mark.parametrize("env,kernel", [
    ("RAFT_TPU_PALLAS_LUTSCAN", "ivfpq_lut_scan_topk"),
    ("RAFT_TPU_PALLAS_GROUPED", "segmented_scan_topk"),
    ("RAFT_TPU_PALLAS_GROUPED", "grouped_scan_topk"),
    ("RAFT_TPU_PALLAS_REFINE", "gather_refine_topk")])
def test_cuda_tristate_off_leaves_the_kernel_still(monkeypatch, env, kernel):
    """With the tri-state "off" the kernel's launch counter does not move
    and the JAX package's other tier answers, ids overlapping the kernel
    tier's ≥ 0.95 (B1 and B2 on an IVF-PQ index, B5 and B6 on an IVF-Flat
    one, whose f32 lists the plain grouped tier scans at the kernels'
    precision); unset, the kernel launches."""
    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    dev = cuda_device()
    ds = DeviceSynthetic(100_000, 64, n_centers=200, seed=6, device=dev)
    base = ds.base()
    q = ds.queries(500)
    if env == "RAFT_TPU_PALLAS_GROUPED":
        index = ivf_flat.build(base, ivf_flat.IndexParams(n_lists=256,
                                                          seed=6), device=dev)
        select = "approx" if kernel == "segmented_scan_topk" else "exact"

        def search():
            return ivf_flat.search(index, q, 10, ivf_flat.SearchParams(
                n_probes=32, scan_select=select, scan_mode="grouped"),
                device=dev)[1]
    else:
        index = ivf_pq.build(base, ivf_pq.IndexParams(
            n_lists=256, pq_dim=32, seed=6, cache_reconstruction="never"),
            device=dev)
        sp = ivf_pq.SearchParams(
            n_probes=32, scan_select="pallas", scan_mode="grouped",
            lut_dtype="float32",
            refine="f32_regen" if kernel == "gather_refine_topk" else "none",
            refine_ratio=40.0)

        def search():
            return ivf_pq.search(index, q, 10, sp, dataset=base,
                                 device=dev)[1]
    out = {}
    for value in (None, "off"):
        if value is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, value)
        K.reset_launch_counts()
        out[value] = search()
        launched = K.launch_counts()[kernel]
        assert (launched == 0) == (value == "off"), (value, launched)
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(out[None].cpu(), out["off"].cpu()))
    assert hits >= 0.95 * out[None].numel(), hits


# ---------------------------------------------------------------------------
# the primitives (ROADMAP A17's first half): plain torch on both devices
# ---------------------------------------------------------------------------

def test_cuda_generators_equal_the_cpu():
    """The threefry draws are integer arithmetic: labels, edges and
    permutations on the card equal the CPU's bit for bit; generated rows
    rtol 1e-5 (the card's erf⁻¹ and logs may round their last bits
    otherwise)."""
    from raft_tpu_torch import random as tr

    dev = cuda_device()
    st = tr.RngState(8, 3)
    x, lab = tr.make_blobs(20_000, 24, n_clusters=50, state=st, device=dev)
    px, plab = tr.make_blobs(20_000, 24, n_clusters=50, state=st,
                             device="cpu")
    assert torch.equal(lab.cpu(), plab)
    torch.testing.assert_close(x.cpu(), px, rtol=1e-5, atol=1e-5)
    assert torch.equal(tr.rmat_rectangular(st, 50_000, 12, 10, device=dev)
                       .cpu(), tr.rmat_rectangular(st, 50_000, 12, 10,
                                                   device="cpu"))
    assert torch.equal(tr.uniform_int(st, (9_000,), -3, 70_000,
                                      device=dev).cpu(),
                       tr.uniform_int(st, (9_000,), -3, 70_000,
                                      device="cpu"))
    assert torch.equal(tr.permute(px[:5000].to(dev), st).cpu(),
                       tr.permute(px[:5000], st))
    rx, ry, rw = tr.make_regression(5000, 16, noise=0.1, state=st,
                                    device=dev)
    qx, qy, qw = tr.make_regression(5000, 16, noise=0.1, state=st,
                                    device="cpu")
    torch.testing.assert_close(rx.cpu(), qx, rtol=1e-5, atol=1e-6)
    assert torch.equal(rw.cpu(), qw)
    torch.testing.assert_close(ry.cpu(), qy, rtol=1e-5, atol=1e-3)


def test_cuda_out_of_range_segment_ids_are_dropped():
    """−1 and n_classes labels on the card: dropped as the CPU drops them,
    with no device assert (``index_add_``/``scatter_reduce`` would trip one
    on an out-of-range id)."""
    from raft_tpu_torch import label, linalg, stats

    dev = cuda_device()
    rng = np.random.default_rng(3)
    m = torch.from_numpy(rng.random((4000, 8), dtype=np.float32))
    keys = torch.from_numpy(rng.integers(-1, 7, 4000).astype(np.int32))
    other = torch.from_numpy(rng.integers(0, 7, 4000).astype(np.int32))
    md, kd, od = m.to(dev), keys.to(dev), other.to(dev)
    torch.testing.assert_close(linalg.reduce_rows_by_key(md, kd, 6).cpu(),
                               linalg.reduce_rows_by_key(m, keys, 6),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        linalg.reduce_cols_by_key(md.T.contiguous(), kd, 6).cpu(),
        linalg.reduce_cols_by_key(m.T.contiguous(), keys, 6), rtol=1e-5,
        atol=1e-5)
    assert torch.equal(stats.contingency_matrix(kd, od, 6, 6).cpu(),
                       stats.contingency_matrix(keys, other, 6, 6))
    for fn in ("adjusted_rand_index", "v_measure", "mutual_info_score"):
        torch.testing.assert_close(getattr(stats, fn)(kd, od, 6).cpu(),
                                   getattr(stats, fn)(keys, other, 6),
                                   rtol=1e-5, atol=1e-6)
    assert torch.equal(stats.histogram(md[:, 0] * 1.4 - 0.2, 10, 0.0,
                                       1.0).cpu(),
                       stats.histogram(m[:, 0] * 1.4 - 0.2, 10, 0.0, 1.0))
    rows = torch.tensor([0, 1, -1, 5, 2], dtype=torch.int32)
    cols = torch.tensor([1, 2, 3, 4, 9], dtype=torch.int32)
    lab = torch.arange(5, dtype=torch.int32)
    got = label.classlabels._propagate(lab.to(dev), rows.to(dev),
                                       cols.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(),
                       label.classlabels._propagate(lab, rows, cols))


def test_cuda_lstsq_rank_deficient_and_underdetermined():
    """The minimum-norm solution through the SVD on the card (its
    ``torch.linalg.lstsq`` has only ``gels``, which assumes full rank):
    equal to the CPU's within 1e-4 and to float64 numpy within 1e-3."""
    from raft_tpu_torch import linalg

    dev = cuda_device()
    rng = np.random.default_rng(7)
    cases = [rng.random((3000, 4), dtype=np.float32)[:, [0, 1, 2, 3, 0, 1]],
             rng.random((6, 40), dtype=np.float32),
             rng.random((5000, 12), dtype=np.float32)]
    for a in cases:
        b = a @ rng.random(a.shape[1], dtype=np.float32)
        got = linalg.lstsq(torch.from_numpy(a).to(dev),
                           torch.from_numpy(b).to(dev)).cpu()
        cpu = linalg.lstsq(torch.from_numpy(a), torch.from_numpy(b))
        torch.testing.assert_close(got, cpu, rtol=0, atol=1e-4)
        ref = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                              rcond=None)[0]
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)


def test_cuda_stable_argsort_ties():
    """Tied keys keep the lower index first on the card, as on the CPU:
    the Gumbel top-k helper on a heavily tied row, and the
    trustworthiness of integer-valued rows (exact distances, many ties),
    equal bit for bit."""
    from raft_tpu_torch import stats
    from raft_tpu_torch.random import generators

    dev = cuda_device()
    g = torch.tensor([float(i % 4) for i in range(5000)])
    assert torch.equal(generators._top_k_ids(g.to(dev), 700).cpu(),
                       generators._top_k_ids(g, 700))
    rng = np.random.default_rng(6)
    base = rng.integers(0, 3, (300, 5)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([base, base]))
    e = x[:, :2].contiguous()
    assert float(stats.trustworthiness_score(x.to(dev), e.to(dev), 10)) == \
        float(stats.trustworthiness_score(x, e, 10))


def test_cuda_silhouette_in_row_tiles_equals_untiled(monkeypatch):
    """The row-tiled silhouette on the card equals one tile's (rtol 1e-5:
    cuBLAS may round a product of another row count otherwise) and the
    CPU's."""
    from raft_tpu_torch import random as tr
    from raft_tpu_torch import stats
    from raft_tpu_torch.stats import metrics

    dev = cuda_device()
    x, lab = tr.make_blobs(3000, 16, n_clusters=12, cluster_std=2.0,
                           state=tr.RngState(4), device=dev)
    whole = float(stats.silhouette_score(x, lab, 12))
    monkeypatch.setattr(metrics, "_rows_per_tile", lambda n, d: 257)
    tiled = float(stats.silhouette_score(x, lab, 12))
    np.testing.assert_allclose(tiled, whole, rtol=1e-5)
    np.testing.assert_allclose(
        tiled, float(stats.silhouette_score(x.cpu(), lab.cpu(), 12)),
        rtol=1e-5)
