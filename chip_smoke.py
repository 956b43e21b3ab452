#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``raft_tpu_torch``) on one card.

    python3 chip_smoke.py [--n ROWS] [--queries M] [--seed S]

Phases (any failure exits non-zero; nothing is caught and continued):

1. probe — a CUDA card must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build — compiles every kernel from ``raft_tpu_torch/ops/csrc`` with
   ``nvcc`` (one process per source, all started together) and prints
   ptxas' registers and spill bytes of each kernel entry;
3. IVF-PQ path — DEEP-10M-shaped synthetic data (10M x 96 f32, 10,000
   centers), ``ivf_pq.build`` with 8192 lists, pq_dim 64, 8-bit codes,
   then refined search of 10,000 queries in batches of 500 (n_probes 64,
   scan_select="pallas", refine="f32_regen", refine_ratio 40, bf16 LUT)
   against the device-resident base; launch counts are zeroed just before
   and read just after, and each of its four kernels must have launched;
   checks: recall@10 against ``brute_force.knn`` on 1,000 queries (also
   with an f32 LUT), and the kernel path's recall on 200 queries against
   the plain path's (the same search on the CPU, where every wrapper runs
   its plain PyTorch version): it may be at most 0.01 lower; then its four
   kernels against their plain versions on the path's inputs
   (fused_l2_argmin bound by its design's three TF32 products, with the
   time of ``torch.matmul`` alone at full fp32 on its row and its fp32
   bound logged; the LUT scan's shared-memory look-up floor logged beside
   its bytes bound; gather_refine_topk timed with the L2 cold, beside
   its warm time, the kernel alone in a CUDA graph and the wrapper's host
   time), and a stage breakdown of one batch; then ``[filter main]``, the
   path filtered (ROADMAP A6): keep masks drawn as the JAX bench draws
   them (``bench_keep``) at selectivity 0.1 and 0.01, each leg with the
   counts zeroed just before and read just after (B1 and B2 must launch
   with their filter operands every batch), three passes of QPS, recall@10
   against ``brute_force.knn(filter_bitset=)``, no returned id with its
   bit clear, the kernel path within 0.01 of the plain path on 200
   queries; an all-pass bitset must give the unfiltered kernel path's ids
   and distances exactly; and B1 and B2 with their filter operands against
   their plain versions at selectivity 0.1 (rows ``ivf_pq_filter``);
4. IVF-Flat path — the 1M x 128 ``make_synthetic_hard`` set of the repo's
   hard_config bench (``FLAT_N`` rows, not cut), ``ivf_flat.build`` with
   1024 lists, spill, cap factor 1.5; searches of 10,000 queries (k 10)
   with scan_select="approx" at n_probes 16/32/64/128 and "exact" at 32
   (twice),
   and batch-10 and batch-1 legs at 32, with counts zeroed before the build
   and read after the last search (fused_l2_argmin, select_k and both scan
   kernels must have launched); checks: recall@10 of every leg against
   exact search, the exact grouped tier against the per_query tier, approx
   recall not falling with n_probes, and kernel path against plain path on
   200 queries; then the path's four kernels against their plain versions
   at its own shapes (both scans on the first batch's segment table,
   select_k on that batch's bin rows, fused_l2_argmin at the build's
   final k-means sweep), select_k against the stable sort at the path's
   other short-row shapes, and a stage breakdown of one approx batch;
   ``[flat filter]`` at selectivity 0.1: the exact leg at 32 (the grouped
   scan over the id table with the cleared ids at −1; it must launch) and
   the approx leg at 32 (the plain grouped tier: the segmented scan
   declines filtered searches, as in the JAX package, and must not
   launch), checked against the filtered ground truth, the filtered
   per_query tier (within 0.002) and the plain path (exact, within 0.01);
   then the IVF-PQ recon leg on the same data, queries and ground truth:
   the repo's bench config ``ivf_pq.n1024.d64`` (bench.py:211-243; 1024
   lists, pq_dim 64, spill, cap factor 1.5, the default
   ``cache_reconstruction``, whose rule builds the bf16 cache), refined
   (refine_ratio 4) approx search over the cache at n_probes 64 and 128,
   batch-10 and batch-1 legs at 64, a refined exact leg at 64, and a twin
   built with ``"never"`` whose exact leg at 32 runs the plain grouped
   tier; counts zeroed before the build and read after the twin's leg
   (the same four kernels must have launched); checks: recall@10 of every
   leg, approx recall not falling from 64 to 128, the exact leg within
   0.01 of approx at 64, the kernel path no more than 0.01 below the plain
   path on 200 queries; ``[pq filter]``: the config's filter legs, approx
   at 64 with refine_ratio 4 at selectivity 0.01, 0.1 and 0.5 (the
   segmented scan over the masked id table must launch, then the gather
   re-rank with the filter), each against its filtered ground truth, no
   id with its bit clear, and at 0.1 the plain path; then both scans
   against their plain versions on
   the n_probes 64 segment table over the bf16 cache (bounds: two TF32
   products, 2-byte rows), and a stage breakdown of one approx batch;
5. sharded path — BASELINE.md target 5's shape cut to one card: 20M x 128
   ``DeviceSynthetic`` rows (``SHARD_N``) on a 4-rank mesh whose ranks share
   cuda:0, ``parallel.build_ivf_pq`` (8192 lists, pq_dim 64, 8-bit codes,
   distributed Lloyd); counts zeroed before the build and read after leg 3
   (all six kernels of the path must have launched): leg 1 ``sharded_knn``
   of 1,000 queries with both merge tiers against single-rank
   ``brute_force.knn``; leg 2 refined search of 10,000 queries in batches of
   500 on the ring merge (QPS over three warm passes, recall@10 ≥ 0.95, the
   allgather tier giving the same ids); leg 3 the fused scan-in-ring tier at
   batch 32 against the unfused ring search (per-call latency, ids equal
   away from key ties); the kernel path's recall on 200 queries within 0.01
   of the plain path's (the same sharded search on CPU ranks); leg 4 the
   comms byte model of one batch (ring ≤ half the allgather's); then the
   ring kernels and B1–B4 against their plain versions at the path's
   shapes; ``[shard filter]`` at selectivity 0.1 over the global row ids:
   a refined batch of 500 (each rank's LUT scan with its keep bytes; the
   ring and allgather tiers equal but at ties) and the fused scan-in-ring
   tier at batch 32 with each rank's keep bytes against the filtered
   allgather tier (equal except at f32 ties, checked in f64), counts
   zeroed before and read after, and B8 with its filter operand against
   its plain version (row ``sharded_filter``). The ranks share cuda:0
   whatever the card count: the ring kernels over ranks on several cards
   are not ported yet;
6. the run's wall time, the card's line, the kernel JSON line, then
   ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# The kernels each path must launch.
PQ_KERNELS = ("fused_l2_argmin", "select_k", "ivfpq_lut_scan_topk",
              "gather_refine_topk")
FLAT_KERNELS = ("fused_l2_argmin", "select_k", "segmented_scan_topk",
                "grouped_scan_topk")
# Rows of the IVF-Flat phase: the bench's own size (bench.py:585).
FLAT_N = 1_000_000
# The sharded phase: BASELINE.md target 5's shape (SIFT-shaped 128-d rows,
# n_lists 8192, pq_dim 64, 8-bit codes) cut to one card: 20M rows on a
# 4-rank mesh, 5M a rank.
SHARD_N = 20_000_000
SHARD_DIM = 128
SHARD_RANKS = 4
SHARD_KERNELS = PQ_KERNELS + ("ring_topk_merge", "ring_lut_scan_merge")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 non-tensor rate,
# dense TF32 tensor-core rate; 132 SMs, each reading 32 shared-memory words
# a clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
N_SMS = 132
SMEM_WORDS_PER_CLOCK = 32


def _log(msg: str) -> None:
    print(msg, flush=True)


def _timed(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs after one warm-up (CUDA
    events around the whole run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed_cold(fn, reps: int, flush_mb: int = 256) -> float:
    """Mean ms of ``fn()`` with the L2 cold: a ``flush_mb`` MB buffer (over
    five times the 50 MB L2) is read before each call, and CUDA events
    bracket the call alone, so the buffer's own time is not in it (the
    host enqueues the call while the card reads the buffer). Read, not
    written: written lines would be dirty, and their write-backs would
    fall on the call."""
    import torch

    flush = torch.ones(flush_mb << 18, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / reps


def _graph_ms(fn, reps: int) -> float:
    """Mean ms of the kernels of ``fn()`` alone: ``reps`` calls captured
    in one CUDA graph, so the replay runs the launches without the
    wrapper's Python (warm: back to back on the same inputs)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = _timed(graph.replay, 3) / reps
    del graph
    return ms


def _host_ms(fn, reps: int) -> float:
    """Mean ms of the host's part of ``fn()``: the calls are enqueued
    back to back without a synchronisation (checks, allocations, the
    ctypes call), the card draining them behind."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _timed_best(fn, reps: int, rounds: int = 5) -> float:
    """The least of ``rounds`` means of ``reps`` calls (:func:`_timed`):
    for calls bound by the host, whose means swing with its load. Kernel
    and library call of one row are timed alike."""
    return min(_timed(fn, reps) for _ in range(rounds))


def _bound_ms(n_bytes: float, flops: float,
              flop_rate: float = FP32_FLOP_PER_S):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / flop_rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _sm_clock_hz() -> float:
    """The SM clock the card runs at under load, as ``nvidia-smi`` reports
    it (``clocks.max.sm``, MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def bench_keep(n: int, sel: float, k: int):
    """The JAX bench's filter-leg keep mask (raft_tpu/bench/runner.py:
    _filter_leg): a draw seeded by the selectivity keeping a ``sel`` share
    of the n rows, and at least k of them."""
    import numpy as np

    rng = np.random.default_rng(981_000 + int(round(sel, 6) * 1_000_000))
    keep = rng.random(n) < sel
    if keep.sum() < k:
        keep[rng.permutation(n)[:k]] = True
    return keep


def _check_kept(ids, keep, what):
    """No returned id may have its bit clear."""
    import numpy as np

    got = np.asarray(ids)
    got = got[got >= 0]
    if not keep[got].all():
        raise SmokeFailure(f"{what}: {int((~keep[got]).sum())} returned ids "
                           f"have their filter bit clear")
    return int((np.asarray(ids) < 0).sum())


def _recall(found, truth) -> float:
    import numpy as np

    f, t = np.asarray(found), np.asarray(truth)
    k = t.shape[1]
    return float(np.mean([len(set(a[:k]) & set(b)) / k for a, b in zip(f, t)]))


def _row(rows, path, name, src, line, n_launches, err, ms, plain_ms, nbytes,
         flops, lib_ms, shape, flop_rate=FP32_FLOP_PER_S, logged=None,
         floor_ms=None, **extra):
    """One kernel's entry of the JSON line (at one path's shapes, with
    that path's launch count), and its log line. ``flops`` run at
    ``flop_rate``; ``floor_ms``: a further operations bound (shared-memory
    look-ups), which is the bound where it is the larger; ``extra``:
    further numbers measured in this run (a yardstick), in the entry and
    the log line; ``logged``: numbers computed beside the bound (a second
    bound), in the log line only."""
    b_ms, b_by = _bound_ms(nbytes, flops, flop_rate)
    if floor_ms is not None and floor_ms > b_ms:
        b_ms, b_by = floor_ms, "operations"
    rows.append({"name": name, "path": path, "route": "cuda",
                 "source": f"raft_tpu_torch/ops/csrc/{src}",
                 "replaces": f"raft_tpu/ops/pallas_kernels.py:{line}",
                 "launches": n_launches, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms, "shape": shape,
                 **extra})
    more = "".join(f", {k} {v:.3f}" if isinstance(v, float) else f", {k} {v}"
                   for k, v in {**extra, **(logged or {})}.items())
    _log(f"[kernel] {path} {name} {shape}: max|d| {err:.3g}, {ms:.3f} ms "
         f"(plain {plain_ms:.3f} ms, library "
         f"{'-' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
         f"{b_ms:.3f} ms by {b_by}{more})")


class SmokeFailure(Exception):
    """A check of a phase failed; the script exits non-zero."""


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def _check_scan(name, tk, ti, pk, pi, seg_q, q, key_of):
    """Kernel output (tk, ti) against its plain version (pk, pi), both
    [n_seg, S, w]: the (+inf, −1) sentinel on pad slots, the same
    finite/infinite pattern on live slots, keys within 1e-4 + 1e-5·(|key| +
    ‖q‖²) (the expanded l2 form cancels ‖q‖² + ‖x‖²), and picks equal
    except where the f64 key of the kernel's pick (``key_of``) ties the
    plain key within that tolerance. Returns (max |Δkey|, pick agreement)."""
    import torch

    live = seg_q >= 0
    if not bool(torch.isinf(tk[~live]).all() and (ti[~live] == -1).all()):
        raise SmokeFailure(f"{name}: pad slots lack the sentinel")
    fin = torch.isfinite(pk) & live[..., None]
    if not torch.equal(torch.isfinite(tk) & live[..., None], fin):
        raise SmokeFailure(f"{name}: finite/infinite pattern differs")
    qsq = (q * q).sum(1)[seg_q.clamp_min(0).long()]
    tol = 1e-4 + 1e-5 * (pk.abs() + qsq[..., None])
    diff = (tk - pk).abs()[fin]
    if not bool((diff <= tol[fin]).all()):
        raise SmokeFailure(f"{name}: keys differ by {float(diff.max())}")
    bad = torch.nonzero((ti != pi) & fin, as_tuple=True)
    if bad[0].numel():
        k64 = key_of(bad[0], bad[1], ti[bad])
        if not bool(((k64 - pk[bad].double()).abs() <= tol[bad]).all()):
            raise SmokeFailure(f"{name}: picks differ away from key ties")
    agree = float((ti == pi)[fin].float().mean())
    return float(diff.max()), agree


def _argmin_row(rows, path, launches, xa, ya, shape):
    """fused_l2_argmin against its plain version on (xa, ya): distances
    within 1e-4 + 1e-5·(‖x‖² + ‖y‖²) (the expanded form cancels those
    terms), and where the argmins differ the kernel's pick must tie the
    minimum within the same tolerance; then its row."""
    import torch

    from raft_tpu_torch.ops import kernels as K

    d_k, i_k = K.fused_l2_argmin(xa, ya)
    d_p, i_p = K.fused_l2_argmin_plain(xa, ya)
    x_sq = (xa * xa).sum(1)
    y_sq = (ya * ya).sum(1)
    err = float((d_k - d_p).abs().max())
    if not bool(((d_k - d_p).abs()
                 <= 1e-4 + 1e-5 * (x_sq + y_sq[i_p.long()])).all()):
        raise SmokeFailure(f"fused_l2_argmin distances differ by {err}")
    same = i_k == i_p
    bad = ~same
    if bool(bad.any()):
        xb, yb = xa[bad], ya[i_k[bad].long()]
        d_pick = ((xb * xb).sum(1) + (yb * yb).sum(1)
                  - 2.0 * (xb * yb).sum(1)).clamp_min(0.0)
        if not bool(((d_pick - d_p[bad]).abs()
                     <= 1e-4 + 1e-5 * (x_sq[bad] + (yb * yb).sum(1))).all()):
            raise SmokeFailure("fused_l2_argmin picked a non-minimal center")
    m_, dim = xa.shape
    n_ = ya.shape[0]
    del d_k, i_k, d_p, i_p
    torch.cuda.empty_cache()
    flops = 2.0 * m_ * n_ * dim
    # the bound of the design: three TF32 products on the tensor cores;
    # that of one fp32 product on the CUDA cores (PR 1-4's row) is logged
    _row(rows, path, "fused_l2_argmin", "fused_l2_argmin.cu", 112,
         launches["fused_l2_argmin"], err,
         _timed(lambda: K.fused_l2_argmin(xa, ya), 3),
         _timed(lambda: K.fused_l2_argmin_plain(xa, ya), 1),
         (m_ + n_) * dim * 4 + m_ * 8, 3.0 * flops, None,
         f"[{m_},{dim}]x[{n_},{dim}] {shape}argmin agreement "
         f"{float(same.float().mean()):.6f}", flop_rate=TF32_FLOP_PER_S,
         logged=dict(bound_fp32_ms=flops / FP32_FLOP_PER_S * 1e3),
         matmul_fp32_ms=_product_ms(xa, ya))


def _product_ms(xa, ya, chunk: int = 1 << 16) -> float:
    """ms of ``torch.matmul(x, y.T)`` alone at full fp32 (TF32 off) over
    all of x, in row chunks whose [chunk, n] products go to one reused
    buffer: the product-alone yardstick of fused_l2_argmin (no single
    PyTorch call computes the argmin)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    yt = ya.T
    out = torch.empty((min(chunk, xa.shape[0]), ya.shape[0]),
                      dtype=torch.float32, device=xa.device)

    def run():
        for a in range(0, xa.shape[0], chunk):
            xc = xa[a:a + chunk]
            torch.matmul(xc, yt, out=out[:xc.shape[0]])

    ms = _timed(run, 1)
    del out
    torch.cuda.empty_cache()
    return ms


def _select_k_check(scores, k):
    """The select_k kernel against its plain version (a stable sort):
    values and positions must be equal. Returns (kernel ms, sort ms)."""
    import torch

    from raft_tpu_torch.ops import kernels as K

    v_k, p_k = K.select_k_cuda(scores, k)
    v_p, p_p = K.select_k_plain(scores, k)
    if not (torch.equal(v_k, v_p) and torch.equal(p_k, p_p)):
        raise SmokeFailure(f"select_k differs from its plain version at "
                           f"{list(scores.shape)} k={k}")
    return (_timed_best(lambda: K.select_k_cuda(scores, k), 100),
            _timed(lambda: K.select_k_plain(scores, k), 5))


def _select_k_row(rows, path, launches, scores, k, shape):
    import torch

    ms, plain_ms = _select_k_check(scores, k)
    _row(rows, path, "select_k", "select_k.cu", 1317, launches["select_k"],
         0.0, ms, plain_ms, scores.numel() * 4 + scores.shape[0] * k * 8, 0.0,
         _timed_best(lambda: torch.topk(scores, k, largest=False), 100),
         f"[{scores.shape[0]},{scores.shape[1]}] k={k}{shape}")


def _lut_scan_row(rows, path, launches, index, q0, n_probes, lut_dtype,
                  shape="", filter_bits=None):
    """ivfpq_lut_scan_topk against its plain version on the segment table
    of ``q0``'s coarse probes over ``index``: the [B, n_probes, 256] pair
    rows with the same filled bins, keys within 1e-3 + 1e-5·(|key| +
    ‖q‖²), ids agreeing on 99.9 % of filled bins; then its row, with the
    shared-memory look-up floor beside the bytes bound. ``filter_bits``:
    both take the keep bytes over the index's id table, and the bound
    counts the kept rows (the kernel loads nothing of a row it drops) and
    the keep bytes. Returns the scan's operands and outputs for the stage
    breakdown."""
    import torch

    from raft_tpu_torch.neighbors import ivf_common, ivf_pq, sample_filter
    from raft_tpu_torch.ops import kernels as K

    B = q0.shape[0]
    _, probes = ivf_pq._coarse_probes(index, q0, n_probes, False)
    seg = ivf_common.SEGMENT_SIZE
    n_seg = ivf_common.n_segments(B * n_probes, index.n_lists, seg)
    seg_list, seg_q, pair_seg, pair_slot = ivf_common.segment_probes(
        probes, index.n_lists, seg, n_seg)
    q_rot = (q0 @ index.rotation.T).contiguous()
    scan_args = (seg_list, seg_q, pair_seg, pair_slot, q_rot,
                 index.packed_codes, index.packed_ids, index.packed_norms,
                 index.list_sizes, index.centers_rot, index.codebooks)
    fbytes = (None if filter_bits is None else
              sample_filter.list_filter_bytes(filter_bits, index.packed_ids))
    scan_kw = dict(pq_bits=index.pq_bits, pq_dim=index.pq_dim,
                   L=index.max_list_size, lut_dtype=lut_dtype,
                   filter_bytes=fbytes)
    kk, ki = K.ivfpq_lut_scan_topk(*scan_args, "l2", **scan_kw)
    cb = K.lut_codebook(index.codebooks, lut_dtype)
    plain_args = (seg_list, pair_seg, q_rot, index.packed_codes,
                  index.packed_ids, index.packed_norms, index.list_sizes,
                  index.centers_rot, cb, "l2", index.pq_bits, fbytes)
    pk, pi = K.ivfpq_lut_scan_topk_plain(*plain_args)
    if kk.shape != (B, n_probes, K.LUT_SCAN_BINS) or kk.shape != pk.shape:
        raise SmokeFailure(f"ivfpq_lut_scan_topk: output {list(kk.shape)}, "
                           f"plain {list(pk.shape)}")
    fin = torch.isfinite(pk)
    if not torch.equal(torch.isfinite(kk), fin):
        raise SmokeFailure("ivfpq_lut_scan_topk: filled bins differ")
    if not bool((ki[~fin] == -1).all()):
        raise SmokeFailure("ivfpq_lut_scan_topk: empty bins lack the -1 id")
    diff = (kk[fin] - pk[fin]).abs()
    err = float(diff.max())
    # keys = ‖c+d‖² − 2⟨q, c+d⟩: rounding scales with ‖q‖² and the key
    q_sq = (q_rot * q_rot).sum(1)[:, None, None].expand_as(pk)
    scale = (pk.abs() + q_sq)[fin]
    if not bool((diff <= 1e-3 + 1e-5 * scale).all()):
        raise SmokeFailure(f"ivfpq_lut_scan_topk keys differ by {err}")
    id_agree = float((ki[fin] == pi[fin]).float().mean())
    if id_agree < 0.999:
        raise SmokeFailure(f"ivfpq_lut_scan_topk ids agree on {id_agree}")
    del pk, pi, fin, q_sq
    # the bound counts what this batch's data needs: codes, ids and norms
    # of the probed lists' real rows (the kernel reads no row past a
    # list's size), the lists' sizes and centers, the codebook, the
    # queries, the segment and pair tables, and the [B, P, 256] output
    live = seg_q >= 0
    lists = torch.unique(seg_list[live.any(1)].long())
    L = index.max_list_size
    sizes = index.list_sizes.long()
    n_live = int(live.sum())
    nb = index.packed_codes.shape[2]
    rows_real = int(sizes[lists].sum())
    keep_bytes = 0
    if fbytes is not None:
        # the rows a search needs are the kept real rows, and each probed
        # list's keep bytes up to its size
        kept = K.unpack_filter_bytes(fbytes, L) & (
            torch.arange(L, device=sizes.device)[None, :] < sizes[:, None])
        keep_bytes = int(((sizes[lists] + 7) // 8).sum())
        sizes = kept.sum(1)
        del kept
    rows_kept = int(sizes[lists].sum())
    pair_rows = int((live.sum(1).long() * sizes[seg_list.long()]).sum())
    scan_bytes = (rows_kept * (nb + 8) + keep_bytes + lists.numel() * (
        q_rot.shape[1] + 1) * 4 + cb.numel() * 4 + q_rot.numel() * 4
        + seg_list.numel() * 4 + seg_q.numel() * 4 + pair_seg.numel() * 8
        + kk.numel() * 8)
    # per live pair: its LUT (a multiply-add per codebook entry) and, per
    # real row, one add per subspace
    scan_flops = n_live * 2 * cb.numel() + pair_rows * index.pq_dim
    # the look-ups: pq_dim shared-memory reads per (live pair, real row),
    # 32 words a clock on each of the card's 132 SMs
    clock = _sm_clock_hz()
    floor_ms = (pair_rows * index.pq_dim
                / (SMEM_WORDS_PER_CLOCK * N_SMS * clock) * 1e3)
    b_ms, _ = _bound_ms(scan_bytes, scan_flops)
    _row(rows, path, "ivfpq_lut_scan_topk", "ivfpq_lut_scan.cu", 807,
         launches["ivfpq_lut_scan_topk"], err,
         _timed(lambda: K.ivfpq_lut_scan_topk(*scan_args, "l2", **scan_kw),
                10),
         _timed(lambda: K.ivfpq_lut_scan_topk_plain(*plain_args), 2),
         scan_bytes, scan_flops, None,
         f"{shape}n_seg {n_seg} x {seg} slots ({n_live} live pairs), L {L}, "
         f"{lists.numel()} lists of {rows_real} real rows"
         + ("" if fbytes is None else f" ({rows_kept} kept)")
         + f", {pair_rows} ({'kept ' if fbytes is not None else ''}live "
         f"pair, real row) pairs, id agreement {id_agree:.6f}",
         logged=dict(lookup_floor_ms=floor_ms, sm_clock_mhz=clock / 1e6,
                     larger_bound="lookups" if floor_ms > b_ms else "bytes"))
    return dict(kk=kk, ki=ki, probes=probes, seg=seg, n_seg=n_seg,
                q_rot=q_rot)


def _refine_row(rows, path, launches, base, q0, cand, k, shape="",
                filter_bits=None):
    """gather_refine_topk against its plain version on ``q0``'s candidates
    into ``base``: keys within 1e-5·(‖q‖² + |key|), ids equal away from key
    ties; then its row: ms with the L2 cold, beside the warm, kernel-alone
    and host times. ``filter_bits``: both take the bitset's words, and the
    bound counts the kept candidates' rows and a word a candidate."""
    import torch

    from raft_tpu_torch.neighbors import sample_filter
    from raft_tpu_torch.ops import kernels as K

    B, dim = q0.shape
    gk, gi = K.gather_refine_topk(base, q0, cand, k, "l2",
                                  filter_bits=filter_bits)
    pk2, pi2 = K.gather_refine_topk_plain(base, q0, cand, k, "l2",
                                          filter_bits)
    err = float((gk - pk2).abs().max())
    # the expanded key cancels ‖q‖² + ‖r‖²; rounding scales with it
    tol = 1e-5 * ((q0 * q0).sum(1, keepdim=True) + pk2.abs())
    if not bool(((gk - pk2).abs() <= tol).all()):
        raise SmokeFailure(f"gather_refine_topk keys differ by {err}")
    # ids may differ only where the plain keys tie within the tolerance
    # (a neighbour in the sorted list, or the k-th against the k+1-th)
    gap = (pk2[:, 1:] - pk2[:, :-1]).abs() <= tol[:, 1:]
    tie = torch.zeros_like(gap[:, :1]).expand(-1, k).clone()
    tie[:, 1:] |= gap
    tie[:, :-1] |= gap
    tie[:, -1] = True
    if not bool(((gi == pi2) | tie).all()):
        raise SmokeFailure("gather_refine_topk ids differ away from key ties")
    id_agree = float((gi == pi2).float().mean())
    C = cand.shape[1]
    call = lambda: K.gather_refine_topk(  # noqa: E731
        base, q0, cand, k, "l2", filter_bits=filter_bits)
    # the rows a re-rank needs: its valid candidates', or with a filter its
    # kept candidates' and a 4-byte word a candidate
    n_rows = int(sample_filter.masked_ids(filter_bits, cand).ge(0).sum())
    words = 0 if filter_bits is None else B * C * 4
    # what the caller sees: the rows cold (it runs after the LUT scan has
    # streamed the codes); beside it warm back-to-back calls, the kernel
    # alone (a CUDA graph of the launches) and the wrapper's host time
    _row(rows, path, "gather_refine_topk", "gather_refine.cu", 1176,
         launches["gather_refine_topk"], err, _timed_cold(call, 30),
         _timed(lambda: K.gather_refine_topk_plain(base, q0, cand, k, "l2",
                                                   filter_bits), 10),
         n_rows * dim * 4 + B * C * 4 + words + B * dim * 4 + B * k * 8,
         4.0 * n_rows * dim, None,
         f"{shape}[{B},{C}] candidates ({n_rows} rows to load) into "
         f"[{base.shape[0]},{dim}], k={k}, id agreement {id_agree:.6f}, ms "
         f"with the L2 cold",
         warm_ms=_timed(call, 50), kernel_ms=_graph_ms(call, 50),
         host_ms=_host_ms(call, 20))


def filter_main_leg(args, rows, index, base, queries, index_cpu, base_cpu,
                    sp, B, k, n_gt, n_pl):
    """The main path filtered (ROADMAP A6), on the IVF-PQ phase's index:
    keep masks drawn as the JAX bench draws them at selectivity 0.1 and
    0.01, packed with ``bitset.from_mask``, their exact ground truth from
    ``brute_force.knn(filter_bitset=)``. For each, with the counts zeroed
    just before: the refined search of every query in batches of B (three
    passes); B1 and B2 must have launched with their filter operands.
    Checks: no returned id has its bit clear, and the kernel path's recall
    on n_pl queries no more than 0.01 below the plain path's (the same
    filtered search on the CPU copy of the index). Then an all-pass
    bitset must give the unfiltered kernel path's ids and distances
    exactly, and B1 and B2 at selectivity 0.1 against their plain versions
    (their filtered rows). Raises SmokeFailure; returns the summary."""
    import torch

    from raft_tpu_torch.core import bitset
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, sample_filter
    from raft_tpu_torch.ops import kernels as K

    N, nq = base.shape[0], queries.shape[0]

    def search_pass(bits):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        start.record()
        for a in range(0, nq, B):
            out.append(ivf_pq.search(index, queries[a:a + B], k, sp,
                                     filter_bitset=bits, dataset=base)[1])
        end.record()
        torch.cuda.synchronize()
        return torch.cat(out), start.elapsed_time(end) / 1e3

    summary, kept_bits = {}, {}
    for sel in (0.1, 0.01):
        keep = bench_keep(N, sel, k)
        bits = bitset.from_mask(keep, device=base.device)
        kept_bits[sel] = bits
        _, fgt = brute_force.knn(base, queries[:n_gt], k,
                                 metric="sqeuclidean", filter_bitset=bits)
        fgt = fgt.cpu()
        K.reset_launch_counts()
        ids_f, t_f = search_pass(bits)
        launches = K.launch_counts()
        filtered = K.filtered_launch_counts()
        n_batches = -(-nq // B)
        for name in ("ivfpq_lut_scan_topk", "gather_refine_topk"):
            if filtered[name] != n_batches or launches[name] != n_batches:
                raise SmokeFailure(f"filtered main path: {name} launched "
                                   f"{launches[name]} times, {filtered[name]}"
                                   f" with its filter, for {n_batches} "
                                   f"batches")
        qps = [nq / t_f] + [nq / search_pass(bits)[1] for _ in range(2)]
        ids_f = ids_f.cpu()
        n_empty = _check_kept(ids_f, keep, f"filtered main path at {sel}")
        rec = _recall(ids_f[:n_gt], fgt)
        t0 = time.perf_counter()
        _, ids_pl = ivf_pq.search(index_cpu, queries[:n_pl].cpu(), k, sp,
                                  filter_bitset=bits.cpu(), dataset=base_cpu,
                                  device="cpu")
        _check_kept(ids_pl, keep, f"filtered plain path at {sel}")
        rec_plain = _recall(ids_pl, fgt[:n_pl])
        rec_kern = _recall(ids_f[:n_pl], fgt[:n_pl])
        _log(f"[filter main] selectivity {sel} ({int(keep.sum())} of {N} "
             f"rows kept, bitset {bits.numel() * 4 / 1e6:.2f} MB, keep bytes "
             f"{index.n_lists * ((index.max_list_size + 7) // 8) / 1e6:.2f} "
             f"MB): {nq} queries in batches of {B}, three passes (CUDA "
             f"events): " + ", ".join(f"{x:.0f}" for x in qps) + " QPS; "
             f"recall@10 {rec:.4f} on {n_gt} queries against the filtered "
             f"ground truth; {n_empty} empty slots; launches "
             f"{json.dumps(launches)}, with the filter "
             f"{json.dumps(filtered)}; {n_pl} queries: kernel path "
             f"{rec_kern:.4f}, plain path (CPU) {rec_plain:.4f} "
             f"({time.perf_counter() - t0:.1f} s)")
        if not rec_kern >= rec_plain - 0.01:
            raise SmokeFailure(f"filtered kernel-path recall {rec_kern} at "
                               f"{sel} is more than 0.01 below the plain "
                               f"path's {rec_plain}")
        summary[str(sel)] = {"kept": int(keep.sum()), "qps_runs": qps,
                             "recall_at_10": rec, "empty_slots": n_empty,
                             "recall_kernel_200": rec_kern,
                             "recall_plain_200": rec_plain,
                             "launches": launches,
                             "filtered_launches": filtered}

    # an all-pass bitset changes nothing on the kernel path
    allp = sample_filter.make_filter(N, device=base.device)
    for a in range(0, n_gt, B):
        q = queries[a:a + B]
        d0, i0 = ivf_pq.search(index, q, k, sp, dataset=base)
        d1, i1 = ivf_pq.search(index, q, k, sp, filter_bitset=allp,
                               dataset=base)
        if not (torch.equal(i0, i1) and torch.equal(d0, d1)):
            raise SmokeFailure("an all-pass filter changed the kernel path's "
                               "ids or distances")
    _log(f"[filter main] an all-pass bitset: ids and distances equal to the "
         f"unfiltered kernel path's on {n_gt} queries")

    # B1 and B2 with their filter operands at selectivity 0.1, on the
    # first batch's inputs (the filtered scan's 400 candidates)
    bits = kept_bits[0.1]
    q0 = queries[:B].contiguous()
    flaunch = summary["0.1"]["filtered_launches"]
    _lut_scan_row(rows, "ivf_pq_filter", flaunch, index, q0, sp.n_probes,
                  "bfloat16", "selectivity 0.1: ", filter_bits=bits)
    sp_scan = ivf_pq.SearchParams(**{**sp.__dict__, "refine": "none"})
    _, cand = ivf_pq.search(index, q0, 400, sp_scan, filter_bitset=bits)
    _refine_row(rows, "ivf_pq_filter", flaunch, base, q0, cand.contiguous(),
                k, "selectivity 0.1: ", filter_bits=bits)
    return summary


def flat_phase(args, rows):
    """IVF-Flat at the repo's 1M hard_config shape (bench.py:194-210,
    255-260): build, the approx legs at n_probes 16/32/64/128 and the exact
    leg at 32 (batch 10,000), small-batch legs, recall and tier checks, and
    the path's four kernels against their plain versions at its shapes.
    Raises SmokeFailure on any failed check. Returns (the base, queries and
    ground truth of the first 1,000 queries, for the IVF-PQ leg; the
    phase's summary)."""
    import numpy as np
    import torch

    from raft_tpu_torch.bench.dataset import make_synthetic_hard
    from raft_tpu_torch.neighbors import brute_force, ivf_common, ivf_flat
    from raft_tpu_torch.ops import kernels as K

    N, dim, nq, k = FLAT_N, 128, 10_000, 10
    t0 = time.perf_counter()
    ds = make_synthetic_hard("sift-1000k-hard-synth", N, dim, nq,
                             seed=args.seed)
    base = torch.from_numpy(ds.base).cuda()
    queries = torch.from_numpy(ds.queries).cuda()
    del ds
    torch.cuda.synchronize()
    _log(f"[flat data] make_synthetic_hard {N} x {dim} + {nq} queries in "
         f"{time.perf_counter() - t0:.1f} s")

    # the path: build, then every search leg; counts zeroed just before
    K.reset_launch_counts()
    stages = {}
    t0 = time.perf_counter()
    index = ivf_flat.build(base, ivf_flat.IndexParams(
        n_lists=1024, spill=True, list_size_cap_factor=1.5, seed=args.seed),
        stage_seconds=stages)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    L = index.max_list_size
    dropped = N - index.size
    _log(f"[flat build] {build_s:.2f} s ("
         + ", ".join(f"{s} {v:.2f}s" for s, v in stages.items())
         + f"); L = {L}; dropped rows {dropped}")

    def sp(n_probes, select, mode="grouped"):
        return ivf_flat.SearchParams(n_probes=n_probes, scan_mode=mode,
                                     scan_select=select)

    def timed_search(params, q):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ivf_flat.search(index, q, k, params)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / 1e3

    legs = {}
    for n_probes in (16, 32, 64, 128):
        passes = 3 if n_probes == 32 else 1
        secs = []
        for _ in range(passes):
            (_, ids), t = timed_search(sp(n_probes, "approx"), queries)
            secs.append(t)
        legs[f"approx_{n_probes}"] = {"ids": ids.cpu(),
                                      "qps": [nq / t for t in secs]}
    secs = []
    for _ in range(2):   # the first pass is the grouped tier's first call
        (_, ids), t = timed_search(sp(32, "exact"), queries)
        secs.append(t)
    legs["exact_32"] = {"ids": ids.cpu(), "qps": [nq / t for t in secs]}
    small = {}
    for bsz, n_small in ((10, 200), (1, 50)):
        lat, out = [], []
        for a in range(0, n_small, bsz):
            (_, ids), t = timed_search(sp(32, "approx", "auto"),
                                       queries[a:a + bsz])
            lat.append(t * 1e3)
            out.append(ids)
        small[bsz] = (torch.cat(out).cpu(), lat)
    launches = K.launch_counts()
    _log(f"[flat] launches {json.dumps(launches)}")
    missing = [n for n in FLAT_KERNELS if launches[n] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the IVF-Flat path: "
                           f"{missing}")
    for name, leg in legs.items():
        if leg["ids"].shape != (nq, k) or bool((leg["ids"] < 0).any()):
            raise SmokeFailure(f"IVF-Flat leg {name}: malformed id table")

    # recall against exact search, every leg
    n_gt = 1000
    _, gt = brute_force.knn(base, queries[:n_gt], k, metric="sqeuclidean")
    gt = gt.cpu()
    recall = {name: _recall(leg["ids"][:n_gt], gt)
              for name, leg in legs.items()}
    for bsz, (ids, lat) in small.items():
        recall[f"batch{bsz}_approx_32"] = _recall(ids, gt[:ids.shape[0]])
    (_, ids_pq), t_pq = timed_search(sp(32, "approx", "per_query"),
                                     queries[:n_gt])
    recall["per_query_32"] = _recall(ids_pq.cpu(), gt)
    for name, leg in legs.items():
        _log(f"[flat leg] {name}: QPS "
             + ", ".join(f"{x:.0f}" for x in leg["qps"])
             + f" (batch {nq}, CUDA events; batch ms "
             + ", ".join(f"{nq / x * 1e3:.3f}" for x in leg["qps"])
             + f"); recall@10 {recall[name]:.4f}")
    for bsz, (ids, lat) in small.items():
        _log(f"[flat leg] batch {bsz}, approx n_probes 32 (per_query tier): "
             f"{len(lat)} calls, per call ms median {np.median(lat):.3f}, "
             f"min {min(lat):.3f}, max {max(lat):.3f}; recall@10 "
             f"{recall[f'batch{bsz}_approx_32']:.4f}")
    _log(f"[flat recall] per_query tier, n_probes 32, {n_gt} queries: "
         f"{recall['per_query_32']:.4f} ({t_pq * 1e3:.1f} ms)")
    if abs(recall["exact_32"] - recall["per_query_32"]) > 0.002:
        raise SmokeFailure(f"exact grouped recall {recall['exact_32']} vs "
                           f"per_query {recall['per_query_32']}")
    curve = [recall[f"approx_{p}"] for p in (16, 32, 64, 128)]
    if any(b < a for a, b in zip(curve, curve[1:])):
        raise SmokeFailure(f"approx recall falls as n_probes rises: {curve}")

    # kernel path against the plain path: the same index on the CPU
    n_pl = 200
    t0 = time.perf_counter()
    index_cpu = ivf_flat.from_numpy(*ivf_flat.to_numpy(index), device="cpu")
    q_cpu = queries[:n_pl].cpu()
    plain_rec = {}
    for select in ("approx", "exact"):
        _, ids_pl = ivf_flat.search(index_cpu, q_cpu, k, sp(32, select),
                                    device="cpu")
        plain_rec[select] = _recall(ids_pl, gt[:n_pl])
        kern = _recall(legs[f"{select}_32"]["ids"][:n_pl], gt[:n_pl])
        _log(f"[flat recall] {select} n_probes 32, {n_pl} queries: kernel "
             f"path {kern:.4f}, plain path (CPU) {plain_rec[select]:.4f}")
        if not kern >= plain_rec[select] - 0.01:
            raise SmokeFailure(f"{select}: kernel-path recall {kern} more "
                               f"than 0.01 below the plain path's "
                               f"{plain_rec[select]}")
    _log(f"[flat recall] plain path took {time.perf_counter() - t0:.1f} s")
    filt_summary = flat_filter_leg(index, index_cpu, base, queries, k, nq,
                                   n_gt, n_pl)
    del index_cpu

    # the two scan kernels on the first batch's segment table (n_probes 32)
    n_probes, seg = 32, ivf_common.SEGMENT_SIZE
    mt = ivf_flat.resolve_metric(index.metric)
    probes = ivf_flat._probes(index, queries, n_probes, mt)
    n_seg = ivf_common.n_segments(nq * n_probes, index.n_lists, seg)
    seg_list, seg_q, pair_seg, pair_slot = ivf_common.segment_probes(
        probes, index.n_lists, seg, n_seg)
    args_k = (seg_list, seg_q, queries, index.packed_data, index.packed_ids)
    live = seg_q >= 0
    sizes = index.list_sizes.long()
    lists = torch.unique(seg_list[live.any(1)].long())
    rows_real = int(sizes[lists].sum())
    n_live = int(live.sum())
    pair_rows = int((live.sum(1).long() * sizes[seg_list.long()]).sum())
    flops = 2.0 * dim * pair_rows
    in_bytes = (rows_real * (dim * 4 + 4) + queries.numel() * 4
                + seg_list.numel() * 4 + seg_q.numel() * 4)
    shape = (f"n_seg {n_seg} x {seg} slots ({n_live} live), L {L}, "
             f"{lists.numel()} lists of {rows_real} real rows, d {dim}")
    qrow = seg_q.clamp_min(0).long()

    def l2_key64(si, sj, xrow):
        qv = queries[qrow[si, sj]].double()
        x = xrow.double()
        return ((qv - x) ** 2).sum(1)

    sk, si_ = K.segmented_scan_topk(*args_k, "l2")
    spk, spi = K.segmented_scan_topk_plain(*args_k, "l2")
    err, agree = _check_scan(
        "segmented_scan_topk", sk, si_, spk, spi, seg_q, queries,
        lambda a, b, picks: l2_key64(a, b, base[picks.long()]))
    # the bound of the design: three TF32 products (f32 lists) on the
    # tensor cores; one fp32 product on the CUDA cores (PRs 2-5's row) and
    # the bytes are logged beside it
    beside = dict(bound_fp32_ms=flops / FP32_FLOP_PER_S * 1e3)
    _row(rows, "ivf_flat", "segmented_scan_topk", "segmented_scan.cu", 397,
         launches["segmented_scan_topk"], err,
         _timed(lambda: K.segmented_scan_topk(*args_k, "l2"), 5),
         _timed(lambda: K.segmented_scan_topk_plain(*args_k, "l2"), 1),
         in_bytes + sk.numel() * 8, 3.0 * flops, None,
         shape + f", id agreement {agree:.6f}", flop_rate=TF32_FLOP_PER_S,
         logged=dict(beside, bound_bytes_ms=(in_bytes + sk.numel() * 8)
                     / HBM_BYTES_PER_S * 1e3))
    scan_ms = rows[-1]["ms"]
    del spk, spi

    gk, gp = K.grouped_scan_topk(*args_k, k, "l2")
    pgk, pgp = K.grouped_scan_topk_plain(*args_k, k, "l2")
    lst_of = seg_list.long()
    err, agree = _check_scan(
        "grouped_scan_topk", gk, gp, pgk, pgp, seg_q, queries,
        lambda a, b, picks: l2_key64(
            a, b, index.packed_data[lst_of[a], picks.long()]))
    _row(rows, "ivf_flat", "grouped_scan_topk", "grouped_scan.cu", 281,
         launches["grouped_scan_topk"], err,
         _timed(lambda: K.grouped_scan_topk(*args_k, k, "l2"), 5),
         _timed(lambda: K.grouped_scan_topk_plain(*args_k, k, "l2"), 1),
         in_bytes + gk.numel() * 8, 3.0 * flops, None,
         shape + f", kk {k}, position agreement {agree:.6f}",
         flop_rate=TF32_FLOP_PER_S,
         logged=dict(beside, bound_bytes_ms=(in_bytes + gk.numel() * 8)
                     / HBM_BYTES_PER_S * 1e3))
    del pgk, pgp, gk, gp

    # select_k on the same batch's bin rows: merge_bin_results' per-slot
    # cut, one [256] row per live pair
    cut = sk.reshape(-1, K.LUT_SCAN_BINS)[
        (pair_seg.long() * seg + pair_slot.long()).reshape(-1)]
    _select_k_row(rows, "ivf_flat", launches, cut, k,
                  ", the bin rows of n_probes 32")
    # fused_l2_argmin at the build's last k-means sweeps: the trainset
    # against all 1024 centers
    frac = ivf_flat.IndexParams().kmeans_trainset_fraction
    n_train = min(N, max(1024 * 4, int(N * frac)))
    tr = np.sort(np.random.default_rng(args.seed).choice(N, n_train,
                                                         replace=False))
    _argmin_row(rows, "ivf_flat", launches,
                base[torch.as_tensor(tr, device=base.device)],
                index.centers.contiguous(), "(trainset x centers) ")

    # select_k against the stable sort at the path's other short rows
    coarse = ivf_flat._coarse_distances(queries, index.centers, mt)[0]
    c_sq = (index.centers * index.centers).sum(1)
    # predict_topk's row tile of the build's [tile, n_lists] Gram
    tile = max(1024, min(N, (256 << 20) // (4 * index.n_lists)))
    shapes = {"coarse_probes_16": (coarse, 16),
              "coarse_probes_32": (coarse, 32),
              "coarse_probes_64": (coarse, 64),
              "coarse_probes_batch10": (coarse[:10].contiguous(), 32),
              "coarse_probes_batch1": (coarse[:1].contiguous(), 32),
              "merge_query_cut": (K.select_k_plain(cut, k)[0].reshape(
                  nq, n_probes * k), k),
              "predict_topk_tile": ((c_sq[None, :] - 2.0 * (
                  base[:tile] @ index.centers.T)).contiguous(),
                  ivf_common.SPILL_DEPTH)}
    sel_ms = {}
    for name, (scores, kq) in shapes.items():
        ms, sort_ms = _select_k_check(scores, kq)
        sel_ms[name] = {"shape": list(scores.shape), "k": kq,
                        "kernel_ms": ms, "sort_ms": sort_ms}
    _log(f"[flat select_k] kernel against the stable sort, values and "
         f"positions equal: {json.dumps(sel_ms)}")
    del cut, coarse, shapes, scores

    # where one approx batch's time goes (n_probes 32), each stage alone
    stages_ms = {
        "coarse_probes": _timed(lambda: ivf_flat._probes(
            index, queries, n_probes, mt), 10),
        "segment_probes": _timed(lambda: ivf_common.segment_probes(
            probes, index.n_lists, seg, n_seg), 10),
        "segmented_scan": scan_ms,
        "merge_bin_results": _timed(lambda: ivf_common.merge_bin_results(
            sk, si_, pair_seg, pair_slot, k, True, float("inf")), 5),
        "search_total": _timed(lambda: ivf_flat.search(
            index, queries, k, sp(32, "approx")), 3),
    }
    _log(f"[flat stages] one approx batch of {nq} queries at n_probes 32, "
         f"ms: {json.dumps(stages_ms)}")
    bin_bytes = {p: ivf_common.n_segments(nq * p, index.n_lists, seg) * seg
                 * K.LUT_SCAN_BINS * 8 for p in (16, 32, 64, 128)}
    data = {"base": base, "queries": queries, "gt": gt}
    return data, {"n": N, "dim": dim, "n_lists": 1024, "max_list_size": L,
            "dropped_rows": dropped, "build_s": build_s,
            "build_stages_s": stages,
            "qps": {name: leg["qps"] for name, leg in legs.items()},
            "small_batch_ms": {bsz: lat for bsz, (_, lat) in small.items()},
            "recall_at_10": recall, "recall_plain_200": plain_rec,
            "bin_table_bytes": bin_bytes, "batch_stages_ms": stages_ms,
            "select_k_ms": sel_ms, "launches": launches,
            "filter": filt_summary}


def flat_filter_leg(index, index_cpu, base, queries, k, nq, n_gt, n_pl):
    """IVF-Flat filtered (ROADMAP A6), on the IVF-Flat phase's index, the
    bench's keep mask at selectivity 0.1: the exact leg at n_probes 32
    (the grouped scan over the id table with the cleared ids set to −1:
    B6 must launch) and the approx leg at n_probes 32 (the plain grouped
    tier: the segmented scan declines filtered searches, as in the JAX
    package, so B5 must not launch), two passes each with the counts
    zeroed before the legs and read after. Checks: no returned id has
    its bit clear; recall@10 against the filtered ground truth; the exact
    leg within 0.002 of the filtered per_query tier; the exact leg's
    kernel path no more than 0.01 below the plain path on n_pl queries.
    Raises SmokeFailure; returns the summary."""
    import torch

    from raft_tpu_torch.core import bitset
    from raft_tpu_torch.neighbors import brute_force, ivf_flat
    from raft_tpu_torch.ops import kernels as K

    N, sel = base.shape[0], 0.1
    keep = bench_keep(N, sel, k)
    bits = bitset.from_mask(keep, device=base.device)
    _, fgt = brute_force.knn(base, queries[:n_gt], k, metric="sqeuclidean",
                             filter_bitset=bits)
    fgt = fgt.cpu()

    def timed_search(params, q):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ivf_flat.search(index, q, k, params, filter_bitset=bits)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / 1e3

    legs, launches = {}, {}
    for select in ("exact", "approx"):
        params = ivf_flat.SearchParams(n_probes=32, scan_mode="grouped",
                                       scan_select=select)
        K.reset_launch_counts()
        secs = []
        for _ in range(2):
            (_, ids), t = timed_search(params, queries)
            secs.append(t)
        launches[select] = K.launch_counts()
        ids = ids.cpu()
        n_empty = _check_kept(ids, keep, f"filtered IVF-Flat {select}")
        legs[select] = {"qps": [nq / t for t in secs],
                        "recall_at_10": _recall(ids[:n_gt], fgt),
                        "empty_slots": n_empty}
        legs[select]["ids"] = ids
    if launches["exact"]["grouped_scan_topk"] != 2:
        raise SmokeFailure(f"filtered exact leg: the grouped scan launched "
                           f"{launches['exact']['grouped_scan_topk']} times "
                           f"for 2 searches")
    if launches["approx"]["segmented_scan_topk"] != 0:
        raise SmokeFailure("filtered approx leg launched the segmented scan, "
                           "which declines filtered searches")
    (_, ids_pq), _ = timed_search(ivf_flat.SearchParams(
        n_probes=32, scan_mode="per_query"), queries[:n_gt])
    rec_pq = _recall(ids_pq.cpu(), fgt)
    _check_kept(ids_pq.cpu(), keep, "filtered IVF-Flat per_query")
    _, ids_pl = ivf_flat.search(index_cpu, queries[:n_pl].cpu(), k,
                                ivf_flat.SearchParams(n_probes=32,
                                                      scan_mode="grouped",
                                                      scan_select="exact"),
                                filter_bitset=bits.cpu(), device="cpu")
    rec_plain = _recall(ids_pl, fgt[:n_pl])
    rec_kern = _recall(legs["exact"]["ids"][:n_pl], fgt[:n_pl])
    for select, leg in legs.items():
        tier = ("the grouped scan over the masked id table" if select ==
                "exact" else "the plain grouped tier")
        _log(f"[flat filter] {select} n_probes 32, selectivity {sel} "
             f"({int(keep.sum())} of {N} rows kept; {tier}): QPS "
             + ", ".join(f"{x:.0f}" for x in leg["qps"])
             + f" (batch {nq}, CUDA events); recall@10 "
             f"{leg['recall_at_10']:.4f} against the filtered ground truth; "
             f"{leg['empty_slots']} empty slots; launches "
             f"{json.dumps(launches[select])}")
        del leg["ids"]
    _log(f"[flat filter] per_query tier n_probes 32 filtered: recall@10 "
         f"{rec_pq:.4f}; exact leg on {n_pl} queries: kernel path "
         f"{rec_kern:.4f}, plain path (CPU) {rec_plain:.4f}")
    if abs(legs["exact"]["recall_at_10"] - rec_pq) > 0.002:
        raise SmokeFailure(f"filtered exact grouped recall "
                           f"{legs['exact']['recall_at_10']} vs per_query "
                           f"{rec_pq}")
    if not rec_kern >= rec_plain - 0.01:
        raise SmokeFailure(f"filtered exact kernel-path recall {rec_kern} "
                           f"more than 0.01 below the plain path's "
                           f"{rec_plain}")
    return {"selectivity": sel, "legs": legs, "recall_per_query": rec_pq,
            "recall_kernel_200": rec_kern, "recall_plain_200": rec_plain,
            "launches": launches}


def pq_recon_phase(args, rows, base, queries, gt):
    """IVF-PQ over its bf16 reconstruction cache: the repo's bench config
    ``ivf_pq.n1024.d64`` (bench.py:211-243) on the IVF-Flat phase's 1M x
    128 hard data. Build (1024 lists, pq_dim 64, spill, cap factor 1.5,
    the default cache rule), refined approx search (segmented scan over
    the cache) at n_probes 64 and 128 with refine_ratio 4, batch-10 and
    batch-1 legs at 64, a refined exact leg at 64 (the grouped scan over
    the cache, kk 40), and a twin built with cache_reconstruction="never"
    whose exact leg at 32 runs the plain grouped tier on codes decoded a
    chunk at a time. Counts are zeroed before the build and read after
    the twin's leg. Checks: recall@10 of every leg, approx recall not
    falling from 64 to 128, the exact leg within 0.01 of the approx leg
    at 64, and the kernel path no more than 0.01 below the plain path on
    200 queries; then B5 and B6 against their plain versions on the
    n_probes 64 segment table. Raises SmokeFailure; returns the summary."""
    import numpy as np
    import torch

    from raft_tpu_torch.neighbors import brute_force, ivf_common, ivf_pq
    from raft_tpu_torch.neighbors import refine as trefine
    from raft_tpu_torch.ops import kernels as K

    N, dim = base.shape
    nq, k, n_gt = queries.shape[0], 10, gt.shape[0]
    params = dict(n_lists=1024, pq_dim=64, spill=True,
                  list_size_cap_factor=1.5, seed=args.seed)

    def sp(n_probes, select, mode="auto"):
        return ivf_pq.SearchParams(n_probes=n_probes, scan_mode=mode,
                                   scan_select=select, refine="f32_regen",
                                   refine_ratio=4)

    def timed_search(idx, params_, q):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ivf_pq.search(idx, q, k, params_, dataset=base)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / 1e3

    # the path: the build, every leg and the twin; counts zeroed just before
    K.reset_launch_counts()
    stages = {}
    t0 = time.perf_counter()
    index = ivf_pq.build(base, ivf_pq.IndexParams(**params),
                         stage_seconds=stages)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if index.packed_recon is None:
        raise SmokeFailure("the default build made no recon cache")
    L = index.max_list_size
    recon_gb = index.packed_recon.numel() * 2 / 1e9
    _log(f"[pq build] ivf_pq.n1024.d64 on {N} x {dim}: {build_s:.2f} s ("
         + ", ".join(f"{s_} {v:.2f}s" for s_, v in stages.items())
         + f"); L = {L}; dropped rows {N - index.size}; bf16 recon cache "
         f"{list(index.packed_recon.shape)} = {recon_gb:.3f} GB")
    legs = {}
    for name, n_probes, select, passes in (("approx_64", 64, "approx", 2),
                                           ("approx_128", 128, "approx", 1),
                                           ("exact_64", 64, "exact", 2)):
        secs = []
        for _ in range(passes):
            (_, ids), t = timed_search(index, sp(n_probes, select), queries)
            secs.append(t)
        legs[name] = {"ids": ids.cpu(), "qps": [nq / t for t in secs]}
    small = {}
    for bsz, n_small in ((10, 200), (1, 50)):
        lat, out = [], []
        for a in range(0, n_small, bsz):
            (_, ids), t = timed_search(index, sp(64, "approx"),
                                       queries[a:a + bsz])
            lat.append(t * 1e3)
            out.append(ids)
        small[bsz] = (torch.cat(out).cpu(), lat)
    t0 = time.perf_counter()
    twin = ivf_pq.build(base, ivf_pq.IndexParams(
        **params, cache_reconstruction="never"))
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    secs = []
    for _ in range(2):
        (_, ids), t = timed_search(twin, sp(32, "exact", "grouped"), queries)
        secs.append(t)
    legs["never_exact_32"] = {"ids": ids.cpu(), "qps": [nq / t for t in secs]}
    del twin
    launches = K.launch_counts()
    _log(f"[pq] launches {json.dumps(launches)}")
    missing = [n for n in FLAT_KERNELS if launches[n] == 0]   # the same four
    if missing:
        raise SmokeFailure(f"kernels never launched on the IVF-PQ recon "
                           f"path: {missing}")
    for name, leg in legs.items():
        if leg["ids"].shape != (nq, k) or bool((leg["ids"] < 0).any()):
            raise SmokeFailure(f"IVF-PQ leg {name}: malformed id table")

    recall = {name: _recall(leg["ids"][:n_gt], gt)
              for name, leg in legs.items()}
    for bsz, (ids, lat) in small.items():
        recall[f"batch{bsz}_approx_64"] = _recall(ids, gt[:ids.shape[0]])
    for name, leg in legs.items():
        _log(f"[pq leg] {name}: QPS "
             + ", ".join(f"{x:.0f}" for x in leg["qps"])
             + f" (batch {nq}, refine_ratio 4, CUDA events; batch ms "
             + ", ".join(f"{nq / x * 1e3:.3f}" for x in leg["qps"])
             + f"); recall@10 {recall[name]:.4f}")
    for bsz, (ids, lat) in small.items():
        _log(f"[pq leg] batch {bsz}, approx n_probes 64 (per_query tier): "
             f"{len(lat)} calls, per call ms median {np.median(lat):.3f}, "
             f"min {min(lat):.3f}, max {max(lat):.3f}; recall@10 "
             f"{recall[f'batch{bsz}_approx_64']:.4f}")
    _log(f"[pq build] the cache_reconstruction='never' twin: {twin_s:.2f} s")
    if recall["approx_128"] < recall["approx_64"]:
        raise SmokeFailure(f"approx recall falls from n_probes 64 to 128: "
                           f"{recall['approx_64']} -> {recall['approx_128']}")
    if abs(recall["exact_64"] - recall["approx_64"]) > 0.01:
        raise SmokeFailure(f"exact recall {recall['exact_64']} is not within "
                           f"0.01 of approx {recall['approx_64']} at 64")

    # kernel path against the plain path: the same index on the CPU (the
    # cache rebuilt there from the codes), the same refined approx search
    n_pl = 200
    t0 = time.perf_counter()
    index_cpu = ivf_pq.from_numpy(*ivf_pq.to_numpy(index), device="cpu")
    t_cache = time.perf_counter() - t0
    base_cpu = base.cpu()
    _, ids_pl = ivf_pq.search(index_cpu, queries[:n_pl].cpu(), k,
                              sp(64, "approx", "grouped"),
                              dataset=base_cpu, device="cpu")
    rec_plain = _recall(ids_pl, gt[:n_pl])
    rec_kern = _recall(legs["approx_64"]["ids"][:n_pl], gt[:n_pl])
    _log(f"[pq recall] approx n_probes 64, {n_pl} queries: kernel path "
         f"{rec_kern:.4f}, plain path (CPU) {rec_plain:.4f} ("
         f"{time.perf_counter() - t0:.1f} s, {t_cache:.1f} s of it the "
         f"index and its cache on the CPU)")
    if not rec_kern >= rec_plain - 0.01:
        raise SmokeFailure(f"IVF-PQ recon kernel-path recall {rec_kern} more "
                           f"than 0.01 below the plain path's {rec_plain}")

    # [pq filter]: the bench config's filter legs (bench.py:228-238),
    # approx at n_probes 64, refine_ratio 4, at selectivity 0.01, 0.1, 0.5
    from raft_tpu_torch.core import bitset

    filt = {}
    for sel in (0.01, 0.1, 0.5):
        keep = bench_keep(N, sel, k)
        bits = bitset.from_mask(keep, device=base.device)
        _, fgt = brute_force.knn(base, queries[:n_gt], k,
                                 metric="sqeuclidean", filter_bitset=bits)
        fgt = fgt.cpu()
        K.reset_launch_counts()
        secs = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, ids = ivf_pq.search(index, queries, k, sp(64, "approx"),
                                   filter_bitset=bits, dataset=base)
            end.record()
            torch.cuda.synchronize()
            secs.append(start.elapsed_time(end) / 1e3)
        fl = K.launch_counts()
        if fl["segmented_scan_topk"] != 2 or fl["grouped_scan_topk"]:
            raise SmokeFailure(f"filtered recon leg at {sel} did not take "
                               f"the segmented scan over the masked id "
                               f"table: {fl}")
        ids = ids.cpu()
        n_empty = _check_kept(ids, keep, f"filtered recon leg at {sel}")
        rec = _recall(ids[:n_gt], fgt)
        line = (f"[pq filter] approx n_probes 64, refine_ratio 4, "
                f"selectivity {sel} ({int(keep.sum())} of {N} rows kept): "
                f"QPS " + ", ".join(f"{nq / t:.0f}" for t in secs)
                + f" (batch {nq}, CUDA events); recall@10 {rec:.4f} against "
                f"the filtered ground truth; {n_empty} empty slots; "
                f"launches {json.dumps(fl)}")
        filt[str(sel)] = {"qps": [nq / t for t in secs], "recall_at_10": rec,
                          "empty_slots": n_empty, "launches": fl}
        if sel == 0.1:
            _, ids_pl = ivf_pq.search(index_cpu, queries[:n_pl].cpu(), k,
                                      sp(64, "approx", "grouped"),
                                      filter_bitset=bits.cpu(),
                                      dataset=base_cpu, device="cpu")
            f_plain = _recall(ids_pl, fgt[:n_pl])
            f_kern = _recall(ids[:n_pl], fgt[:n_pl])
            line += (f"; {n_pl} queries: kernel path {f_kern:.4f}, plain "
                     f"path (CPU) {f_plain:.4f}")
            filt[str(sel)].update(recall_kernel_200=f_kern,
                                  recall_plain_200=f_plain)
            if not f_kern >= f_plain - 0.01:
                raise SmokeFailure(f"filtered recon kernel-path recall "
                                   f"{f_kern} more than 0.01 below the "
                                   f"plain path's {f_plain}")
        _log(line)
    del index_cpu, base_cpu

    # B5 and B6 on the n_probes 64 segment table over the bf16 cache
    n_probes, seg = 64, ivf_common.SEGMENT_SIZE
    _, probes = ivf_pq._coarse_probes(index, queries, n_probes, False)
    n_seg = ivf_common.n_segments(nq * n_probes, index.n_lists, seg)
    seg_list, seg_q, pair_seg, pair_slot = ivf_common.segment_probes(
        probes, index.n_lists, seg, n_seg)
    q_rot = (queries @ index.rotation.T).contiguous()
    rot = q_rot.shape[1]
    args_k = (seg_list, seg_q, q_rot, index.packed_recon, index.packed_ids)
    live = seg_q >= 0
    sizes = index.list_sizes.long()
    lists = torch.unique(seg_list[live.any(1)].long())
    rows_real = int(sizes[lists].sum())
    n_live = int(live.sum())
    pair_rows = int((live.sum(1).long() * sizes[seg_list.long()]).sum())
    # the bf16 design: two TF32 products per (live pair, real row), and
    # the cache's real rows at 2 bytes a feature
    flops = 2.0 * 2.0 * rot * pair_rows
    in_bytes = (rows_real * (rot * 2 + 4) + q_rot.numel() * 4
                + seg_list.numel() * 4 + seg_q.numel() * 4)
    shape = (f"bf16 recon cache: n_seg {n_seg} x {seg} slots ({n_live} "
             f"live), L {L}, {lists.numel()} lists of {rows_real} real rows, "
             f"d {rot}")
    qrow = seg_q.clamp_min(0).long()
    flat_recon = index.packed_recon.view(-1, rot)
    valid = index.packed_ids.view(-1) >= 0
    slot_of = torch.full((N,), -1, dtype=torch.long, device=base.device)
    slot_of[index.packed_ids.view(-1)[valid].long()] = torch.nonzero(
        valid).flatten()

    def l2_key64(si, sj, xrow):
        qv = q_rot[qrow[si, sj]].double()
        return ((qv - xrow.double()) ** 2).sum(1)

    sk, si_ = K.segmented_scan_topk(*args_k, "l2")
    spk, spi = K.segmented_scan_topk_plain(*args_k, "l2")
    err, agree = _check_scan(
        "segmented_scan_topk (recon)", sk, si_, spk, spi, seg_q, q_rot,
        lambda a, b, picks: l2_key64(a, b, flat_recon[slot_of[picks.long()]]))
    beside = dict(bound_bytes_ms=in_bytes / HBM_BYTES_PER_S * 1e3)
    _row(rows, "ivf_pq_recon", "segmented_scan_topk", "segmented_scan.cu",
         397, launches["segmented_scan_topk"], err,
         _timed(lambda: K.segmented_scan_topk(*args_k, "l2"), 5),
         _timed(lambda: K.segmented_scan_topk_plain(*args_k, "l2"), 1),
         in_bytes + sk.numel() * 8, flops, None,
         shape + f", id agreement {agree:.6f}", flop_rate=TF32_FLOP_PER_S,
         logged=beside)
    scan_ms = rows[-1]["ms"]
    del spk, spi
    kk = 4 * k
    gk, gp = K.grouped_scan_topk(*args_k, kk, "l2")
    pgk, pgp = K.grouped_scan_topk_plain(*args_k, kk, "l2")
    lst_of = seg_list.long()
    err, agree = _check_scan(
        "grouped_scan_topk (recon)", gk, gp, pgk, pgp, seg_q, q_rot,
        lambda a, b, picks: l2_key64(
            a, b, index.packed_recon[lst_of[a], picks.long()]))
    _row(rows, "ivf_pq_recon", "grouped_scan_topk", "grouped_scan.cu", 281,
         launches["grouped_scan_topk"], err,
         _timed(lambda: K.grouped_scan_topk(*args_k, kk, "l2"), 5),
         _timed(lambda: K.grouped_scan_topk_plain(*args_k, kk, "l2"), 1),
         in_bytes + gk.numel() * 8, flops, None,
         shape + f", kk {kk}, position agreement {agree:.6f}",
         flop_rate=TF32_FLOP_PER_S, logged=beside)
    del pgk, pgp, gk, gp, slot_of

    # where one approx batch's time goes (n_probes 64, k_cand 40), each
    # stage alone (CUDA events)
    sp_scan = ivf_pq.SearchParams(n_probes=64, scan_mode="grouped",
                                  scan_select="approx")
    _, cand = ivf_pq.search(index, queries, 4 * k, sp_scan)
    stages_ms = {
        "coarse_probes": _timed(lambda: ivf_pq._coarse_probes(
            index, queries, n_probes, False), 10),
        "segment_probes": _timed(lambda: ivf_common.segment_probes(
            probes, index.n_lists, seg, n_seg), 10),
        "rotate": _timed(lambda: queries @ index.rotation.T, 10),
        "segmented_scan": scan_ms,
        "merge_bin_results": _timed(lambda: ivf_common.merge_bin_results(
            sk, si_, pair_seg, pair_slot, 4 * k, True, float("inf")), 5),
        "refine": _timed(lambda: trefine.refine(base, queries, cand, k), 5),
        "search_total": _timed(lambda: ivf_pq.search(
            index, queries, k, sp(64, "approx", "grouped"), dataset=base), 3),
    }
    _log(f"[pq stages] one refined approx batch of {nq} queries at n_probes "
         f"64, ms: {json.dumps(stages_ms)}")
    return {"n": N, "dim": dim, "n_lists": 1024, "pq_dim": 64,
            "max_list_size": L, "dropped_rows": N - index.size,
            "recon_cache_gb": recon_gb, "build_s": build_s,
            "build_stages_s": stages, "twin_build_s": twin_s,
            "qps": {name: leg["qps"] for name, leg in legs.items()},
            "small_batch_ms": {bsz: lat for bsz, (_, lat) in small.items()},
            "recall_at_10": recall, "recall_kernel_200": rec_kern,
            "recall_plain_200": rec_plain, "batch_stages_ms": stages_ms,
            "launches": launches, "filter": filt}


def _ring_topk_row(rows, path, launches, vals, gids, k, shape):
    """ring_topk_merge against its plain version (the plain ring schedule,
    on the same card) on per-rank [m, k] tables: values and ids equal;
    then its row. The library column is torch.topk over the [n·mc, 2k]
    incoming ++ local blocks of every rank, one call a hop."""
    import torch

    from raft_tpu_torch.ops import kernels as K

    n = len(vals)
    m, kin = vals[0].shape
    mc = K.ring_chunk_rows(m, n)
    kv, ki = K.ring_topk_merge(vals, gids, k)
    prep = [K._ring_keys(v, i, mc * n, True) for v, i in zip(vals, gids)]
    keys = [p[0] for p in prep]
    tids = [p[1] for p in prep]
    pv, pi = K.ring_topk_merge_plain(keys, tids, k, mc)
    for r in range(n):
        if not (torch.equal(kv[r], pv[r]) and torch.equal(ki[r], pi[r])):
            raise SmokeFailure(f"ring_topk_merge differs from its plain "
                               f"version on rank {r} ({shape})")
    cat = torch.cat([torch.cat([pv[r], keys[r][:mc, :k]], 1)
                     for r in range(n)]).contiguous()
    # each rank's table read once, the [n, mc, k] result written once
    nbytes = n * m * kin * 8 + n * mc * k * 8
    _row(rows, path, "ring_topk_merge", "ring_topk.cu", 1581,
         launches["ring_topk_merge"], 0.0,
         _timed_best(lambda: K.ring_topk_merge(vals, gids, k), 100),
         _timed(lambda: K.ring_topk_merge_plain(keys, tids, k, mc), 5),
         nbytes, 0.0,
         _timed_best(lambda: [torch.topk(cat, k, largest=False)
                              for _ in range(n - 1)], 100),
         f"{n} ranks of [{m},{kin}] tables, mc {mc}, k {k}, one launch a "
         f"call ({shape})")


def _adc_key64(index, qv_row, gid):
    """f64 ADC key (‖c+d‖² − 2⟨q, c+d⟩) of global id ``gid`` for the
    rotated query ``qv_row``, found in whichever shard holds it."""
    import torch

    from raft_tpu_torch.ops import kernels as K

    for r in range(index.n_shards):
        hit = torch.nonzero(index.packed_ids[r] == int(gid))
        if hit.shape[0]:
            lst, pos = int(hit[0, 0]), int(hit[0, 1])
            code = K.unpack_codes(index.packed_codes[r][lst, pos],
                                  index.pq_dim, index.pq_bits)
            cb = index.codebooks[r].double()
            S, _, P = cb.shape
            q = qv_row.double()
            lut = torch.einsum("sp,skp->sk", q.view(S, P), cb)
            dot = q @ index.centers_rot[r][lst].double() + lut[
                torch.arange(S, device=cb.device), code].sum()
            return float(index.packed_norms[r][lst, pos]) - 2.0 * float(dot)
    raise SmokeFailure(f"id {gid} is in no shard")


def _ring_lut_scan_row(rows, path, launches, index, q, k, n_probes, mesh,
                       shape, filter_bits=None):
    """ring_lut_scan_merge against its plain version (on the same card) on
    one batch's chunk tables: the same finite pattern, keys within
    1e-5·(|key| + ‖q‖²) (the f32 rounding of an ADC key and its expanded
    form, as leg 3 and the LUT scan's check allow), ids equal away from key
    ties (the f64 key of the kernel's pick within that tolerance); then its
    row, with the largest difference beside its limit. ``filter_bits``
    (global row ids): each rank's keep bytes over its own id table, and
    the bound counts the kept rows and the keep bytes."""
    import torch

    from raft_tpu_torch.neighbors import sample_filter
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.parallel import ivf as pivf

    ops = pivf._fused_ring_operands(index, q, n_probes, mesh, False)
    lists, ind, qv, packed, ids, norms, sizes_r, ctr, cbs = ops
    fbytes = (None if filter_bits is None else
              [sample_filter.list_filter_bytes(filter_bits, t) for t in ids])
    kw = dict(pq_bits=index.pq_bits, pq_dim=index.pq_dim,
              L=index.max_list_size, lut_dtype="float32",
              filter_bytes=fbytes)
    tk, ti = K.ring_lut_scan_merge(*ops, k, "l2", **kw)
    n = len(packed)
    mc = qv[0].shape[1]
    cb = [K.lut_codebook(c, "float32") for c in cbs]
    rows_i = torch.arange(mc, device=q.device, dtype=torch.int32)
    seg_q = [torch.where(i > 0.5, rows_i, -1).to(torch.int32).contiguous()
             for i in ind]
    plain = lambda: K.ring_lut_scan_merge_plain(  # noqa: E731
        lists, seg_q, qv, packed, ids, norms, sizes_r, ctr, cb, k, "l2",
        index.pq_bits, fbytes)
    pk, pi = plain()
    err, worst, n_tie = 0.0, 0.0, 0
    for r in range(n):
        a, b = tk[r], pk[r]
        if not torch.equal(torch.isinf(a), torch.isinf(b)):
            raise SmokeFailure(f"ring_lut_scan_merge: filled slots differ "
                               f"on rank {r}")
        fin = torch.isfinite(b)
        qsq = (qv[r][r] * qv[r][r]).sum(1)[:, None].expand_as(b)
        tol = 1e-5 * (b.abs() + qsq)
        diff = (a - b).abs()
        if not bool((diff[fin] <= tol[fin]).all()):
            raise SmokeFailure(f"ring_lut_scan_merge keys differ by "
                               f"{float(diff[fin].max())} on rank {r}")
        if bool(fin.any()):
            err = max(err, float(diff[fin].max()))
            worst = max(worst, float((diff[fin] / tol[fin]).max()))
        for row, j in torch.nonzero((ti[r] != pi[r]) & fin).tolist():
            k64 = _adc_key64(index, qv[r][r, row], ti[r][row, j])
            if abs(k64 - float(b[row, j])) > float(tol[row, j]):
                raise SmokeFailure(f"ring_lut_scan_merge picks differ away "
                                   f"from key ties (rank {r}, row {row})")
            n_tie += 1
    # the bound: per (rank, chunk) the codes, ids and norms of the union
    # lists' real rows, their centers, the chunk tables and queries, the
    # outputs once; beside it the look-up floor, pq_dim shared-memory words
    # per (member pair, real row) at 32 words a clock on each of 132 SMs,
    # which is the bound where it is the larger. Operations: a LUT per
    # (rank, chunk row) and an add per subspace per (member pair, real row)
    nb = packed[0].shape[2]
    S, Kc, P = cbs[0].shape
    L = index.max_list_size
    n_bytes, flops, n_pairs, pair_rows = n * mc * k * 8, 0.0, 0, 0
    for r in range(n):
        sizes = index.list_sizes[r].long()
        kept = sizes
        if fbytes is not None:
            kept = (K.unpack_filter_bytes(fbytes[r], L) & (torch.arange(
                L, device=sizes.device)[None, :] < sizes[:, None])).sum(1)
        n_bytes += cbs[r].numel() * 4
        for c in range(n):
            lst = lists[r][c]
            real = lst >= 0
            lsz = torch.where(real, kept[lst.clamp_min(0).long()], 0)
            members = ind[r][c].sum(1)
            pr = int((members * lsz).sum())
            n_pairs += int(members.sum())
            pair_rows += pr
            n_bytes += (int(lsz.sum()) * (nb + 8) + int(real.sum())
                        * ctr[r].shape[1] * 4 + qv[r][c].numel() * 4
                        + ind[r][c].numel() * 4 + lst.numel() * 4)
            if fbytes is not None:   # the union lists' keep bytes
                n_bytes += int(((torch.where(real, sizes[lst.clamp_min(
                    0).long()], 0) + 7) // 8).sum())
            flops += (float((ind[r][c].sum(0) > 0).sum()) * 2 * S * Kc * P
                      + pr * S)
    clock = _sm_clock_hz()
    floor_ms = pair_rows * S / (SMEM_WORDS_PER_CLOCK * N_SMS * clock) * 1e3
    b_ms, _ = _bound_ms(n_bytes, flops)
    # the wrapper's host time a call: checks, the codebook cache, the
    # pointer table, one ctypes call (the card idle, no sync in the loop)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        K.ring_lut_scan_merge(*ops, k, "l2", **kw)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    _row(rows, path, "ring_lut_scan_merge", "ring_lut_scan.cu", 2010,
         launches["ring_lut_scan_merge"], err,
         _timed(lambda: K.ring_lut_scan_merge(*ops, k, "l2", **kw), 10),
         _timed(plain, 1), n_bytes, flops, None,
         f"{n} ranks, {q.shape[0]} queries (mc {mc}), NS "
         f"{lists[0].shape[1]}, {n_pairs} member pairs, {pair_rows} (member "
         f"pair, {'kept ' if fbytes is not None else ''}real row) pairs, "
         f"k {k}, two launches a call, {n_tie} picks "
         f"differ at f64 key ties, largest |dkey| {err:.3g} = {worst:.3f} of "
         f"its limit 1e-5*(|key|+|q|^2) ({shape})",
         floor_ms=floor_ms, host_ms=host_ms,
         logged=dict(lookup_floor_ms=floor_ms, bytes_bound_ms=b_ms,
                     sm_clock_mhz=clock / 1e6))


def _swaps_are_ties(queries, base, ids_a, ids_b, what):
    """Where two [m, k] id tables differ, the two picks must tie: their f64
    squared distances to the query agree within the f32 expanded form's
    rounding, 1e-4 + 1e-5·(‖q‖² + ‖x‖²). The ring breaks a tie by ring
    order, brute force and the allgather by row id. Returns the count."""
    import torch

    bad = torch.nonzero(ids_a != ids_b).tolist()
    for row, j in bad:
        q64 = queries[row].double()
        xa = base[ids_a[row, j]].double()
        xb = base[ids_b[row, j]].double()
        d_a = float(((q64 - xa) ** 2).sum())
        d_b = float(((q64 - xb) ** 2).sum())
        if abs(d_a - d_b) > 1e-4 + 1e-5 * float((q64 * q64).sum()
                                                + (xb * xb).sum()):
            raise SmokeFailure(f"{what}: ids differ away from ties (query "
                               f"{row}: {d_a} vs {d_b})")
    return len(bad)


def sharded_phase(args, rows):
    """The sharded tier on a 4-rank mesh whose ranks share one card:
    distributed build, sharded kNN (leg 1), refined sharded search on the
    ring merge (leg 2), the fused scan-in-ring tier (leg 3), the comms byte
    model (leg 4), then the path's kernels against their plain versions at
    its shapes.
    Raises SmokeFailure on any failed check. Returns the summary."""
    import numpy as np
    import torch

    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import brute_force, ivf_pq
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.parallel import comms, make_mesh
    from raft_tpu_torch.parallel import ivf as pivf
    from raft_tpu_torch.parallel import knn as pknn

    N, dim, nq, k, B = SHARD_N, SHARD_DIM, 10_000, 10, 500
    dev = torch.device("cuda", 0)
    mesh = make_mesh(SHARD_RANKS, device="cuda:0")
    t0 = time.perf_counter()
    ds = DeviceSynthetic(N, dim, n_centers=10_000, seed=args.seed, std=0.5,
                         scale=10.0, device=dev)
    base = ds.base()
    queries = ds.queries(nq)
    torch.cuda.synchronize()
    _log(f"[shard data] {N} x {dim} f32 base ({base.numel() * 4 / 1e9:.2f} "
         f"GB) + {nq} queries in {time.perf_counter() - t0:.1f} s; "
         f"{SHARD_RANKS} ranks on {mesh.distinct_devices}")

    # the path: build and legs 1-3; counts zeroed just before
    K.reset_launch_counts()
    spans.reset()
    t0 = time.perf_counter()
    index = pivf.build_ivf_pq(ivf_pq.IndexParams(
        n_lists=8192, pq_dim=64, pq_bits=8, cache_reconstruction="never",
        seed=args.seed), base, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    L = index.max_list_size
    codes_gb = sum(c.numel() for c in index.packed_codes) / 1e9
    _log(f"[shard build] {build_s:.1f} s; L = {L}; packed codes "
         f"{codes_gb:.2f} GB; rows indexed {index.size} of {N}")

    # leg 1: sharded kNN, both merge tiers, against single-rank brute force
    n_gt = 1000
    qg = queries[:n_gt].contiguous()
    gv, gt = brute_force.knn(base, qg, k, metric="sqeuclidean")
    knn = {}
    for merge in ("allgather", "ring"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v, i = pknn.sharded_knn(base, qg, k, mesh, merge=merge)
        torch.cuda.synchronize()
        n_diff = _swaps_are_ties(qg, base, i, gt,
                                 f"sharded_knn ({merge}) against brute force")
        rel = float(((v - gv).abs() / gv.abs().clamp_min(1e-30)).max())
        if rel > 1e-5:
            raise SmokeFailure(f"sharded_knn ({merge}) values differ by "
                               f"{rel} relative")
        knn[merge] = {"ids_differing": n_diff, "max_rel_err": rel,
                      "seconds": time.perf_counter() - t1}
    _log(f"[shard leg 1] sharded_knn of {n_gt} queries, k {k}, against "
         f"single-rank brute_force.knn: {json.dumps(knn)}")
    gt = gt.cpu()

    # leg 2: refined sharded search on the ring merge
    sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                             refine="f32_regen", refine_ratio=40,
                             lut_dtype="bfloat16")

    def search_pass(merge="auto", n=nq):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out_i, out_v = [], []
        start.record()
        for a in range(0, n, B):
            v, i = pivf.search_ivf_pq(sp, index, queries[a:a + B], k, mesh,
                                      dataset=base, merge=merge)
            out_v.append(v)
            out_i.append(i)
        end.record()
        torch.cuda.synchronize()
        return torch.cat(out_i), torch.cat(out_v), start.elapsed_time(end) / 1e3

    spans.reset()
    ids_ring, vals_ring, t_cold = search_pass()
    disp = spans.counts().get("parallel.merge.dispatch", {})
    if disp.get("ring_kernel", 0) != nq // B:
        raise SmokeFailure(f"refined leg did not take ring_kernel: {disp}")
    qps = [nq / search_pass()[2] for _ in range(3)]
    ids_ag, vals_ag, _ = search_pass("allgather")
    if not torch.equal(vals_ring, vals_ag):
        raise SmokeFailure("the ring and allgather tiers give different "
                           "values")
    n_tied = _swaps_are_ties(queries, base, ids_ring, ids_ag,
                             "refined search, ring against allgather")
    rec = _recall(ids_ring[:n_gt].cpu(), gt)
    if not rec >= 0.95:
        raise SmokeFailure(f"refined sharded recall@10 {rec} < 0.95")
    _log(f"[shard leg 2] refined search, batch {B}, n_probes 64, "
         f"refine_ratio 40, bf16 LUT, merge auto -> {disp}: cold pass "
         f"{nq / t_cold:.0f} QPS, three warm passes "
         + ", ".join(f"{x:.0f}" for x in qps)
         + f" QPS (CUDA events); recall@10 {rec:.4f} on {n_gt} queries; "
         f"the allgather tier gives the same values and ids ({n_tied} "
         f"swapped at ties)")

    # leg 3: the fused scan-in-ring tier at batch 32, against the unfused
    # ring search of the same batches
    spf = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                              lut_dtype="float32")
    bf, n_f = 32, 50

    def timed_call(q):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = pivf.search_ivf_pq(spf, index, q, k, mesh)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    lat = {}
    res = {}
    for mode in ("on", "off"):
        os.environ["RAFT_TPU_RING_FUSED"] = "auto" if mode == "on" else "off"
        spans.reset()
        ms, outs = [], []
        for c in range(n_f):
            out, t = timed_call(queries[c * bf:(c + 1) * bf])
            ms.append(t)
            outs.append(out)
        lat[mode] = ms
        res[mode] = (torch.cat([o[0] for o in outs]),
                     torch.cat([o[1] for o in outs]))
        d = spans.counts().get("parallel.merge.dispatch", {})
        want = "ring_fused_scan" if mode == "on" else "ring_kernel"
        if d.get(want, 0) != n_f:
            raise SmokeFailure(f"fused leg ({mode}) took {d}, not {want}")
    os.environ.pop("RAFT_TPU_RING_FUSED", None)
    (fv, fi), (uv, ui) = res["on"], res["off"]
    n_swap = 0
    for row, j in torch.nonzero(fi != ui).tolist():
        # the fused and unfused picks must tie in f64 (both are ADC keys
        # of the same codes: l2 key + ‖q_rot‖²)
        q_rot = queries[row] @ index.rotation[0].T
        qsq = float((q_rot.double() ** 2).sum())
        d_f = _adc_key64(index, q_rot, fi[row, j]) + qsq
        d_u = _adc_key64(index, q_rot, ui[row, j]) + qsq
        if abs(d_f - d_u) > 1e-5 * (abs(d_u) + qsq):
            raise SmokeFailure(f"fused tier ids differ from the unfused "
                               f"search away from key ties (row {row})")
        n_swap += 1
    _log(f"[shard leg 3] batch {bf}, n_probes 64, f32 LUT: fused "
         f"scan-in-ring per call ms median {np.median(lat['on']):.3f} "
         f"(min {min(lat['on']):.3f}), unfused (per_query scan + ring) "
         f"median {np.median(lat['off']):.3f} (min {min(lat['off']):.3f}); "
         f"ids equal over {n_f * bf} queries but {n_swap} picks at f64 key "
         f"ties")
    launches = K.launch_counts()
    _log(f"[shard] launches {json.dumps(launches)}")
    missing = [n for n in SHARD_KERNELS if launches[n] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the sharded path: "
                           f"{missing}")

    # the kernel path's recall against the plain path's: the same sharded
    # search on a CPU mesh (every wrapper runs its plain version)
    n_pl = 200
    t0 = time.perf_counter()
    mesh_cpu = make_mesh(SHARD_RANKS, device="cpu")
    index_cpu = pivf.from_numpy(*pivf.to_numpy(index), mesh_cpu)
    base_cpu = base.cpu()
    _, ids_pl = pivf.search_ivf_pq(sp, index_cpu, queries[:n_pl].cpu(), k,
                                   mesh_cpu, dataset=base_cpu)
    rec_plain = _recall(ids_pl, gt[:n_pl])
    rec_kern = _recall(ids_ring[:n_pl].cpu(), gt[:n_pl])
    del index_cpu, base_cpu
    _log(f"[shard recall] {n_pl} queries: kernel path {rec_kern:.4f}, plain "
         f"path (CPU) {rec_plain:.4f} ({time.perf_counter() - t0:.1f} s)")
    if abs(rec_kern - rec_plain) > 0.01:
        raise SmokeFailure(f"sharded kernel-path recall {rec_kern} is not "
                           f"within 0.01 of the plain path's {rec_plain}")

    # leg 4: the comms byte model of one batch, ring against allgather
    byte_model = {}
    for merge in ("ring", "allgather"):
        comms.reset_counters()
        pivf.search_ivf_pq(sp, index, queries[:B], k, mesh, dataset=base,
                           merge=merge)
        c = comms.counters()
        byte_model[merge] = {f"{op}": n for (op, _), n in c["bytes"].items()}
    ring_b = byte_model["ring"]["ring_topk"]
    ag_b = byte_model["allgather"]["allgather"]
    _log(f"[shard comms] bytes of one batch of {B} (the JAX package's byte "
         f"model of a mesh of separate devices, not a measurement: the "
         f"ranks share one card): {json.dumps(byte_model)}")
    if not 2 * ring_b <= ag_b:
        raise SmokeFailure(f"ring bytes {ring_b} > half the allgather's "
                           f"{ag_b}")

    # kernels against their plain versions at the path's shapes
    q0 = queries[:B].contiguous()
    vals, gids = pivf._per_rank_topk(sp, index, q0, k, 64, mesh, base)
    _ring_topk_row(rows, "sharded", launches, vals, gids, k,
                   f"refined batch {B}")
    _ring_lut_scan_row(rows, "sharded", launches, index, queries[:bf], k,
                       64, mesh, f"fused batch {bf}")
    local0 = index.local(0)
    shard0 = base[:index.shard_rows]
    _argmin_row(rows, "sharded", launches, shard0,
                local0.centers.contiguous(), "(rank 0's Lloyd sweep) ")
    # select_k: the ring's plain-schedule cut, incoming ++ local [mc, 2k]
    mc = K.ring_chunk_rows(B, SHARD_RANKS)
    cut = torch.cat([vals[0][:mc], vals[1][:mc]], 1).contiguous()
    _select_k_row(rows, "sharded", launches, cut, k,
                  ", the ring schedule's incoming ++ local cut")
    _lut_scan_row(rows, "sharded", launches, local0, q0, 64, "bfloat16",
                  "rank 0's shard: ")
    sp_scan = ivf_pq.SearchParams(**{**sp.__dict__, "refine": "none"})
    _, cand = ivf_pq.search(local0, q0, 400, sp_scan)
    # rank 0's offset is 0: its global candidate ids are its local rows
    _refine_row(rows, "sharded", launches, shard0, q0, cand.contiguous(), k,
                "rank 0's shard: ")

    # where one refined batch's time goes, each part alone (CUDA events)
    ring_ms = next(r["ms"] for r in rows if r["path"] == "sharded"
                   and r["name"] == "ring_topk_merge")
    stages_ms = {
        "one_rank_refined_search": _timed(lambda: ivf_pq.search(
            local0, q0, k, sp, dataset=shard0), 5),
        "all_ranks_local_topk": _timed(lambda: pivf._per_rank_topk(
            sp, index, q0, k, 64, mesh, base), 5),
        "ring_merge": ring_ms,
        "search_total": _timed(lambda: pivf.search_ivf_pq(
            sp, index, q0, k, mesh, dataset=base), 5),
    }
    _log(f"[shard stages] one refined batch of {B} queries, ms: "
         f"{json.dumps(stages_ms)}")
    filt_summary = shard_filter_leg(rows, index, base, queries, mesh, sp,
                                    spf, B, bf, k)

    _log(f"[shard transport] the {SHARD_RANKS} ranks shared cuda:0 "
         f"({torch.cuda.device_count()} card(s) visible): ring_topk_merge "
         f"walked each chunk's merge chain in one launch and "
         f"ring_lut_scan_merge read its neighbours' blocks through local "
         f"pointers; ranks on "
         f"several cards (peer pointers over NVLink) are not ported yet "
         f"(ROADMAP A15), so that transport went unmeasured")
    return {"n": N, "dim": dim, "ranks": SHARD_RANKS, "n_lists": 8192,
            "pq_dim": 64, "max_list_size": L, "build_s": build_s,
            "sharded_knn": knn, "qps_cold": nq / t_cold, "qps_warm": qps,
            "recall_at_10": rec, "recall_kernel_200": rec_kern,
            "recall_plain_200": rec_plain,
            "fused_ms_median": float(np.median(lat["on"])),
            "unfused_ms_median": float(np.median(lat["off"])),
            "byte_model": byte_model, "batch_stages_ms": stages_ms,
            "launches": launches, "filter": filt_summary}


def shard_filter_leg(rows, index, base, queries, mesh, sp, spf, B, bf, k):
    """The sharded tier filtered (ROADMAP A6): the bench's keep mask at
    selectivity 0.1 over the 20M global row ids, replicated. With the
    counts zeroed before and read after: the refined search of a batch of
    B (three passes; each rank's LUT scan with its keep bytes, so B1 must
    launch with its filter once a rank a pass) and the fused
    scan-in-ring tier at batch ``bf`` (B8 with each rank's keep bytes)
    over ten batches, held against the allgather tier's filtered search
    (ids equal except at f32 ties, checked in f64). Checks: no returned
    id has its bit clear; the refined batch on the ring merge gives the
    allgather tier's values and ids but at ties; its recall@10 against
    the filtered ground truth is logged. Then B8 filtered against its
    plain version (its row). Raises SmokeFailure; returns the summary."""
    import numpy as np
    import torch

    from raft_tpu_torch.core import bitset
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.parallel import ivf as pivf

    N, sel, n_f = base.shape[0], 0.1, 10
    keep = bench_keep(N, sel, k)
    bits = bitset.from_mask(keep, device=base.device)
    q0 = queries[:B].contiguous()
    _, fgt = brute_force.knn(base, q0, k, metric="sqeuclidean",
                             filter_bitset=bits)
    K.reset_launch_counts()
    spans.reset()
    secs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, ids = pivf.search_ivf_pq(sp, index, q0, k, mesh, dataset=base,
                                    filter_bitset=bits)
        end.record()
        torch.cuda.synchronize()
        secs.append(start.elapsed_time(end))
    # the ring merge (auto) against the allgather tier, both filtered: the
    # same values, the same ids but at ties
    vals = pivf.search_ivf_pq(sp, index, q0, k, mesh, dataset=base,
                              filter_bitset=bits)[0]
    v_ag, i_ag = pivf.search_ivf_pq(sp, index, q0, k, mesh, dataset=base,
                                    merge="allgather", filter_bitset=bits)
    if not (torch.equal(vals, v_ag) and torch.equal(ids < 0, i_ag < 0)):
        raise SmokeFailure("filtered refined batch: the ring and allgather "
                           "tiers give different values")
    n_tied = _swaps_are_ties(q0, base, ids.clamp_min(0), i_ag.clamp_min(0),
                             "filtered refined batch, ring against "
                             "allgather")
    ids = ids.cpu()
    n_empty = _check_kept(ids, keep, "filtered sharded refined batch")
    rec = _recall(ids, fgt.cpu())
    # the fused tier against the allgather tier, both filtered
    os.environ["RAFT_TPU_RING_FUSED"] = "auto"
    fused, ag, f_ms = [], [], []
    try:
        for c in range(n_f):
            q = queries[c * bf:(c + 1) * bf]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fused.append(pivf.search_ivf_pq(spf, index, q, k, mesh,
                                            filter_bitset=bits))
            end.record()
            torch.cuda.synchronize()
            f_ms.append(start.elapsed_time(end))
            ag.append(pivf.search_ivf_pq(spf, index, q, k, mesh,
                                         merge="allgather",
                                         filter_bitset=bits))
    finally:
        os.environ.pop("RAFT_TPU_RING_FUSED", None)
    launches = K.launch_counts()
    filtered = K.filtered_launch_counts()
    disp = spans.counts()
    n_ranks = len(mesh.devices)
    # five refined searches of the batch (three passes, the ring and the
    # allgather tiers), each a LUT scan a rank
    if filtered["ivfpq_lut_scan_topk"] != 5 * n_ranks:
        raise SmokeFailure(f"filtered sharded refined batches: B1 launched "
                           f"{filtered['ivfpq_lut_scan_topk']} times with its "
                           f"filter for {5 * n_ranks} rank searches")
    if filtered["ring_lut_scan_merge"] != 2 * n_f:
        raise SmokeFailure(f"filtered fused tier: B8 launched "
                           f"{filtered['ring_lut_scan_merge']} times with its "
                           f"filter for {n_f} calls (two a call): {disp}")
    fi = torch.cat([o[1] for o in fused])
    ui = torch.cat([o[1] for o in ag])
    _check_kept(fi.cpu(), keep, "filtered fused tier")
    _check_kept(ui.cpu(), keep, "filtered allgather tier")
    n_swap = 0
    for row, j in torch.nonzero(fi != ui).tolist():
        q_rot = queries[row] @ index.rotation[0].T
        qsq = float((q_rot.double() ** 2).sum())
        if int(fi[row, j]) < 0 or int(ui[row, j]) < 0:
            raise SmokeFailure(f"filtered fused tier: an empty slot where "
                               f"the allgather tier has none (row {row})")
        d_f = _adc_key64(index, q_rot, fi[row, j]) + qsq
        d_u = _adc_key64(index, q_rot, ui[row, j]) + qsq
        if abs(d_f - d_u) > 1e-5 * (abs(d_u) + qsq):
            raise SmokeFailure(f"filtered fused tier ids differ from the "
                               f"allgather tier away from key ties (row "
                               f"{row})")
        n_swap += 1
    _log(f"[shard filter] selectivity {sel} ({int(keep.sum())} of {N} rows "
         f"kept): refined batch of {B}, three passes "
         + ", ".join(f"{t:.3f}" for t in secs)
         + f" ms (CUDA events; " + ", ".join(f"{B / t * 1e3:.0f}"
                                              for t in secs)
         + f" QPS); recall@10 {rec:.4f} against the filtered ground truth; "
         f"{n_empty} empty slots; the allgather tier gives the same values "
         f"and ids ({n_tied} swapped at ties). Fused scan-in-ring at batch "
         f"{bf}, f32 LUT: "
         f"per call ms median {np.median(f_ms):.3f} (min {min(f_ms):.3f}); "
         f"ids equal to the filtered allgather tier's over {n_f * bf} "
         f"queries but {n_swap} picks at f64 key ties; launches "
         f"{json.dumps(launches)}, with the filter {json.dumps(filtered)}; "
         f"dispatch {json.dumps(disp.get('parallel.merge.dispatch', {}))}")
    _ring_lut_scan_row(rows, "sharded_filter", filtered, index,
                       queries[:bf], k, 64, mesh,
                       f"fused batch {bf}, selectivity {sel}",
                       filter_bits=bits)
    return {"selectivity": sel, "kept": int(keep.sum()),
            "refined_batch_ms": secs, "recall_at_10": rec,
            "empty_slots": n_empty,
            "fused_ms_median": float(np.median(f_ms)),
            "fused_ids_at_ties": n_swap, "launches": launches,
            "filtered_launches": filtered}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=500)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    # 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "raft_tpu_torch")):
        print("chip_smoke: raft_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, here)
    import numpy as np

    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import brute_force, ivf_common, ivf_pq
    from raft_tpu_torch.neighbors import refine as trefine
    from raft_tpu_torch.ops import build as kbuild
    from raft_tpu_torch.ops import kernels as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    _log(f"[probe] torch {torch.__version__} cuda {torch.version.cuda}; "
         f"card: {kind}")

    # 2. build
    t0 = time.perf_counter()
    per_src = kbuild.build_all()
    _log(f"[build] {len(per_src)} kernels in "
         f"{time.perf_counter() - t0:.1f} s: "
         + ", ".join(f"{k} {v:.1f}s" for k, v in per_src.items()))
    for src, entries in kbuild.register_report().items():
        _log(f"[build] {src} (ptxas): " + "; ".join(
            f"{e} {r} registers, spills {st}/{ld} bytes stored/loaded"
            for e, r, st, ld in entries))

    # 3. the IVF-PQ path
    N, dim, B = args.n, 96, args.batch
    t0 = time.perf_counter()
    ds = DeviceSynthetic(N, dim, n_centers=10_000, seed=args.seed,
                         std=0.5, scale=10.0)
    base = ds.base()
    queries = ds.queries(args.queries)
    torch.cuda.synchronize()
    _log(f"[data] {N} x {dim} f32 base + {args.queries} queries in "
         f"{time.perf_counter() - t0:.1f} s")
    iparams = ivf_pq.IndexParams(n_lists=8192, pq_dim=64, pq_bits=8,
                                 cache_reconstruction="never",
                                 seed=args.seed)
    k = 10
    sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                             refine="f32_regen", refine_ratio=40,
                             lut_dtype="bfloat16")
    stages = {}

    def search_pass(filter_bitset=None):
        """All queries in batches of B; seconds from CUDA events recorded
        before the first batch and after the last."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        start.record()
        for a in range(0, args.queries, B):
            out.append(ivf_pq.search(index, queries[a:a + B], k, sp,
                                     filter_bitset=filter_bitset,
                                     dataset=base)[1])
        end.record()
        torch.cuda.synchronize()
        return torch.cat(out), start.elapsed_time(end) / 1e3

    K.reset_launch_counts()
    t0 = time.perf_counter()
    index = ivf_pq.build(base, iparams, stage_seconds=stages)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids_k, search_s = search_pass()
    launches = K.launch_counts()
    ids_k = ids_k.cpu()
    # QPS of the first pass and of two more over the same queries: the
    # spread between passes is part of the result
    qps_runs = [args.queries / search_s] + [
        args.queries / search_pass()[1] for _ in range(2)]
    _log(f"[main] build {build_s:.1f} s ("
         + ", ".join(f"{s} {v:.1f}s" for s, v in stages.items())
         + f"); L = {index.max_list_size}; search {args.queries} queries, "
         f"three passes (CUDA events): "
         + ", ".join(f"{q:.0f}" for q in qps_runs) + " QPS")
    _log(f"[main] launches {json.dumps(launches)}")
    missing = [n for n in PQ_KERNELS if launches[n] == 0]
    if missing:
        return _fail(f"kernels never launched on the IVF-PQ path: {missing}")
    if ids_k.shape != (args.queries, k) or bool((ids_k < 0).any()):
        return _fail("search returned a malformed id table")

    # 4. checks
    n_gt = min(1000, args.queries)
    _, gt = brute_force.knn(base, queries[:n_gt], k, metric="sqeuclidean")
    gt = gt.cpu()
    rec_bf16 = _recall(ids_k[:n_gt], gt)
    sp32 = ivf_pq.SearchParams(**{**sp.__dict__, "lut_dtype": "float32"})
    ids32 = torch.cat([ivf_pq.search(index, queries[a:a + B], k, sp32,
                                     dataset=base)[1]
                       for a in range(0, n_gt, B)]).cpu()
    rec_f32 = _recall(ids32, gt)
    _log(f"[recall] recall@10 on {n_gt} queries: bf16 LUT {rec_bf16:.4f}, "
         f"f32 LUT {rec_f32:.4f}")
    n_pl = min(200, n_gt)
    t0 = time.perf_counter()
    arrays, meta = ivf_pq.to_numpy(index)
    index_cpu = ivf_pq.from_numpy(arrays, meta, device="cpu")
    base_cpu = base.cpu()
    _, ids_pl = ivf_pq.search(index_cpu, queries[:n_pl].cpu(), k, sp,
                              dataset=base_cpu, device="cpu")
    rec_plain = _recall(ids_pl, gt[:n_pl])
    rec_kern = _recall(ids_k[:n_pl], gt[:n_pl])
    del arrays
    _log(f"[recall] {n_pl} queries: kernel path {rec_kern:.4f}, plain path "
         f"(CPU) {rec_plain:.4f} ({time.perf_counter() - t0:.1f} s)")
    if not (rec_kern >= rec_plain - 0.01):
        return _fail(f"kernel-path recall {rec_kern} is more than 0.01 below "
                     f"the plain path's {rec_plain}")

    # 5. kernels against their plain versions, on main-path inputs
    rows = []
    q0 = queries[:B].contiguous()

    try:
        # fused_l2_argmin: the build's assignment, the whole base against
        # the 8192 centers
        _argmin_row(rows, "ivf_pq", launches, base,
                    index.centers.contiguous(), "")
        # select_k: the coarse-probe distances of the first batch
        c_sq = (index.centers ** 2).sum(1)
        scores = (c_sq[None, :] - 2.0 * (q0 @ index.centers.T)).contiguous()
        _select_k_row(rows, "ivf_pq", launches, scores, 64, "")
    except SmokeFailure as e:
        return _fail(str(e))

    # ivfpq_lut_scan_topk: the first batch's segments at k_cand = 400;
    # gather_refine_topk: the first batch's 400 scan candidates
    n_probes = sp.n_probes
    sp_scan = ivf_pq.SearchParams(**{**sp.__dict__, "refine": "none"})
    try:
        scan = _lut_scan_row(rows, "ivf_pq", launches, index, q0, n_probes,
                             "bfloat16")
        _, cand = ivf_pq.search(index, q0, 400, sp_scan)
        cand = cand.contiguous()
        _refine_row(rows, "ivf_pq", launches, base, q0, cand, k)
    except SmokeFailure as e:
        return _fail(str(e))
    kk, ki, probes = scan["kk"], scan["ki"], scan["probes"]
    seg, n_seg, q_rot = scan["seg"], scan["n_seg"], scan["q_rot"]
    C = cand.shape[1]

    # 6. where one batch's time goes: each stage of the refined search of
    # the first batch, timed alone on the card (CUDA events)
    dist = ivf_pq.resolve_metric(index.metric)
    q_sq0 = (q_rot * q_rot).sum(1)
    zeros = torch.zeros((B, n_probes * K.LUT_SCAN_BINS), device=q0.device)

    def finish():
        return ivf_pq._finish_candidates(-0.5 * kk.view(B, -1),
                                         ki.view(B, -1), zeros, q_sq0, dist,
                                         C)

    stages_ms = {
        "coarse_probes": _timed(lambda: ivf_pq._coarse_probes(
            index, q0, n_probes, False), 20),
        "segment_probes": _timed(lambda: ivf_common.segment_probes(
            probes, index.n_lists, seg, n_seg), 20),
        "rotate": _timed(lambda: q0 @ index.rotation.T, 20),
        "lut_scan": rows[2]["ms"],
        "finish": _timed(finish, 10),
        "refine": _timed(lambda: trefine.refine(base, q0, cand, k), 20),
        "search_total": _timed(lambda: ivf_pq.search(
            index, q0, k, sp, dataset=base), 5),
    }
    _log(f"[stages] one batch of {B} queries, ms: {json.dumps(stages_ms)}")

    # 7. [filter main]: the filtered main path at selectivity 0.1 and 0.01
    try:
        filt_summary = filter_main_leg(args, rows, index, base, queries,
                                       index_cpu, base_cpu, sp, B, k, n_gt,
                                       n_pl)
    except SmokeFailure as e:
        return _fail(str(e))
    del index_cpu, base_cpu

    summary = {"n": N, "dim": dim, "n_lists": 8192, "pq_dim": 64,
               "max_list_size": index.max_list_size, "build_s": build_s,
               "build_stages_s": stages, "qps_runs": qps_runs,
               "recall_at_10_bf16": rec_bf16, "recall_at_10_f32": rec_f32,
               "recall_kernel_200": rec_kern, "recall_plain_200": rec_plain,
               "batch_stages_ms": stages_ms, "filter": filt_summary}
    _log(f"[summary] {json.dumps(summary)}")
    del index, base, queries, cand, kk, ki, scores, scan
    torch.cuda.empty_cache()

    try:
        data, flat_summary = flat_phase(args, rows)
        _log(f"[flat summary] {json.dumps(flat_summary)}")
        torch.cuda.empty_cache()
        pq_summary = pq_recon_phase(args, rows, **data)
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[pq summary] {json.dumps(pq_summary)}")
    del data
    torch.cuda.empty_cache()
    try:
        shard_summary = sharded_phase(args, rows)
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[shard summary] {json.dumps(shard_summary)}")
    _log(f"[wall] {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
