#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``raft_tpu_torch``) on one card.

    python3 chip_smoke.py [--n ROWS] [--queries M] [--seed S]

Phases (any failure exits non-zero; nothing is caught and continued):

1. probe — a CUDA card must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build — compiles every kernel from ``raft_tpu_torch/ops/csrc`` with
   ``nvcc`` (one process per source, all started together);
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
   kernels against their plain versions on the path's inputs, and a stage
   breakdown of one batch;
4. IVF-Flat path — the 1M x 128 ``make_synthetic_hard`` set of the repo's
   hard_config bench (``FLAT_N`` rows, not cut), ``ivf_flat.build`` with
   1024 lists, spill, cap factor 1.5; searches of 10,000 queries (k 10)
   with scan_select="approx" at n_probes 16/32/64/128 and "exact" at 32,
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
5. the card's line, the kernel JSON line, then ``{"ok": true, "device":
   {...}}`` last.

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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 non-tensor rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


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


def _bound_ms(n_bytes: float, flops: float):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _recall(found, truth) -> float:
    import numpy as np

    f, t = np.asarray(found), np.asarray(truth)
    k = t.shape[1]
    return float(np.mean([len(set(a[:k]) & set(b)) / k for a, b in zip(f, t)]))


def _row(rows, path, name, src, line, n_launches, err, ms, plain_ms, nbytes,
         flops, lib_ms, shape):
    """One kernel's entry of the JSON line (at one path's shapes, with
    that path's launch count), and its log line."""
    b_ms, b_by = _bound_ms(nbytes, flops)
    rows.append({"name": name, "path": path, "route": "cuda",
                 "source": f"raft_tpu_torch/ops/csrc/{src}",
                 "replaces": f"raft_tpu/ops/pallas_kernels.py:{line}",
                 "launches": n_launches, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms, "shape": shape})
    _log(f"[kernel] {path} {name} {shape}: max|d| {err:.3g}, {ms:.3f} ms "
         f"(plain {plain_ms:.3f} ms, library "
         f"{'-' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
         f"{b_ms:.3f} ms by {b_by})")


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
    _row(rows, path, "fused_l2_argmin", "fused_l2_argmin.cu", 112,
         launches["fused_l2_argmin"], err,
         _timed(lambda: K.fused_l2_argmin(xa, ya), 3),
         _timed(lambda: K.fused_l2_argmin_plain(xa, ya), 1),
         (m_ + n_) * dim * 4 + m_ * 8, 2.0 * m_ * n_ * dim, None,
         f"[{m_},{dim}]x[{n_},{dim}] {shape}argmin agreement "
         f"{float(same.float().mean()):.6f}")


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
    return (_timed(lambda: K.select_k_cuda(scores, k), 20),
            _timed(lambda: K.select_k_plain(scores, k), 5))


def _select_k_row(rows, path, launches, scores, k, shape):
    import torch

    ms, plain_ms = _select_k_check(scores, k)
    _row(rows, path, "select_k", "select_k.cu", 1317, launches["select_k"],
         0.0, ms, plain_ms, scores.numel() * 4 + scores.shape[0] * k * 8, 0.0,
         _timed(lambda: torch.topk(scores, k, largest=False), 20),
         f"[{scores.shape[0]},{scores.shape[1]}] k={k}{shape}")


def flat_phase(args, rows):
    """IVF-Flat at the repo's 1M hard_config shape (bench.py:194-210,
    255-260): build, the approx legs at n_probes 16/32/64/128 and the exact
    leg at 32 (batch 10,000), small-batch legs, recall and tier checks, and
    the path's four kernels against their plain versions at its shapes.
    Raises SmokeFailure on any failed check. Returns the phase's summary."""
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
    (_, ids), t = timed_search(sp(32, "exact"), queries)
    legs["exact_32"] = {"ids": ids.cpu(), "qps": [nq / t]}
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
             + f" (batch {nq}, CUDA events); recall@10 {recall[name]:.4f}")
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
    del index_cpu
    _log(f"[flat recall] plain path took {time.perf_counter() - t0:.1f} s")

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
    _row(rows, "ivf_flat", "segmented_scan_topk", "segmented_scan.cu", 397,
         launches["segmented_scan_topk"], err,
         _timed(lambda: K.segmented_scan_topk(*args_k, "l2"), 5),
         _timed(lambda: K.segmented_scan_topk_plain(*args_k, "l2"), 1),
         in_bytes + sk.numel() * 8, flops, None,
         shape + f", id agreement {agree:.6f}")
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
         in_bytes + gk.numel() * 8, flops, None,
         shape + f", kk {k}, position agreement {agree:.6f}")
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
    return {"n": N, "dim": dim, "n_lists": 1024, "max_list_size": L,
            "dropped_rows": dropped, "build_s": build_s,
            "build_stages_s": stages,
            "qps": {name: leg["qps"] for name, leg in legs.items()},
            "small_batch_ms": {bsz: lat for bsz, (_, lat) in small.items()},
            "recall_at_10": recall, "recall_plain_200": plain_rec,
            "bin_table_bytes": bin_bytes, "batch_stages_ms": stages_ms,
            "select_k_ms": sel_ms, "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=500)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's -Xptxas -v register/smem report")
    args = ap.parse_args(argv)

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
    per_src = kbuild.build_all(verbose=args.verbose_build)
    _log(f"[build] {len(per_src)} kernels in "
         f"{time.perf_counter() - t0:.1f} s: "
         + ", ".join(f"{k} {v:.1f}s" for k, v in per_src.items()))

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

    def search_pass():
        """All queries in batches of B; seconds from CUDA events recorded
        before the first batch and after the last."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        start.record()
        for a in range(0, args.queries, B):
            out.append(ivf_pq.search(index, queries[a:a + B], k, sp,
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
    del index_cpu, base_cpu, arrays
    _log(f"[recall] {n_pl} queries: kernel path {rec_kern:.4f}, plain path "
         f"(CPU) {rec_plain:.4f} ({time.perf_counter() - t0:.1f} s)")
    if not (rec_kern >= rec_plain - 0.01):
        return _fail(f"kernel-path recall {rec_kern} is more than 0.01 below "
                     f"the plain path's {rec_plain}")

    # 5. kernels against their plain versions, on main-path inputs
    rows = []
    q0 = queries[:B].contiguous()

    def row(name, src, line, err, ms, plain_ms, nbytes, flops, lib_ms, shape):
        _row(rows, "ivf_pq", name, src, line, launches[name], err, ms,
             plain_ms, nbytes, flops, lib_ms, shape)

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

    # ivfpq_lut_scan_topk: the first batch's segments at k_cand = 400
    n_probes = sp.n_probes
    _, probes = ivf_pq._coarse_probes(index, q0, n_probes, False)
    seg = ivf_common.SEGMENT_SIZE
    n_seg = ivf_common.n_segments(B * n_probes, index.n_lists, seg)
    seg_list, seg_q, _, _ = ivf_common.segment_probes(probes, index.n_lists,
                                                      seg, n_seg)
    q_rot = (q0 @ index.rotation.T).contiguous()
    scan_args = (seg_list, seg_q, q_rot, index.packed_codes,
                 index.packed_ids, index.packed_norms, index.centers_rot,
                 index.codebooks)
    scan_kw = dict(pq_bits=8, pq_dim=64, L=index.max_list_size,
                   lut_dtype="bfloat16")
    kk, ki = K.ivfpq_lut_scan_topk(*scan_args, "l2", **scan_kw)
    cb = K.lut_codebook(index.codebooks, "bfloat16")
    pk, pi = K.ivfpq_lut_scan_topk_plain(*scan_args[:7], cb, "l2", 8)
    live = seg_q >= 0
    fin = torch.isfinite(pk) & live[..., None]
    if not torch.equal(torch.isfinite(kk) & live[..., None], fin):
        return _fail("ivfpq_lut_scan_topk: filled bins differ")
    if not bool((kk[~live] == float("inf")).all() and (ki[~live] == -1).all()):
        return _fail("ivfpq_lut_scan_topk: pad slots lack the sentinel")
    diff = (kk[fin] - pk[fin]).abs()
    err = float(diff.max())
    # keys = ‖c+d‖² − 2⟨q, c+d⟩: rounding scales with ‖q‖² and the key
    q_sq = (q_rot * q_rot).sum(1)[seg_q.clamp_min(0).long()]
    scale = (pk.abs() + q_sq[..., None])[fin]
    if not bool((diff <= 1e-3 + 1e-5 * scale).all()):
        return _fail(f"ivfpq_lut_scan_topk keys differ by {err}")
    id_agree = float((ki[fin] == pi[fin]).float().mean())
    if id_agree < 0.999:
        return _fail(f"ivfpq_lut_scan_topk ids agree on {id_agree}")
    # the bound counts what this batch's data needs: codes and norms of the
    # probed lists' real rows (padded rows are not part of the function),
    # ids of all L slots of each probed list (they mark which rows are
    # real), the probed centers, the codebook, the queries, the segment
    # table and the whole output table
    lists = torch.unique(seg_list[live.any(1)].long())
    L = index.max_list_size
    sizes = index.list_sizes.long()
    n_live = int(live.sum())
    nb = index.packed_codes.shape[2]
    rows_real = int(sizes[lists].sum())
    pair_rows = int((live.sum(1).long() * sizes[seg_list.long()]).sum())
    scan_bytes = (rows_real * (nb + 4) + lists.numel() * L * 4
                  + lists.numel() * q_rot.shape[1] * 4 + cb.numel() * 4
                  + q_rot.numel() * 4 + seg_list.numel() * 4
                  + seg_q.numel() * 4 + kk.numel() * 8)
    # per live pair: its LUT (a multiply-add per codebook entry) and, per
    # real row, one add per subspace
    scan_flops = n_live * 2 * cb.numel() + pair_rows * index.pq_dim
    row("ivfpq_lut_scan_topk", "ivfpq_lut_scan.cu", 807, err,
        _timed(lambda: K.ivfpq_lut_scan_topk(*scan_args, "l2", **scan_kw), 10),
        _timed(lambda: K.ivfpq_lut_scan_topk_plain(*scan_args[:7], cb, "l2",
                                                   8), 2),
        scan_bytes, scan_flops, None,
        f"n_seg {n_seg} x {seg} slots ({n_live} live), L {L}, "
        f"{lists.numel()} lists of {rows_real} real rows, "
        f"id agreement {id_agree:.6f}")

    # gather_refine_topk: the first batch's 400 scan candidates
    sp_scan = ivf_pq.SearchParams(**{**sp.__dict__, "refine": "none"})
    _, cand = ivf_pq.search(index, q0, 400, sp_scan)
    cand = cand.contiguous()
    gk, gi = K.gather_refine_topk(base, q0, cand, k, "l2")
    pk2, pi2 = K.gather_refine_topk_plain(base, q0, cand, k, "l2")
    err = float((gk - pk2).abs().max())
    # the expanded key cancels ‖q‖² + ‖r‖²; rounding scales with it
    tol = 1e-5 * ((q0 * q0).sum(1, keepdim=True) + pk2.abs())
    if not bool(((gk - pk2).abs() <= tol).all()):
        return _fail(f"gather_refine_topk keys differ by {err}")
    # ids may differ only where the plain keys tie within the tolerance
    # (a neighbour in the sorted list, or the k-th against the k+1-th)
    gap = (pk2[:, 1:] - pk2[:, :-1]).abs() <= tol[:, 1:]
    tie = torch.zeros_like(gap[:, :1]).expand(-1, k).clone()
    tie[:, 1:] |= gap
    tie[:, :-1] |= gap
    tie[:, -1] = True
    if not bool(((gi == pi2) | tie).all()):
        return _fail("gather_refine_topk ids differ away from key ties")
    id_agree = float((gi == pi2).float().mean())
    C = cand.shape[1]
    row("gather_refine_topk", "gather_refine.cu", 1176, err,
        _timed(lambda: K.gather_refine_topk(base, q0, cand, k, "l2"), 50),
        _timed(lambda: K.gather_refine_topk_plain(base, q0, cand, k, "l2"),
               10),
        B * C * dim * 4 + B * C * 4 + B * dim * 4 + B * k * 8,
        4.0 * B * C * dim, None,
        f"[{B},{C}] candidates into [{N},{dim}], k={k}, id agreement "
        f"{id_agree:.6f}")

    # 6. where one batch's time goes: each stage of the refined search of
    # the first batch, timed alone on the card (CUDA events)
    dist = ivf_pq.resolve_metric(index.metric)
    q_sq0 = (q_rot * q_rot).sum(1)
    pair = ivf_common.segment_probes(probes, index.n_lists, seg, n_seg)
    zeros = torch.zeros((B, n_probes * K.LUT_SCAN_BINS), device=q0.device)

    def finish():
        pv, pi = ivf_common.gather_segment_results(kk, ki, pair[2], pair[3])
        return ivf_pq._finish_candidates(-0.5 * pv.reshape(B, -1),
                                         pi.reshape(B, -1), zeros, q_sq0,
                                         dist, C)

    stages_ms = {
        "coarse_probes": _timed(lambda: ivf_pq._coarse_probes(
            index, q0, n_probes, False), 20),
        "segment_probes": _timed(lambda: ivf_common.segment_probes(
            probes, index.n_lists, seg, n_seg), 20),
        "rotate": _timed(lambda: q0 @ index.rotation.T, 20),
        "lut_scan": rows[2]["ms"],
        "gather_and_finish": _timed(finish, 10),
        "refine": _timed(lambda: trefine.refine(base, q0, cand, k), 20),
        "search_total": _timed(lambda: ivf_pq.search(
            index, q0, k, sp, dataset=base), 5),
    }
    _log(f"[stages] one batch of {B} queries, ms: {json.dumps(stages_ms)}")

    summary = {"n": N, "dim": dim, "n_lists": 8192, "pq_dim": 64,
               "max_list_size": index.max_list_size, "build_s": build_s,
               "build_stages_s": stages, "qps_runs": qps_runs,
               "recall_at_10_bf16": rec_bf16, "recall_at_10_f32": rec_f32,
               "recall_kernel_200": rec_kern, "recall_plain_200": rec_plain,
               "batch_stages_ms": stages_ms}
    _log(f"[summary] {json.dumps(summary)}")
    del index, base, queries, cand, kk, ki, pk, pi, scores
    torch.cuda.empty_cache()

    try:
        flat_summary = flat_phase(args, rows)
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[flat summary] {json.dumps(flat_summary)}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
