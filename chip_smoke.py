#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``raft_tpu_torch``) on one card.

    python3 chip_smoke.py [--n ROWS] [--queries M] [--seed S]

Phases (any failure exits non-zero; nothing is caught and continued):

1. probe — a CUDA card must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build — compiles every kernel from ``raft_tpu_torch/ops/csrc`` with
   ``nvcc`` (one process per source, all started together);
3. main path — DEEP-10M-shaped synthetic data (10M x 96 f32, 10,000
   centers), ``ivf_pq.build`` with 8192 lists, pq_dim 64, 8-bit codes,
   then refined search of 10,000 queries in batches of 500 (n_probes 64,
   scan_select="pallas", refine="f32_regen", refine_ratio 40, bf16 LUT)
   against the device-resident base; launch counts are zeroed just before
   and read just after, and every kernel must have launched;
4. checks — recall@10 against ``brute_force.knn`` on 1,000 queries (also
   with an f32 LUT), and the kernel path's recall on 200 queries against
   the plain path's (the same search on the CPU, where every wrapper runs
   its plain PyTorch version): it may be at most 0.01 lower;
5. kernels — each kernel against its plain version on the card, on the
   inputs the main path gave it, with times, bounds and errors;
6. the kernel JSON line, then ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


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

    # 3. main path
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
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        return _fail(f"kernels never launched on the main path: {missing}")
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
        b_ms, b_by = _bound_ms(nbytes, flops)
        rows.append({"name": name, "route": "cuda",
                     "source": f"raft_tpu_torch/ops/csrc/{src}",
                     "replaces": f"raft_tpu/ops/pallas_kernels.py:{line}",
                     "launches": launches[name], "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "shape": shape})
        _log(f"[kernel] {name} {shape}: max|d| {err:.3g}, {ms:.3f} ms "
             f"(plain {plain_ms:.3f} ms, library "
             f"{'-' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
             f"{b_ms:.3f} ms by {b_by})")

    # fused_l2_argmin: the build's assignment, the whole base against the
    # 8192 centers
    xa = base
    ya = index.centers.contiguous()
    d_k, i_k = K.fused_l2_argmin(xa, ya)
    d_p, i_p = K.fused_l2_argmin_plain(xa, ya)
    # tolerance: the expanded form cancels terms of size |x|² + |y|², so
    # f32 rounding scales with them, not with the distance
    x_sq = (xa * xa).sum(1)
    y_sq = (ya * ya).sum(1)
    err = float((d_k - d_p).abs().max())
    if not bool(((d_k - d_p).abs()
                 <= 1e-4 + 1e-5 * (x_sq + y_sq[i_p.long()])).all()):
        return _fail(f"fused_l2_argmin distances differ by {err}")
    same = i_k == i_p
    bad = ~same
    if bool(bad.any()):
        # where argmins differ, the kernel's pick must tie the minimum
        xb, yb = xa[bad], ya[i_k[bad].long()]
        d_pick = ((xb * xb).sum(1) + (yb * yb).sum(1)
                  - 2.0 * (xb * yb).sum(1)).clamp_min(0.0)
        if not bool(((d_pick - d_p[bad]).abs()
                     <= 1e-4 + 1e-5 * (x_sq[bad] + (yb * yb).sum(1))).all()):
            return _fail("fused_l2_argmin picked a non-minimal center")
    m_, n_ = xa.shape[0], ya.shape[0]
    row("fused_l2_argmin", "fused_l2_argmin.cu", 112, err,
        _timed(lambda: K.fused_l2_argmin(xa, ya), 3),
        _timed(lambda: K.fused_l2_argmin_plain(xa, ya), 1),
        (m_ + n_) * dim * 4 + m_ * 8, 2.0 * m_ * n_ * dim, None,
        f"[{m_},{dim}]x[{n_},{dim}] argmin agreement "
        f"{float(same.float().mean()):.6f}")

    # select_k: the coarse-probe distances of the first batch
    c_sq = (index.centers ** 2).sum(1)
    scores = (c_sq[None, :] - 2.0 * (q0 @ index.centers.T)).contiguous()
    v_k, p_k = K.select_k_cuda(scores, 64)
    v_p, p_p = K.select_k_plain(scores, 64)
    err = float((v_k - v_p).abs().max())
    if err != 0.0 or not torch.equal(p_k, p_p):
        return _fail(f"select_k differs from its plain version ({err})")
    row("select_k", "select_k.cu", 1317, err,
        _timed(lambda: K.select_k_cuda(scores, 64), 50),
        _timed(lambda: K.select_k_plain(scores, 64), 20),
        scores.numel() * 4 + B * 64 * 8, 0.0,
        _timed(lambda: torch.topk(scores, 64, largest=False), 50),
        f"[{B},{scores.shape[1]}] k=64")

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
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
