#!/usr/bin/env python3
"""Time one of this tree's kernels against the one of another checkout,
in turns, on one card.

    python3 tests/torch_kernel_ab.py --other DIR [--other DIR2 ...]
        [--kernel select_k|ring_topk_merge|fused_l2_argmin|ivfpq_lut_scan|
                  ring_lut_scan_merge|segmented_scan|grouped_scan|
                  gather_refine]
        [--rounds R] [--n ROWS] [--seed S]
        [--wide | --flat-build | --flat-phase | --main-path]

DIR is the root of another checkout of the repo, for example a parent
commit unpacked with ``git archive``. Its source of the kernel
(``raft_tpu_torch/ops/csrc/<source>.cu``, with the other checkout's
headers) is built with this tree's ``nvcc`` flags into
``raft_tpu_torch/_build/ab/``; this tree's is built as usual. Each side
runs behind its own checkout's wrapper (``ops/kernels.py``, loaded from
DIR for ``other``), since the C entry points differ between versions.
Each round times this tree's kernel (``this``) and the other's
(``other``) in the order this, other, other, this, each a mean of
``reps`` calls with CUDA events, and prints one JSON line per timing; a
summary line says whether the two kernels' outputs agree: bit for bit
where the arithmetic is the same, else within the tolerance stated with
the kernel below. Needs a card and ``nvcc``. The kernels timed through
their wrappers (all but ``ivfpq_lut_scan``, ``gather_refine`` and the two
build and phase modes) take several ``--other`` checkouts, for design
variants (a copy of ``raft_tpu_torch/`` whose kernel source is edited):
each round then runs this tree, the others in order, the others in
reverse, this tree, each other named by its directory.

- ``select_k`` and ``ring_topk_merge``: shapes of ``chip_smoke.py``'s
  rows: select_k at [500, 8192] k 64 (IVF-PQ coarse probes: 500 queries
  against 8192 centers of ``DeviceSynthetic`` 96-d rows), [320,000, 256]
  k 10 (IVF-Flat bin rows: 256 bins of squared distances, 30 % of them
  +inf) and [128, 20] k 10 (the sharded ring's incoming ++ local cut);
  ring_topk_merge over 4 ranks on one card of [500, 10] sorted tables
  with int32 ids, k 10. Outputs bit for bit.
- ``fused_l2_argmin``: ``DeviceSynthetic`` rows against 8192 of them as
  centers at the paths' shapes: [--n, 96] x [8192, 96] (the IVF-PQ
  build's assignment), [5M, 128] x [8192, 128] (a sharded rank's Lloyd
  sweep) and [500K, 128] x [1024, 128] (the IVF-Flat trainset). Outputs
  agree within the smoke's rule: distances within 1e-4 + 1e-5·(‖x‖² +
  ‖y‖²), a differing argmin's f64 distance tying the other's within it.
  With ``--wide``: [200K, d] x [1024, d] at d 544, 1152, 1216 and 2048
  (k-means over wide embeddings; the kernel streams x past d 1152). With
  ``--flat-build``: the IVF-Flat phase's build (``chip_smoke.py``: 1M x
  128 ``make_synthetic_hard``, 1024 lists, spill, cap factor 1.5) with
  each tree's kernel behind ``fused_l2_argmin`` in turns, each build's
  rows dropped and its recall@10 at n_probes 32 (approx, 1,000 of the
  phase's queries against exact search).
- ``ivfpq_lut_scan`` (the default): the IVF-PQ phase's shapes:
  ``DeviceSynthetic`` ``--n`` x 96, ``ivf_pq.build`` with 8192 lists,
  pq_dim 64, 8-bit codes, and the first batch of 500 queries at n_probes
  64 with a bf16 LUT: the kernel alone on the batch's segment table, and
  the refined search of the batch (k_cand 400, refine to 10) as each
  tree's ``_search_lut_pallas`` runs it (a wrapper that takes the pair
  tables writes pair rows; an older one, a segment table that is
  gathered at the pairs, timed with the gather). Outputs agree within
  the smoke's rule:
  keys within 1e-3 + 1e-5·(|key| + ‖q‖²), ids on ≥ 99.9 % of the bins.
- ``segmented_scan`` and ``grouped_scan``: the IVF-Flat phase's shapes
  (``chip_smoke.py``: 1M x 128 ``make_synthetic_hard``, ``ivf_flat.build``
  with 1024 lists, spill, cap factor 1.5), built once; both trees' kernels
  run on one segment table, that of the first 10,000 queries at n_probes
  32 (grouped at kk 10). IVF-Flat builds are not bit-reproducible, so the
  index and the table are shared. Outputs agree within the smoke's rule:
  the same finite pattern, keys within 1e-4 + 1e-5·(|key| + ‖q‖²), and the
  share of ids (positions for grouped) equal is reported.
- ``--flat-phase``: ``chip_smoke.py``'s whole IVF-Flat phase
  (``flat_phase``) of this checkout and of DIR (a checkout with its own
  ``chip_smoke.py``), each in a process of its own, in the order this,
  other, other, this; one JSON line each with the legs' QPS, the rows
  dropped and the batch's stage times. For paths that two trees share:
  the phase's single-pass legs swing between runs of one tree.
- ``--main-path``: ``chip_smoke.py``'s ``[main]`` search of each checkout
  (``DeviceSynthetic`` ``--n`` x 96, ``ivf_pq.build`` with 8192 lists,
  pq_dim 64, 8-bit codes, then three passes of 10,000 refined queries in
  batches of 500 at n_probes 64, k_cand 400, bf16 LUT, against the
  resident base; CUDA events around each pass), each in a process of its
  own, in the order this, other, other, this, observability off; one JSON
  line each with the three passes' QPS, the median wall time of a batch
  run alone (a synchronize before and after each of 20 batches) and,
  where the checkout has recording spans, the median of ten root spans
  of ``chip_smoke.py``'s ``[obs spans]`` (sync mode) against
  ``[stages]``' ``search_total`` (one batch, five calls back to back),
  the quantity of ``[obs spans]``' 25 % rule.
- ``gather_refine``: the refine of the IVF-PQ phase and of the sharded
  phase's rank: [500, 400] candidates into ``DeviceSynthetic`` ``--n`` x 96
  and ``--n`` / 2 x 128 rows, drawn as the scans draw them (``ivf_pq.build``
  with 8192 lists, pq_dim 64, 8-bit codes over those rows, then the
  unrefined search of the first 500 queries for 400 candidates at n_probes
  64 with a bf16 LUT), k 10. Each timing is the mean of calls with the L2
  cold (a 256 MB buffer read before each call, CUDA events around the call
  alone), beside the mean of back-to-back (warm) calls. Outputs agree
  within the smoke's rule: keys within 1e-5·(‖q‖² + |key|), ids equal away
  from key ties (the share of equal ids is reported).
- ``ring_lut_scan_merge``: the sharded phase's fused-tier shape on random
  shards: 4 ranks on one card, each 8192 lists of L 2440 with 610 real
  rows on average (passed as ``list_sizes`` where the checkout's wrapper
  takes them), pq_dim 64, 8-bit codes, 32 queries (mc 8) at n_probes 64
  (512 union lists a chunk), k 10, f32 LUT. Outputs agree within
  1e-5·(|key| + ‖q‖²), ids on every slot away from key ties.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import _timed_cold  # noqa: E402

SOURCES = {"select_k": "select_k", "ring_topk_merge": "ring_topk",
           "fused_l2_argmin": "fused_l2_argmin",
           "ivfpq_lut_scan": "ivfpq_lut_scan",
           "ring_lut_scan_merge": "ring_lut_scan",
           "segmented_scan": "segmented_scan", "grouped_scan": "grouped_scan",
           "gather_refine": "gather_refine"}


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build_other(other_root: str, source: str) -> ctypes.CDLL:
    """The other checkout's ``source`` library, declared by the other
    checkout's own ``ops/build.py``."""
    from raft_tpu_torch.ops import build

    ops = os.path.join(other_root, "raft_tpu_torch", "ops")
    out_dir = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    tag = hashlib.sha1(os.path.abspath(other_root).encode()).hexdigest()[:8]
    out = os.path.join(out_dir, f"{source}-other-{tag}.so")
    cmd = [build._find_nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-o", out,
           os.path.join(ops, "csrc", f"{source}.cu")]
    subprocess.run(cmd, check=True)
    other_build = _load_module(os.path.join(ops, "build.py"), "ab_other_build")
    return other_build._declare(source, ctypes.CDLL(out))


def _timed(fn, reps: int) -> float:
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


def _same(a, b) -> bool:
    """Outputs bit for bit: tensors, or (nested) lists and tuples of them."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.shape == b.shape and torch.equal(a, b)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def _argmin_agree(x, y):
    """The smoke's rule for two fused_l2_argmin outputs on (x, y)."""
    import torch

    def check(a, b):
        (da, ia), (db, ib) = a, b
        xsq, ysq = (x * x).sum(1), (y * y).sum(1)
        tol = 1e-4 + 1e-5 * (xsq + ysq[ib.long()])
        ok = bool(((da - db).abs() <= tol).all())
        bad = ia != ib
        if bool(bad.any()):
            xb, yb = x[bad].double(), y[ia[bad].long()].double()
            d64 = ((xb - yb) ** 2).sum(1)
            ok &= bool(((d64 - db[bad].double()).abs()
                        <= tol[bad].double()).all())
        return {"within_tolerance": ok,
                "max_abs_diff": float((da - db).abs().max()),
                "argmins_differing": int(bad.sum())}
    return check


def _wrapper_cases(kernel: str, seed: int, n: int, wide: bool = False):
    """(name, call(kernels_module), reps, check(this_out, other_out)) at
    chip_smoke.py's shapes (``wide``: fused_l2_argmin's wide shapes)."""
    import torch

    from raft_tpu_torch.bench.dataset import DeviceSynthetic

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    if kernel == "ring_topk_merge":
        vals = [torch.rand((500, 10), generator=g, device="cuda").sort(1)[0]
                for _ in range(4)]
        ids = [torch.randint(0, 20_000_000, (500, 10), generator=g,
                             device="cuda", dtype=torch.int32)
               for _ in range(4)]
        return [("4 ranks x [500,10], k 10",
                 lambda K: K.ring_topk_merge(vals, ids, 10), 100, _same)]
    if kernel == "fused_l2_argmin":
        cases = []
        shapes = (((200_000, d, 1024) for d in (544, 1152, 1216, 2048))
                  if wide else ((n, 96, 8192), (5_000_000, 128, 8192),
                                (500_000, 128, 1024)))
        for rows, d, n_c in shapes:
            x = DeviceSynthetic(rows, d, n_centers=10_000, seed=seed, std=0.5,
                                scale=10.0).base()
            y = x[::rows // n_c][:n_c].contiguous()
            cases.append((f"[{rows},{d}]x[{n_c},{d}]",
                          lambda K, x=x, y=y: K.fused_l2_argmin(x, y),
                          1 if rows > 1_000_000 else 5, _argmin_agree(x, y)))
        return cases
    if kernel == "ring_lut_scan_merge":
        return [_ring_scan_case(seed)]
    if kernel in ("segmented_scan", "grouped_scan"):
        return [_flat_scan_case(kernel, seed)]
    ds = DeviceSynthetic(100_000, 96, n_centers=10_000, seed=seed, std=0.5,
                         scale=10.0)
    q = ds.queries(500)
    c = ds.base()[:8192]
    coarse = ((q * q).sum(1)[:, None] + (c * c).sum(1)[None, :]
              - 2.0 * (q @ c.T)).contiguous()
    bins = torch.rand((320_000, 256), generator=g, device="cuda") * 2000.0
    bins[torch.rand((320_000, 256), generator=g, device="cuda") < 0.3] = (
        float("inf"))
    cut = torch.cat([torch.rand((128, 10), generator=g, device="cuda")
                     .sort(1)[0] for _ in range(2)], 1).contiguous()
    return [("[500,8192] k 64", lambda K: K.select_k_cuda(coarse, 64), 50,
             _same),
            ("[320000,256] k 10", lambda K: K.select_k_cuda(bins, 10), 20,
             _same),
            ("[128,20] k 10", lambda K: K.select_k_cuda(cut, 10), 200,
             _same)]


def _ring_scan_case(seed: int):
    """ring_lut_scan_merge operands at the sharded fused tier's shape, on
    random shards (see the module note)."""
    import torch

    from raft_tpu_torch.parallel.ivf import _chunk_unions

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    n, n_lists, L, S, P, mc, n_probes, k = 4, 8192, 2440, 64, 2, 8, 64, 10
    rot = S * P
    NS = mc * n_probes
    dev = torch.device("cuda")
    packed, ids, norms, list_sizes = [], [], [], []
    for r in range(n):
        packed.append(torch.randint(0, 256, (n_lists, L, S), generator=g,
                                    device=dev, dtype=torch.uint8))
        sizes = torch.randint(0, 1221, (n_lists,), generator=g, device=dev)
        list_sizes.append(sizes.to(torch.int32))
        pos = torch.arange(L, device=dev)
        gid = (r * n_lists * L + torch.arange(n_lists * L, device=dev)
               ).view(n_lists, L).to(torch.int32)
        ids.append(torch.where(pos[None, :] < sizes[:, None], gid,
                               -1).to(torch.int32).contiguous())
        norms.append(torch.rand((n_lists, L), generator=g, device=dev) * 50)
    centers = torch.randn((n_lists, rot), generator=g, device=dev) * 4
    cb = torch.randn((S, 256, P), generator=g, device=dev)
    qv = torch.randn((n, mc, rot), generator=g, device=dev) * 4
    probes = torch.rand((n * mc, n_lists), generator=g, device=dev).topk(
        n_probes, 1).indices.to(torch.int32)
    lists, ind = _chunk_unions(probes.view(n, mc, n_probes), NS)
    ops = ([lists] * n, [ind] * n, [qv] * n, packed, ids, norms, list_sizes,
           [centers] * n, [cb] * n)
    kw = dict(pq_bits=8, pq_dim=S, L=L, lut_dtype="float32")
    qsq = (qv * qv).sum(2)                                  # [n, mc]

    def check(a, b):
        (ka, ia), (kb, ib) = a, b
        worst, differ = 0.0, 0
        for r in range(n):
            fin = torch.isfinite(kb[r])
            tol = 1e-5 * (kb[r].abs() + qsq[r][:, None])
            worst = max(worst, float(((ka[r] - kb[r]).abs()[fin]
                                      / tol[fin]).max()))
            differ += int(((ia[r] != ib[r]) & fin).sum())
        return {"max_diff_over_tolerance": worst, "ids_differing": differ}

    def call(K):  # list sizes where the checkout's wrapper takes them
        sized = "list_sizes" in inspect.signature(
            K.ring_lut_scan_merge).parameters
        return K.ring_lut_scan_merge(
            *(ops if sized else ops[:6] + ops[7:]), k, "l2", **kw)

    return ("4 ranks, 32 queries (mc 8), NS 512, k 10", call, 10, check)


def _flat_scan_case(kernel: str, seed: int):
    """segmented_scan_topk or grouped_scan_topk (kk 10) on the IVF-Flat
    phase's first batch (see the module note)."""
    import torch

    from raft_tpu_torch.bench.dataset import make_synthetic_hard
    from raft_tpu_torch.neighbors import ivf_common, ivf_flat

    nq, n_probes, kk = 10_000, 32, 10
    ds = make_synthetic_hard("sift-1000k-hard-synth", 1_000_000, 128, nq,
                             seed=seed)
    base = torch.from_numpy(ds.base).cuda()
    queries = torch.from_numpy(ds.queries).cuda()
    index = ivf_flat.build(base, ivf_flat.IndexParams(
        n_lists=1024, spill=True, list_size_cap_factor=1.5, seed=seed))
    seg = ivf_common.SEGMENT_SIZE
    probes = ivf_flat._probes(index, queries, n_probes,
                              ivf_flat.resolve_metric(index.metric))
    n_seg = ivf_common.n_segments(nq * n_probes, index.n_lists, seg)
    seg_list, seg_q, _, _ = ivf_common.segment_probes(
        probes, index.n_lists, seg, n_seg)
    args = (seg_list, seg_q, queries, index.packed_data, index.packed_ids)
    live = (seg_q >= 0)[..., None]
    qsq = (queries * queries).sum(1)[seg_q.clamp_min(0).long()][..., None]

    def check(a, b):
        (ka, ia), (kb, ib) = a, b
        fin = torch.isfinite(kb) & live
        tol = 1e-4 + 1e-5 * (kb.abs() + qsq)
        return {"finite_pattern_equal": bool(torch.equal(
                    torch.isfinite(ka) & live, fin)),
                "max_diff_over_tolerance": float(
                    ((ka - kb).abs()[fin] / tol.expand_as(kb)[fin]).max()),
                "picks_equal": float((ia == ib)[fin].float().mean())}

    if kernel == "segmented_scan":
        return (f"{n_seg} x {seg} slots, n_probes {n_probes}, batch {nq}, "
                f"L {index.max_list_size}",
                lambda K: K.segmented_scan_topk(*args, "l2"), 5, check)
    return (f"{n_seg} x {seg} slots, n_probes {n_probes}, batch {nq}, "
            f"L {index.max_list_size}, kk {kk}",
            lambda K: K.grouped_scan_topk(*args, kk, "l2"), 5, check)


def _other_kernels(root: str, kernel: str):
    """A checkout's ``ops/kernels.py`` over its own build of the kernel's
    source."""
    other_lib = _build_other(root, SOURCES[kernel])
    other_k = _load_module(os.path.join(root, "raft_tpu_torch", "ops",
                                        "kernels.py"),
                           "ab_kernels_" + hashlib.sha1(
                               os.path.abspath(root).encode()).hexdigest()[:8])
    other_k._lib = lambda name: other_lib
    return other_k


def _ab_wrapper(args, card: str) -> None:
    from raft_tpu_torch.ops import kernels as this_k

    names = (["other"] if len(args.other) == 1 else
             [os.path.basename(os.path.normpath(d)) for d in args.other])
    mods = {"this": this_k, **{n: _other_kernels(d, args.kernel)
                               for n, d in zip(names, args.other)}}
    cases = _wrapper_cases(args.kernel, args.seed, args.n, args.wide)
    agree = {n: {name: check(call(this_k), call(mods[n]))
                 for name, call, _, check in cases} for n in names}
    if len(names) == 1:
        agree = agree["other"]
    for rnd in range(args.rounds):
        for which in ("this", *names, *names[::-1], "this"):
            for name, call, reps, _ in cases:
                ms = _timed(lambda: call(mods[which]), reps)
                print(json.dumps({"kernel": args.kernel, "round": rnd,
                                  "library": which, "shape": name,
                                  "ms": ms}), flush=True)
    print(json.dumps({"card": card, "kernel": args.kernel,
                      "outputs_agree": agree}), flush=True)


def _ab_flat_build(args, card: str) -> None:
    """IVF-Flat builds with each tree's fused_l2_argmin, in turns (see the
    module note); builds are not bit-reproducible on the card, so the
    repeats of one tree show the spread."""
    import time

    import torch

    from raft_tpu_torch.bench.dataset import make_synthetic_hard
    from raft_tpu_torch.neighbors import brute_force, ivf_flat
    from raft_tpu_torch.ops import kernels as this_k

    fns = {"this": this_k.fused_l2_argmin,
           "other": _other_kernels(args.other, args.kernel).fused_l2_argmin}
    n, k = 1_000_000, 10
    ds = make_synthetic_hard("sift-1000k-hard-synth", n, 128, 10_000,
                             seed=args.seed)
    base = torch.from_numpy(ds.base).cuda()
    queries = torch.from_numpy(ds.queries[:1000]).cuda()
    _, gt = brute_force.knn_arrays(base, queries, k, metric="sqeuclidean")
    gt = gt.cpu().numpy()
    try:
        for rnd in range(args.rounds):
            for which in ("this", "other", "other", "this"):
                this_k.fused_l2_argmin = fns[which]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                index = ivf_flat.build(base, ivf_flat.IndexParams(
                    n_lists=1024, spill=True, list_size_cap_factor=1.5,
                    seed=args.seed))
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                _, ids = ivf_flat.search(index, queries, k, ivf_flat.SearchParams(
                    n_probes=32, scan_mode="grouped", scan_select="approx"))
                ids = ids.cpu().numpy()
                recall = sum(len(set(a) & set(b)) for a, b in zip(ids, gt)) / gt.size
                print(json.dumps({"kernel": "fused_l2_argmin", "round": rnd,
                                  "library": which, "flat_build_s": build_s,
                                  "dropped_rows": n - index.size,
                                  "recall_at_10_probes_32": recall}),
                      flush=True)
                del index
    finally:
        this_k.fused_l2_argmin = fns["this"]
    print(json.dumps({"card": card, "kernel": "fused_l2_argmin",
                      "flat_build": True}), flush=True)


def _ab_lut_scan(args, card: str) -> None:
    import torch

    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import ivf_common, ivf_pq
    from raft_tpu_torch.neighbors import refine as trefine
    from raft_tpu_torch.ops import kernels as K

    other_lib = _build_other(args.other, "ivfpq_lut_scan")
    other_k = _load_module(os.path.join(args.other, "raft_tpu_torch", "ops",
                                        "kernels.py"), "ab_other_kernels")
    other_k._lib = lambda name: other_lib
    ds = DeviceSynthetic(args.n, 96, n_centers=10_000, seed=args.seed,
                         std=0.5, scale=10.0)
    base = ds.base()
    q0 = ds.queries(500)
    B, n_probes, k, k_cand = 500, 64, 10, 400
    index = ivf_pq.build(base, ivf_pq.IndexParams(
        n_lists=8192, pq_dim=64, pq_bits=8, cache_reconstruction="never",
        seed=args.seed))
    seg = ivf_common.SEGMENT_SIZE
    n_seg = ivf_common.n_segments(B * n_probes, index.n_lists, seg)
    L = index.max_list_size
    kw = dict(pq_bits=index.pq_bits, pq_dim=index.pq_dim, L=L,
              lut_dtype="bfloat16")
    dist = ivf_pq.resolve_metric(index.metric)
    zeros = torch.zeros((B, n_probes * K.LUT_SCAN_BINS), device=q0.device)

    def tables():
        _, probes = ivf_pq._coarse_probes(index, q0, n_probes, False)
        seg_list, seg_q, ps, pl = ivf_common.segment_probes(
            probes, index.n_lists, seg, n_seg)
        return seg_list, seg_q, ps, pl, (q0 @ index.rotation.T).contiguous()

    # a checkout whose wrapper takes the pair tables writes pair rows;
    # an older one writes a segment table that is gathered at the pairs
    pair_rows = {"this": True, "other": "pair_seg" in inspect.signature(
        other_k.ivfpq_lut_scan_topk).parameters}

    def scan(which, t):
        """The kernel alone: pair rows, or a segment table."""
        seg_list, seg_q, ps, pl, q_rot = t
        mod = K if which == "this" else other_k
        if pair_rows[which]:
            return mod.ivfpq_lut_scan_topk(
                seg_list, seg_q, ps, pl, q_rot, index.packed_codes,
                index.packed_ids, index.packed_norms, index.list_sizes,
                index.centers_rot, index.codebooks, "l2", **kw)
        return mod.ivfpq_lut_scan_topk(
            seg_list, seg_q, q_rot, index.packed_codes, index.packed_ids,
            index.packed_norms, index.centers_rot, index.codebooks, "l2",
            **kw)

    def pairs(which, t):
        """The kernel's bins in pair order ([B, P, 256])."""
        out = scan(which, t)
        if pair_rows[which]:
            return out
        return ivf_common.gather_segment_results(*out, t[2], t[3])

    def batch(which):
        """One refined batch as that tree's _search_lut_pallas runs it."""
        t = tables()
        pv, pi = pairs(which, t)
        q_sq = (t[4] * t[4]).sum(1)
        _, cand = ivf_pq._finish_candidates(
            -0.5 * pv.reshape(B, -1), pi.reshape(B, -1), zeros, q_sq, dist,
            k_cand)
        return trefine.refine(base, q0, cand, k)

    t = tables()
    tk, ti = pairs("this", t)
    gk, gi = pairs("other", t)
    fin = torch.isfinite(gk)
    q_sq = (t[4] * t[4]).sum(1)[:, None, None].expand_as(gk)
    tol = 1e-3 + 1e-5 * (gk.abs() + q_sq)
    agree = {"finite_pattern_equal": bool(torch.equal(torch.isfinite(tk),
                                                      fin)),
             "max_diff_over_tolerance": float(((tk - gk).abs()[fin]
                                               / tol[fin]).max()),
             "id_agreement": float((ti[fin] == gi[fin]).float().mean())}
    ids_this, ids_other = batch("this")[1], batch("other")[1]
    agree["refined_ids_equal"] = float((ids_this == ids_other).float().mean())
    agree["search_equals_mirror"] = bool(torch.equal(
        ivf_pq.search(index, q0, k, ivf_pq.SearchParams(
            n_probes=n_probes, scan_select="pallas", refine="f32_regen",
            refine_ratio=k_cand // k, lut_dtype="bfloat16"),
            dataset=base)[1], ids_this))
    for rnd in range(args.rounds):
        for which in ("this", "other", "other", "this"):
            scan_ms = _timed(lambda: scan(which, t), 20)
            batch_ms = _timed(lambda: batch(which), 20)
            print(json.dumps({"kernel": "ivfpq_lut_scan", "round": rnd,
                              "library": which, "scan_ms": scan_ms,
                              "search_batch_ms": batch_ms}), flush=True)
    print(json.dumps({"card": card, "kernel": "ivfpq_lut_scan", "n": args.n,
                      "n_seg": n_seg, "max_list_size": L,
                      "outputs_agree": agree}), flush=True)


def _ab_gather_refine(args, card: str) -> None:
    """gather_refine_topk of both trees on the scans' candidates (see the
    module note)."""
    import torch

    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import kernels as this_k

    mods = {"this": this_k, "other": _other_kernels(args.other, args.kernel)}
    k, cases = 10, []
    for n, d in ((args.n, 96), (args.n // 2, 128)):
        ds = DeviceSynthetic(n, d, n_centers=10_000, seed=args.seed, std=0.5,
                             scale=10.0)
        base, q = ds.base(), ds.queries(500)
        index = ivf_pq.build(base, ivf_pq.IndexParams(
            n_lists=8192, pq_dim=64, pq_bits=8, cache_reconstruction="never",
            seed=args.seed))
        _, cand = ivf_pq.search(index, q, 400, ivf_pq.SearchParams(
            n_probes=64, scan_select="pallas", refine="none",
            lut_dtype="bfloat16"))
        del index
        torch.cuda.empty_cache()
        cases.append((f"[500,400] into [{n},{d}]", base, q,
                      cand.contiguous()))
    agree = {}
    for name, base, q, cand in cases:
        (va, ia), (vb, ib) = (mods[w].gather_refine_topk(base, q, cand, k, "l2")
                              for w in ("this", "other"))
        tol = 1e-5 * ((q * q).sum(1, keepdim=True) + vb.abs())
        gap = (vb[:, 1:] - vb[:, :-1]).abs() <= tol[:, 1:]
        tie = torch.zeros_like(gap[:, :1]).expand(-1, k).clone()
        tie[:, 1:] |= gap
        tie[:, :-1] |= gap
        tie[:, -1] = True
        agree[name] = {"max_diff_over_tolerance": float(
                           ((va - vb).abs() / tol).max()),
                       "ids_equal_away_from_ties": bool(
                           ((ia == ib) | tie).all()),
                       "ids_equal": float((ia == ib).float().mean())}
    for rnd in range(args.rounds):
        for which in ("this", "other", "other", "this"):
            for name, base, q, cand in cases:
                fn = (lambda m=mods[which], b=base, q=q, c=cand:
                      m.gather_refine_topk(b, q, c, k, "l2"))
                print(json.dumps({"kernel": "gather_refine", "round": rnd,
                                  "library": which, "shape": name,
                                  "cold_ms": _timed_cold(fn, 30),
                                  "warm_ms": _timed(fn, 50)}), flush=True)
    print(json.dumps({"card": card, "kernel": "gather_refine",
                      "outputs_agree": agree}), flush=True)


_FLAT_PHASE = """
import json, os, sys, types
root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path.insert(0, root)
import chip_smoke
_, s = chip_smoke.flat_phase(types.SimpleNamespace(seed=int(sys.argv[2])), [])
print("FLAT_PHASE " + json.dumps({k: s[k] for k in (
    "qps", "dropped_rows", "recall_at_10", "batch_stages_ms")}), flush=True)
"""


_MAIN_PATH = """
import json, os, sys, time
root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path.insert(0, root)
import torch
from raft_tpu_torch.bench.dataset import DeviceSynthetic
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.ops import build as kbuild
kbuild.build_all()
n, seed = int(sys.argv[2]), int(sys.argv[3])
ds = DeviceSynthetic(n, 96, n_centers=10_000, seed=seed, std=0.5, scale=10.0)
base, queries = ds.base(), ds.queries(10_000)
index = ivf_pq.build(base, ivf_pq.IndexParams(
    n_lists=8192, pq_dim=64, pq_bits=8, cache_reconstruction="never",
    seed=seed))
sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                         refine="f32_regen", refine_ratio=40,
                         lut_dtype="bfloat16")
qps = []
for _ in range(3):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for a in range(0, 10_000, 500):
        ivf_pq.search(index, queries[a:a + 500], 10, sp, dataset=base)
    end.record()
    torch.cuda.synchronize()
    qps.append(10_000 / (start.elapsed_time(end) / 1e3))
# a batch alone: the host's launches before the scan are not hidden
batches = [queries[a:a + 500] for a in range(0, 10_000, 500)]
alone = []
for q in batches:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf_pq.search(index, q, 10, sp, dataset=base)
    torch.cuda.synchronize()
    alone.append((time.perf_counter() - t0) * 1e3)
out = {"qps": qps, "alone_ms_median": sorted(alone)[len(alone) // 2]}
# chip_smoke.py's [stages] search_total: one batch, five calls back to back
q0 = queries[:500].contiguous()
ivf_pq.search(index, q0, 10, sp, dataset=base)
torch.cuda.synchronize()
start = torch.cuda.Event(enable_timing=True)
end = torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(5):
    ivf_pq.search(index, q0, 10, sp, dataset=base)
end.record()
torch.cuda.synchronize()
out["search_total_ms"] = start.elapsed_time(end) / 5
from raft_tpu_torch import obs
if hasattr(obs, "enable"):  # a checkout with recording spans
    from raft_tpu_torch.obs import trace
    trace.get_buffer().clear()
    obs.enable(sync=True, events=True, registry=obs.MetricsRegistry())
    for q in batches[:10]:
        ivf_pq.search(index, q, 10, sp, dataset=base)
    obs.disable()
    root = sorted(1e3 * e["dur"] for e in trace.get_buffer().snapshot()
                  if e.get("ph") == "X" and e["name"] == "ivf_pq.search")
    out["root_span_ms_median"] = root[len(root) // 2]
    out["root_over_search_total"] = (out["root_span_ms_median"]
                                     / out["search_total_ms"] - 1.0)
print("MAIN_PATH " + json.dumps(out), flush=True)
"""


def _ab_main_path(args, card: str) -> None:
    """chip_smoke.py's [main] search of both checkouts in turns, a process
    each (see the module note)."""
    roots = {"this": os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "other": args.other}
    for rnd in range(args.rounds):
        for which in ("this", "other", "other", "this"):
            out = subprocess.run(
                [sys.executable, "-c", _MAIN_PATH, roots[which],
                 str(args.n), str(args.seed)], capture_output=True,
                text=True, check=True)
            line = [x for x in out.stdout.splitlines()
                    if x.startswith("MAIN_PATH ")][-1]
            print(json.dumps({"phase": "main", "round": rnd,
                              "library": which,
                              **json.loads(line[len("MAIN_PATH "):])}),
                  flush=True)
    print(json.dumps({"card": card, "phase": "main"}), flush=True)


def _ab_flat_phase(args, card: str) -> None:
    """chip_smoke.flat_phase of both checkouts in turns, a process each
    (see the module note)."""
    roots = {"this": os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "other": args.other}
    for rnd in range(args.rounds):
        for which in ("this", "other", "other", "this"):
            out = subprocess.run(
                [sys.executable, "-c", _FLAT_PHASE, roots[which],
                 str(args.seed)], capture_output=True, text=True, check=True)
            line = [x for x in out.stdout.splitlines()
                    if x.startswith("FLAT_PHASE ")][-1]
            print(json.dumps({"phase": "flat", "round": rnd,
                              "library": which,
                              **json.loads(line[len("FLAT_PHASE "):])}),
                  flush=True)
    print(json.dumps({"card": card, "phase": "flat"}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, action="append",
                    help="root of the other checkout (several for the "
                    "kernels timed through their wrappers)")
    ap.add_argument("--kernel", choices=sorted(SOURCES),
                    default="ivfpq_lut_scan")
    ap.add_argument("--n", type=int, default=10_000_000,
                    help="rows of the ivfpq_lut_scan comparison, of "
                    "fused_l2_argmin's IVF-PQ shape and of gather_refine's "
                    "d 96 shape (its d 128 shape takes half)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--wide", action="store_true",
                    help="fused_l2_argmin at wide d (see the module note)")
    ap.add_argument("--flat-build", action="store_true",
                    help="IVF-Flat builds with each tree's fused_l2_argmin")
    ap.add_argument("--flat-phase", action="store_true",
                    help="chip_smoke.py's IVF-Flat phase of each checkout")
    ap.add_argument("--main-path", action="store_true",
                    help="chip_smoke.py's [main] search of each checkout")
    args = ap.parse_args(argv)
    if (args.wide or args.flat_build) and args.kernel != "fused_l2_argmin":
        ap.error("--wide and --flat-build take --kernel fused_l2_argmin")
    if (args.flat_build or args.flat_phase or args.main_path
            or args.kernel in ("ivfpq_lut_scan", "gather_refine")):
        if len(args.other) > 1:
            ap.error("this mode takes one --other")
        args.other = args.other[0]

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    if args.main_path:
        _ab_main_path(args, card)
    elif args.flat_phase:
        _ab_flat_phase(args, card)
    elif args.kernel == "ivfpq_lut_scan":
        _ab_lut_scan(args, card)
    elif args.kernel == "gather_refine":
        _ab_gather_refine(args, card)
    elif args.flat_build:
        _ab_flat_build(args, card)
    else:
        _ab_wrapper(args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
