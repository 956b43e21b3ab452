"""Host cost of the IVF-PQ LUT tier's steps before its scan kernel, on a
card.

    python3 tests/torch_lut_host_cost.py [--n ROWS] [--seed S]
    python3 tests/torch_lut_host_cost.py --isolated [--other DIR]
        [--cublas-workspace] [--reps R] [--n ROWS] [--seed S]

Steps (the default): each step's enqueue time (the host's clock around
back-to-back calls, the card draining behind; the least mean of five
rounds), eagerly and, for the index tables, replayed from a CUDA graph
(``raft_tpu_torch.utils.graphs``). The index is ``chip_smoke.py``'s main
path at ``--n`` rows (default 2M: the steps timed here do not depend on
the rows; 8192 lists, pq_dim 64, 8-bit codes) and one batch of 500
queries at n_probes 64, so the segment table has the main path's shape.
Prints one line a step and the card's name and power limit.

``--isolated``: what ``chip_smoke.py``'s ``[obs spans]`` root rule reads,
at the main path's size (``--n`` default 10M there). An isolated refined
batch waits for the host's launches before its scan starts; a batch
among others does not. Each process builds the index and prints, as
``HOSTCOST {json}`` lines:

- ``rule``, ``--reps`` times: ``[stages]``' ``search_total`` (one batch
  of 500, five calls back to back after one, CUDA events) and the root
  span's median over ten sync-mode refined batches (``obs.enable(sync=
  True, events=True)``), and the root's share over ``search_total``;
- ``timeline``: the medians over 20 isolated batches (the card idle at
  each call) of the host's µs from the call to the entry of each layer
  and wrapper on the way (``host_us_to_<name>#<n>``, the n-th entry) and
  to the call's return, and of the card's ms from the call to the coarse
  select's (B3) and the scan's (B1) wrappers and from there to the end
  (CUDA events recorded at those entries);
- ``sequence``: each step before B1 run alone in the batch's order
  (``_sequence``; a tree whose coarse select takes the ‖c‖² bias row, B3's
  operand, reads its ``sub`` step as 0).

``--cublas-workspace`` runs the children with chip_smoke.py's former
process-wide ``CUBLAS_WORKSPACE_CONFIG``. ``--other DIR`` runs the same
in a checkout DIR (a parent unpacked with ``git archive``) in the order
this, other, other, this, a process each.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host_us(fn, reps: int = 300) -> float:
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        rounds.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return min(rounds)


def _steps(args) -> int:
    import torch

    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import ivf_common as ic
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import build as kbuild
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.utils import graphs

    kbuild.build_all()
    ds = DeviceSynthetic(args.n or 2_000_000, 96, n_centers=10_000,
                         seed=args.seed)
    index = ivf_pq.build(ds.base(), ivf_pq.IndexParams(
        n_lists=8192, pq_dim=64, pq_bits=8, cache_reconstruction="never",
        seed=args.seed))
    B, P, seg = 500, 64, ic.SEGMENT_SIZE
    n_seg = ic.n_segments(B * P, index.n_lists, seg)
    q = ds.queries(B)
    qg = K.lut_scan_fit(index.pq_dim, 1 << index.pq_bits, index.rot_dim, seg,
                        index.packed_codes.shape[-1])[0]
    with torch.inference_mode():
        _, probes = ivf_pq._coarse_probes(index, q, P, False)
        tabs = ic.segment_probes(probes, index.n_lists, seg, n_seg)

    def segment_replayed():
        with graphs.replayed(ic.segment_probes, (probes,), index.n_lists,
                             seg, n_seg) as out:
            return out

    def tables_replayed():
        with graphs.replayed(K.lut_scan_tables, tabs[1:], qg) as out:
            return out

    def both_replayed():
        with graphs.replayed(ivf_pq._index_tables, (probes,),
                             index.n_lists, seg, n_seg, qg) as out:
            return out

    steps = {
        "coarse probes (matmul, select_k)": lambda: ivf_pq._coarse_probes(
            index, q, P, False),
        "rotation": lambda: (q @ index.rotation.T).contiguous(),
        "segment_probes, eager": lambda: ic.segment_probes(
            probes, index.n_lists, seg, n_seg),
        "segment_probes, replayed": segment_replayed,
        "lut_scan_tables, eager": lambda: K.lut_scan_tables(*tabs[1:], qg),
        "lut_scan_tables, replayed": tables_replayed,
        "segment_probes and lut_scan_tables, one graph": both_replayed,
    }
    for name, fn in steps.items():
        with torch.inference_mode():
            us = _host_us(fn)
        print(f"[host] {name}: {us:.1f} us a call", flush=True)
    return 0


def _isolated_child(args) -> int:
    """One process of ``--isolated`` (see the module note)."""
    import statistics

    import torch

    from raft_tpu_torch import obs
    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.obs import trace
    from raft_tpu_torch.ops import build as kbuild
    from raft_tpu_torch.ops import kernels as K

    kbuild.build_all()
    n = args.n or 10_000_000
    ds = DeviceSynthetic(n, 96, n_centers=10_000, seed=args.seed, std=0.5,
                         scale=10.0)
    base, queries = ds.base(), ds.queries(10_000)
    index = ivf_pq.build(base, ivf_pq.IndexParams(
        n_lists=8192, pq_dim=64, pq_bits=8, cache_reconstruction="never",
        seed=args.seed))
    sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                             refine="f32_regen", refine_ratio=40,
                             lut_dtype="bfloat16")
    B, k = 500, 10
    batches = [queries[a:a + B] for a in range(0, 10_000, B)]

    def run(q):
        return ivf_pq.search(index, q, k, sp, dataset=base)

    # host stamps at the entry of each layer of a refined batch, CUDA
    # events beside the coarse select's (B3) and the scan's (B1) wrappers
    from raft_tpu_torch.neighbors import refine as R
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.utils import graphs

    trail = []
    recording = [False]

    def stamped(mod, attr, event=False):
        fn = getattr(mod, attr)

        def wrapper(*a, **kw):
            if recording[0]:
                ev = None
                if event:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                trail.append((attr, time.perf_counter(), ev))
            return fn(*a, **kw)
        for name in ("launches", "filtered_launches"):
            if hasattr(fn, name):
                setattr(wrapper, name, getattr(fn, name))
        setattr(mod, attr, wrapper)

    for mod, attr, event in (
            (ivf_pq, "search", False), (R, "route_refined", False),
            (ivf_pq, "_refined_scan", False),
            (ivf_pq, "_search_scan", False),
            (ivf_pq, "_search_lut_pallas", False),
            (ivf_pq, "_coarse_probes", False), (ivf_pq, "_select_k", False),
            (spans, "count_dispatch", False), (K, "select_k_cuda", True),
            (K, "_raise_on", False), (graphs, "replayed", False),
            (torch.cuda.CUDAGraph, "replay", False),
            (K, "ivfpq_lut_scan_topk", True), (K, "_use_kernel", False),
            (K, "lut_kernel_codebook", False),
            (ivf_pq, "_finish_candidates", False), (R, "refine", False),
            (K, "gather_refine_topk", False)):
        if hasattr(mod, attr):
            stamped(mod, attr, event)

    for _ in range(3):
        run(batches[0])
    torch.cuda.synchronize()
    for rep in range(args.reps):
        q0 = batches[0]
        run(q0)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run(q0)
        end.record()
        torch.cuda.synchronize()
        total = start.elapsed_time(end) / 5
        trace.get_buffer().clear()
        obs.enable(sync=True, events=True, registry=obs.MetricsRegistry())
        try:
            for q in batches[:10]:
                run(q)
            torch.cuda.synchronize()
        finally:
            obs.disable()
        root = sorted(1e3 * e["dur"] for e in trace.get_buffer().snapshot()
                      if e.get("ph") == "X" and e["name"] == "ivf_pq.search")
        med = root[len(root) // 2]
        print("HOSTCOST " + json.dumps({
            "what": "rule", "rep": rep, "search_total_ms": total,
            "root_median_ms": med, "root_over_search_total": med / total - 1.0}),
            flush=True)
    rows = []
    recording[0] = True
    for q in batches:
        trail.clear()
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        run(q)
        t_ret = time.perf_counter()
        ev1.record()
        torch.cuda.synchronize()
        row, seen, evs = {}, {}, {}
        for name, t, ev in trail:
            seen[name] = seen.get(name, 0) + 1
            row[f"host_us_to_{name}#{seen[name]}"] = 1e6 * (t - t0)
            if ev is not None and name not in evs:
                evs[name] = ev
        row["host_us_to_return"] = 1e6 * (t_ret - t0)
        b1 = evs["ivfpq_lut_scan_topk"]
        row["card_ms_to_select_k_cuda"] = ev0.elapsed_time(
            evs["select_k_cuda"])
        row["card_ms_to_b1"] = ev0.elapsed_time(b1)
        row["card_ms_b1_to_end"] = b1.elapsed_time(ev1)
        rows.append(row)
    recording[0] = False
    print("HOSTCOST " + json.dumps({
        "what": "timeline", "batches": len(rows),
        **{key: statistics.median(r[key] for r in rows) for key in rows[0]}}),
        flush=True)
    _sequence(index, batches[0])
    return 0


def _sequence(index, q) -> None:
    """Host µs of each step before the scan's launch, run in order once
    the card is idle, the median of 20 runs, after each of these waits for
    a ~4 ms kernel (the previous run's scan and a ``torch.cuda._sleep``):
    ``block``, ``torch.cuda.synchronize()``; ``spin``, a loop of event
    queries; ``host_sleep``, the host asleep 6 ms first. ``block`` runs
    again with ``CUBLAS_WORKSPACE_CONFIG`` set, in the same process
    (PyTorch reads it at each cuBLAS call)."""
    import importlib
    import inspect
    import statistics

    import torch

    from raft_tpu_torch.neighbors import ivf_common as ic
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.utils import graphs

    B, P, seg = q.shape[0], 64, ic.SEGMENT_SIZE
    n_seg = ic.n_segments(B * P, index.n_lists, seg)
    qg = K.lut_scan_fit(index.pq_dim, 1 << index.pq_bits, index.rot_dim, seg,
                        index.packed_codes.shape[-1])[0]
    tables = getattr(ivf_pq, "_index_tables", None)
    c_sq = (index.centers * index.centers).sum(1)[None, :]
    # a tree whose select takes the ‖c‖² bias row has no separate sub (read
    # from the module: ``_isolated_child`` wraps ivf_pq._select_k to stamp it)
    folded = "bias" in inspect.signature(importlib.import_module(
        "raft_tpu_torch.matrix.select_k").select_k_impl).parameters
    saved = os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    try:
        cycles = int(4e-3 * 1.98e9)

        def wait(mode):
            torch.cuda._sleep(cycles)
            if mode == "spin":
                ev = torch.cuda.Event()
                ev.record()
                while not ev.query():
                    pass
            elif mode == "host_sleep":
                time.sleep(6e-3)
            torch.cuda.synchronize()

        for setting, mode in ((None, "block"), (None, "spin"),
                              (None, "host_sleep"), (":4096:8", "block")):
            if setting is not None:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = setting
            runs = []
            for _ in range(25):
                wait(mode)
                t = [time.perf_counter()]
                qc = q @ index.centers.T
                t.append(time.perf_counter())
                if folded:      # B3 forms c_sq − 2·qc itself: no sub step
                    t.append(time.perf_counter())
                    _, probes = ivf_pq._select_k(qc, P, select_min=True,
                                                 bias=c_sq)
                else:
                    keys = torch.sub(c_sq, qc, alpha=2.0)
                    t.append(time.perf_counter())
                    _, probes = ivf_pq._select_k(keys, P, select_min=True)
                t.append(time.perf_counter())
                q_rot = (q @ index.rotation.T).contiguous()
                t.append(time.perf_counter())
                if tables is not None:
                    cm = graphs.replayed(tables, (probes,), index.n_lists,
                                         seg, n_seg, qg)
                else:
                    cm = graphs.replayed(ic.segment_probes, (probes,),
                                         index.n_lists, seg, n_seg)
                with cm as tabs:
                    t.append(time.perf_counter())
                    K.ivfpq_lut_scan_topk(
                        *tabs[:4], q_rot, index.packed_codes,
                        index.packed_ids, index.packed_norms,
                        index.list_sizes, index.centers_rot, index.codebooks,
                        "l2", pq_bits=index.pq_bits, pq_dim=index.pq_dim,
                        L=index.max_list_size, lut_dtype="bfloat16",
                        **({"tables": tabs[4:]} if tables is not None
                           else {}))
                    t.append(time.perf_counter())
                runs.append([1e6 * (b - a) for a, b in zip(t, t[1:])])
            torch.cuda.synchronize()
            names = ("coarse_matmul", "sub", "select_k", "rotation",
                     "graph_copy_and_replay", "scan_wrapper")
            print("HOSTCOST " + json.dumps({
                "what": "sequence", "wait": mode,
                "CUBLAS_WORKSPACE_CONFIG": setting,
                **{f"{n}_us": statistics.median(r[i] for r in runs[5:])
                   for i, n in enumerate(names)}}), flush=True)
    finally:
        if saved is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved


def _isolated(args, card: str) -> int:
    """``--isolated``: this checkout, or this and ``--other`` in turns,
    a process each."""
    roots = [("this", ROOT)]
    if args.other:
        roots = [("this", ROOT), ("other", args.other),
                 ("other", args.other), ("this", ROOT)]
    child = [sys.executable, os.path.abspath(__file__), "--child",
             "--n", str(args.n or 10_000_000), "--seed", str(args.seed),
             "--reps", str(args.reps)]
    for which, root in roots:
        env = dict(os.environ)
        if args.cublas_workspace:
            # as chip_smoke.py sets it for its whole process
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        out = subprocess.run(child + ["--root", root], capture_output=True,
                             text=True, env=env)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            if line.startswith("HOSTCOST "):
                print(json.dumps({"tree": which,
                                  **json.loads(line[len("HOSTCOST "):])}),
                      flush=True)
    print(f"[card] {card}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=0,
                    help="rows (default 2M; 10M with --isolated)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--isolated", action="store_true")
    ap.add_argument("--other", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cublas-workspace", action="store_true",
                    help="CUBLAS_WORKSPACE_CONFIG=:4096:8, as chip_smoke.py "
                    "runs")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    if args.child:
        os.chdir(os.path.abspath(args.root))
        return _isolated_child(args)
    import torch

    if not torch.cuda.is_available():
        print("torch_lut_host_cost: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.isolated:
        return _isolated(args, card)
    rc = _steps(args)
    print(f"[card] {card}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
