#!/usr/bin/env python3
"""Time two of ``chip_smoke.py``'s legs with and without
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` on one card.

    python3 tests/torch_cublas_env_ab.py [--pairs P] [--log-dir DIR]

The smoke sets that variable for its whole process, because its builds
compared by sha run under ``torch.use_deterministic_algorithms``. This
script asks whether the setting moves the other legs. It starts one child
process a turn, the variable unset then set, in the order off, on, on, off
(``--pairs`` such rounds). Each child, on ``cuda:0``:

1. measures the cuBLAS workspace the first product on the current stream
   takes from the caching allocator (``torch.cuda.memory_allocated`` before
   and after, less the product's output);
2. runs the smoke's ``[main]`` leg: ``DeviceSynthetic`` 10M x 96 rows,
   ``ivf_pq.build`` (8192 lists, pq_dim 64, 8-bit), then three passes of
   10,000 queries in batches of 500 (n_probes 64, ``scan_select="pallas"``,
   refine_ratio 40, bf16 LUT), timed by CUDA events;
3. frees it and runs the ``[chunked]`` leg's build: ``build_chunked`` of
   ``DeviceSyntheticChunks`` at ``CHUNKED_N`` x ``CHUNKED_DIM`` in 2^20-row
   blocks, spill on, list cap 4, 10 k-means iterations, with its stage
   seconds.

One JSON line a child, then a summary line of both settings' readings.
Each child's whole output goes to ``--log-dir`` (default
``chiprun_out/``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAR, VALUE = "CUBLAS_WORKSPACE_CONFIG", ":4096:8"


def child(seed: int) -> dict:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from raft_tpu_torch.bench.dataset import DeviceSynthetic, \
        DeviceSyntheticChunks
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import build as kbuild

    dev = torch.device("cuda", 0)
    out = {"env": os.environ.get(VAR)}
    a = torch.randn(256, 256, device=dev)
    b = torch.randn(256, 256, device=dev)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(dev)
    c = a @ b
    torch.cuda.synchronize()
    out["cublas_workspace_bytes"] = int(
        torch.cuda.memory_allocated(dev) - m0 - c.numel() * c.element_size())
    del a, b, c
    kbuild.build_all()

    # the [main] leg
    n, dim, nq, B, k = 10_000_000, 96, 10_000, 500, 10
    ds = DeviceSynthetic(n, dim, n_centers=10_000, seed=seed, std=0.5,
                         scale=10.0)
    base, queries = ds.base(), ds.queries(nq)
    params = ivf_pq.IndexParams(n_lists=8192, pq_dim=64, pq_bits=8,
                                cache_reconstruction="never", seed=seed)
    sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                             refine="f32_regen", refine_ratio=40,
                             lut_dtype="bfloat16")
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_pq.build(base, params, stage_seconds=stages)
    torch.cuda.synchronize()
    out["main_build_s"] = time.perf_counter() - t0
    out["main_build_stages_s"] = stages
    qps = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for q in range(0, nq, B):
            ivf_pq.search(index, queries[q:q + B], k, sp, dataset=base)
        end.record()
        torch.cuda.synchronize()
        qps.append(nq / (start.elapsed_time(end) / 1e3))
    out["main_qps"] = qps
    del index, base, queries, ds
    torch.cuda.empty_cache()

    # the [chunked] leg's build
    chunk = 1 << 20
    cds = DeviceSyntheticChunks(smoke.CHUNKED_N, smoke.CHUNKED_DIM,
                                n_centers=10_000, seed=seed,
                                chunk_rows=chunk, device=dev)
    cparams = ivf_pq.IndexParams(n_lists=8192, pq_dim=64, pq_bits=8,
                                 spill=True, list_size_cap_factor=4.0,
                                 kmeans_n_iters=10, seed=seed)
    stages = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_pq.build_chunked(cds, cparams, chunk_rows=chunk,
                                 progress=True, device=dev,
                                 stage_seconds=stages)
    torch.cuda.synchronize()
    out["chunked_build_s"] = time.perf_counter() - t0
    out["chunked_stages_s"] = stages
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--log-dir", default=os.path.join(ROOT, "chiprun_out"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print("RESULT " + json.dumps(child(args.seed)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("torch_cublas_env_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    os.makedirs(args.log_dir, exist_ok=True)
    order = [False, True, True, False] * args.pairs
    results = []
    for i, on in enumerate(order):
        env = {k: v for k, v in os.environ.items() if k != VAR}
        if on:
            env[VAR] = VALUE
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--seed", str(args.seed)], env=env, capture_output=True,
            text=True, timeout=1200)
        log = os.path.join(args.log_dir, f"cublas_env_ab_{i}.log")
        with open(log, "w") as f:
            f.write(proc.stdout + proc.stderr)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(f"child {i} ({VAR}={'set' if on else 'unset'}) failed "
                  f"with code {proc.returncode}; see {log}", file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len("RESULT "):])
        results.append(res)
        print(json.dumps(res), flush=True)
    summary = {}
    for on in (False, True):
        rs = [r for r, o in zip(results, order) if o == on]
        summary["set" if on else "unset"] = {
            "cublas_workspace_bytes": [r["cublas_workspace_bytes"]
                                       for r in rs],
            "main_qps": [r["main_qps"] for r in rs],
            "main_build_s": [r["main_build_s"] for r in rs],
            "chunked_build_s": [r["chunked_build_s"] for r in rs],
            "chunked_spill_s": [r["chunked_stages_s"].get("spill")
                                for r in rs],
            "chunked_upload_s": [r["chunked_stages_s"].get("upload")
                                 for r in rs]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
