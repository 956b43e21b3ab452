#!/usr/bin/env python3
"""Where the card's CAGRA search and the CPU's part, over fresh builds.

    python3 tests/torch_cagra_splits.py [--builds N] [--queries M]

Makes ``chip_smoke.py``'s ``[cagra]`` rows (``DeviceSynthetic`` 1M x 960,
GIST-1M's shape, seed 10) and builds the index ``--builds`` times as a
user builds it (its atomic sums give a new graph each time). For each
build it runs the smoke's ``cagra_card_vs_cpu`` on the first ``--queries``
queries (f32, int8 traversal, filtered at selectivity 0.1) and prints one
``SPLITS {json}`` line: the graph's sha256, per mode the slots swapped at
f64 ties, the queries whose ten results differ away from an f64 tie
(which a comparison of the outputs alone would refuse), and for each the
selection where its two traversals part and the swapped pair's keys on
both devices. A query whose traversals part at no rounding tie is a
fault: the line says so and its record is written to ``chiprun_out/``.
Prints the card's name and power limit. Needs a CUDA card; imports no
JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from raft_tpu_torch.bench.dataset import DeviceSynthetic  # noqa: E402
from raft_tpu_torch.core import bitset  # noqa: E402
from raft_tpu_torch.neighbors import cagra  # noqa: E402
from raft_tpu_torch.ops import build as kbuild  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--builds", type=int, default=3)
    ap.add_argument("--queries", type=int, default=1000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    kbuild.build_all()
    seed, k = 7, 10
    ds = DeviceSynthetic(C.CAGRA_N, C.CAGRA_DIM, n_centers=10_000,
                         seed=seed + 3)
    base = ds.base()
    queries = ds.queries(max(args.queries, C.CAGRA_QUERIES))[:args.queries]
    params = cagra.IndexParams(graph_degree=C.CAGRA_DEGREE, seed=seed)
    sp = cagra.SearchParams(itopk_size=64, search_width=8, max_iterations=6,
                            traverse="f32")
    sp8 = dataclasses.replace(sp, traverse="int8")
    bits = bitset.from_mask(C.bench_keep(C.CAGRA_N, 0.1, k))
    faults = 0
    for b in range(args.builds):
        t0 = time.perf_counter()
        index = cagra.build(base, params)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sha = hashlib.sha256(index.graph.cpu().numpy().tobytes())
        codes, scale, zero = cagra._quantize_rows(base)
        index_q = dataclasses.replace(index, dataset_q=codes, q_scale=scale,
                                      q_zero=zero)
        rec = {"build": b, "graph_sha": sha.hexdigest()[:16],
               "build_s": build_s}
        t0 = time.perf_counter()
        try:
            rec["modes"] = C.cagra_card_vs_cpu(index, index_q, base, queries,
                                               k, sp, sp8, bits)
        except C.SmokeFailure as e:
            faults += 1
            rec["fault"] = str(e)
        rec["check_s"] = time.perf_counter() - t0
        print("SPLITS " + json.dumps(rec), flush=True)
        del index, index_q, codes
        torch.cuda.empty_cache()
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
