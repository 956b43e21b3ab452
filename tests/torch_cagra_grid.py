#!/usr/bin/env python3
"""CAGRA's recall@10 on a card at GIST-1M's shape over search settings.

    python3 tests/torch_cagra_grid.py [--seed S]

Builds ``chip_smoke.py``'s ``[cagra]`` index twice (1M x 960
``DeviceSynthetic`` rows, 10,000 centers, graph_degree 64; the default
build and one with ``knn_neighborhood=32``) and searches its 1,000 queries
at the smoke's settings (itopk 64, width 8, 6 iterations), deeper ones,
more entry clusters and more random seeds: recall@10 against
``brute_force.knn`` and QPS (one warm batch of 1,000, host clock around a
synchronised call) for each. Also the mean exact distance of ranks 1, 10,
100, 101 and 200 over 100 queries. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raft_tpu_torch.bench.dataset import DeviceSynthetic  # noqa: E402
from raft_tpu_torch.neighbors import brute_force, cagra  # noqa: E402
from raft_tpu_torch.ops import build as kbuild  # noqa: E402

SEARCHES = (
    dict(itopk_size=64, search_width=8, max_iterations=6),
    dict(itopk_size=64, search_width=8, max_iterations=20),
    dict(itopk_size=128, search_width=8, max_iterations=20),
    dict(itopk_size=256, search_width=16, max_iterations=40),
    dict(itopk_size=64, search_width=8, max_iterations=6, entry_clusters=16),
    dict(itopk_size=64, search_width=8, max_iterations=6, num_seeds=4096),
)
BUILDS = (dict(), dict(knn_neighborhood=32))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cagra_grid: no CUDA device", file=sys.stderr)
        return 2
    kbuild.build_all()
    ds = DeviceSynthetic(1_000_000, 960, n_centers=10_000, seed=args.seed + 3)
    base = ds.base()
    q = ds.queries(1000)
    _, gt = brute_force.knn_arrays(base, q, 10, metric="sqeuclidean")
    gt = gt.cpu().numpy()
    d, _ = brute_force.knn_arrays(base, q[:100], 200, metric="sqeuclidean")
    print("[grid] exact distances of ranks 1/10/100/101/200:",
          d[:, [0, 9, 99, 100, 199]].mean(0).tolist(), flush=True)
    for kw in BUILDS:
        index = cagra.build(base, cagra.IndexParams(graph_degree=64,
                                                    seed=args.seed, **kw))
        for sp in SEARCHES:
            p = cagra.SearchParams(traverse="f32", **sp)
            cagra.search(index, q, 10, p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, ids = cagra.search(index, q, 10, p)
            torch.cuda.synchronize()
            qps = 1000 / (time.perf_counter() - t0)
            ids = ids.cpu().numpy()
            rec = float(np.mean([len(set(a) & set(b)) / 10
                                 for a, b in zip(ids, gt)]))
            print(f"[grid] build {kw} search {sp}: recall@10 {rec:.4f}, "
                  f"{qps:.0f} QPS", flush=True)
        del index
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
