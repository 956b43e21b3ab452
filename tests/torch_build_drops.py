"""Rows dropped past every spill choice by the two spill builds of
``chip_smoke.py``'s 1M x 128 hard set — the bench configs
``ivf_pq.n1024.d64`` (pq_dim 64, the default cache rule) and
``ivf_flat.n1024`` (both 1024 lists, spill, cap factor 1.5) — with one
checkout's ``raft_tpu_torch``, on the card:

    python3 tests/torch_build_drops.py [--tree DIR] [--builds N]

``--tree`` names the checkout whose package is imported (default: this
one), so two trees can be run in turns in one call (this, other, other,
this) to compare their spreads: the card's builds are not bit-reproducible
(``index_add_`` sums in another order each run), so one seed gives a
spread of drops, not a number. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--builds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    tree = os.path.realpath(args.tree)
    sys.path.insert(0, tree)

    import torch

    import raft_tpu_torch
    from raft_tpu_torch.bench.dataset import make_synthetic_hard
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq

    if not os.path.realpath(raft_tpu_torch.__file__).startswith(tree):
        print(f"imported {raft_tpu_torch.__file__}, not {tree}",
              file=sys.stderr)
        return 2
    n = 1_000_000
    ds = make_synthetic_hard("sift-1000k-hard-synth", n, 128, 10,
                             seed=args.seed)
    base = torch.from_numpy(ds.base).cuda()
    kw = dict(n_lists=1024, spill=True, list_size_cap_factor=1.5,
              seed=args.seed)
    drops = {"ivf_pq.n1024.d64": [], "ivf_flat.n1024": []}
    for _ in range(args.builds):
        index = ivf_pq.build(base, ivf_pq.IndexParams(pq_dim=64, **kw))
        drops["ivf_pq.n1024.d64"].append(n - index.size)
        del index
        flat = ivf_flat.build(base, ivf_flat.IndexParams(**kw))
        drops["ivf_flat.n1024"].append(n - flat.size)
        del flat
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "card": torch.cuda.get_device_name(0),
                      "dropped_rows": drops}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
