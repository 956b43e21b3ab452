#!/usr/bin/env python3
"""Time k-means++ seeding of this tree against another checkout's, in
turns, on one card.

    python3 tests/torch_kmeans_init_ab.py --other DIR [--rounds R]

DIR is the root of another checkout of the repo, for example a parent
commit unpacked with ``git archive``. Each round runs this tree, the
other, the other, this tree, each in a process of its own that imports
its checkout's ``raft_tpu_torch``. A process makes ``chip_smoke.py``'s
``[kmeans]`` rows (``DeviceSynthetic`` 1M x 128 around 1,000 centers,
seed 7) on the card and times ``kmeans.init_plus_plus`` of 1,000 centers
from the fit's first trial key twice (the host's clock around the call,
the card synchronised after it; the first call warms up), and prints one
``KMINIT {json}`` line: the tree, both times and the sha256 of the
centers, which must be equal across trees when the draws are. Prints the
card's name and power limit. Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import hashlib, json, sys, time
root, tag, n, dim, k, std, seed = sys.argv[1:8]
sys.path.insert(0, root)
import torch
from raft_tpu_torch.bench.dataset import DeviceSynthetic
from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.random import threefry
from raft_tpu_torch.random.rng import RngState

x = DeviceSynthetic(int(n), int(dim), n_centers=int(k), seed=int(seed),
                    std=float(std), scale=10.0).base()
key = threefry.fold_in(RngState(int(seed)).key(), 0)
secs = []
for _ in range(2):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = kmeans.init_plus_plus(key, x, int(k))
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
sha = hashlib.sha256(c.cpu().numpy().tobytes()).hexdigest()[:16]
print("KMINIT " + json.dumps({"tree": tag, "init_s": secs, "sha": sha}),
      flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import chip_smoke as C

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    trees = {"this": HERE, "other": os.path.abspath(args.other)}
    shas = set()
    for _ in range(args.rounds):
        for tag in ("this", "other", "other", "this"):
            out = subprocess.run(
                [sys.executable, "-c", _CHILD, trees[tag], tag,
                 str(C.KMEANS_N), str(C.KMEANS_DIM), str(C.KMEANS_K),
                 str(C.KMEANS_STD), "7"],
                capture_output=True, text=True, timeout=600, check=True)
            line = [s for s in out.stdout.splitlines()
                    if s.startswith("KMINIT ")][-1]
            print(line, flush=True)
            shas.add(json.loads(line[7:])["sha"])
    print(f"centers equal across trees: {len(shas) == 1}", flush=True)
    return 0 if len(shas) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
