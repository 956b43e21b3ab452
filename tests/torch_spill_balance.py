"""Spill drops of the two packages' IVF-Flat assignment, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_spill_balance.py \
        [--n ROWS] [--n-lists L] [--seeds S ...]
    python tests/torch_spill_balance.py --device cuda --repeats R ...

For each seed both packages train balanced k-means on the same
``make_synthetic_hard`` trainset (the build's subsample rule), take each
row's ``SPILL_DEPTH`` nearest centers and cascade overflow at the build's
list cap (factor 1.5, as the bench's IVF-Flat index), as
``ivf_flat.build(spill=True)`` does. One JSON line per
(seed, package) gives the rows that overflowed every choice (the build's
dropped rows), the rows whose nearest list was past the cap, and the
nearest-list sizes' max and coefficient of variation. The line
``port_assign_jax_centers`` runs the port's assignment over the JAX
package's centers, which separates the k-means fit from the assignment;
``port_jax_draws`` fits with the port's k-means fed the JAX package's
random draws (the initial rows and the split sweeps' uniforms), which
separates the algorithm from the random numbers. With ``--device cuda``
only the port runs, on the card (where JAX is not installed), ``--repeats``
times per seed: its builds there are not bit-reproducible (``index_add_``
sums in a different order each run), so the repeats show the spread one
seed has.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stats(labels, first, n_lists, cap):
    labels, first = np.asarray(labels), np.asarray(first)
    sizes = np.bincount(first, minlength=n_lists)
    return {"dropped": int((labels >= n_lists).sum()),
            "first_past_cap": int(np.maximum(sizes - cap, 0).sum()),
            "first_max_over_mean": float(sizes.max() / sizes.mean()),
            "first_cv": float(sizes.std() / sizes.mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--n-lists", type=int, default=1024)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from raft_tpu_torch.bench.dataset import make_synthetic_hard
    from raft_tpu_torch.cluster import kmeans_balanced as tkb
    from raft_tpu_torch.neighbors import ivf_common as tic

    n, n_lists = args.n, args.n_lists
    avg = max(1, n // n_lists)
    cap = tic._lane_round(int(avg * 1.5))   # the bench's cap factor
    depth = tic.SPILL_DEPTH

    def port_assign(centers, x):
        lk = tkb.predict_topk(centers, x, depth)
        lab = tic.spill_assignments(lk[:, 0], lk[:, 1], n_lists, cap,
                                    *[lk[:, c] for c in range(2, depth)])
        return lab.cpu().numpy(), lk[:, 0].cpu().numpy()

    if args.device == "cuda":
        for seed in args.seeds:
            x = make_synthetic_hard("sift-hard-synth", n, 128, 10,
                                    seed=seed).base
            n_train = min(n, max(n_lists * 4, n // 2))
            tr = np.sort(np.random.default_rng(seed).choice(
                n, n_train, replace=False))
            xt = torch.from_numpy(x).cuda()
            for rep in range(args.repeats):
                t0 = time.perf_counter()
                tc = tkb.fit(xt[torch.from_numpy(tr).cuda()], n_lists,
                             tkb.KMeansBalancedParams(seed=seed))
                tlab, tfirst = port_assign(tc, xt)
                print(json.dumps({"seed": seed, "n": n, "n_lists": n_lists,
                                  "cap": cap, "avg": avg, "repeat": rep,
                                  "package": "port_cuda",
                                  **_stats(tlab, tfirst, n_lists, cap),
                                  "s": time.perf_counter() - t0}),
                      flush=True)
        return 0

    import jax
    import jax.numpy as jnp

    from raft_tpu.cluster import kmeans_balanced as jkb
    from raft_tpu.neighbors import ivf_common as jic
    from raft_tpu.random.rng import RngState

    for seed in args.seeds:
        ds = make_synthetic_hard("sift-hard-synth", n, 128, 10, seed=seed)
        x = ds.base
        n_train = min(n, max(n_lists * 4, n // 2))
        rng = np.random.default_rng(seed)
        tr = np.sort(rng.choice(n, n_train, replace=False))
        head = {"seed": seed, "n": n, "n_lists": n_lists, "cap": cap,
                "avg": avg}

        t0 = time.perf_counter()
        km = jkb.KMeansBalancedParams(seed=seed)
        jc = jkb.fit(jnp.asarray(x[tr]), n_lists, km)
        lk = jkb.predict_topk(jc, jnp.asarray(x), depth, km)
        jlab = jic.spill_assignments(lk[:, 0], lk[:, 1], n_lists, cap,
                                     *[lk[:, c] for c in range(2, depth)])
        print(json.dumps({**head, "package": "jax",
                          **_stats(jlab, lk[:, 0], n_lists, cap),
                          "s": time.perf_counter() - t0}), flush=True)

        t0 = time.perf_counter()
        xt = torch.from_numpy(x)
        tc = tkb.fit(xt[torch.from_numpy(tr)], n_lists,
                     tkb.KMeansBalancedParams(seed=seed))
        tlab, tfirst = port_assign(tc, xt)
        print(json.dumps({**head, "package": "port",
                          **_stats(tlab, tfirst, n_lists, cap),
                          "s": time.perf_counter() - t0}), flush=True)

        xlab, xfirst = port_assign(torch.from_numpy(np.array(jc)), xt)
        print(json.dumps({**head, "package": "port_assign_jax_centers",
                          **_stats(xlab, xfirst, n_lists, cap)}), flush=True)

        # the port's fit on the JAX package's draws: a port RngState of
        # subsequence s stands for the JAX key folded with s - 1 (s = 0:
        # the key itself), which is how fit derives both
        key = RngState(seed).key()

        def jkey(state):
            sub = state.subsequence
            return key if sub == 0 else jax.random.fold_in(key, sub - 1)

        def init_random(state, x, n_clusters):
            idx = jax.random.choice(jkey(state), x.shape[0], (n_clusters,),
                                    replace=False)
            return x[torch.from_numpy(np.array(idx)).long()].float()

        def uniform(state, n, device):
            u = jax.random.uniform(jkey(state), (n,), minval=1e-6)
            return torch.from_numpy(np.array(u)).to(device)

        saved = tkb.init_random, tkb._uniform
        tkb.init_random, tkb._uniform = init_random, uniform
        try:
            sc = tkb.fit(xt[torch.from_numpy(tr)], n_lists,
                         tkb.KMeansBalancedParams(seed=seed))
        finally:
            tkb.init_random, tkb._uniform = saved
        slab, sfirst = port_assign(sc, xt)
        print(json.dumps({**head, "package": "port_jax_draws",
                          **_stats(slab, sfirst, n_lists, cap)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
