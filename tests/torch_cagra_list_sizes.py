"""List sizes of CAGRA's cluster build, the two packages side by side.

    JAX_PLATFORMS=cpu python tests/torch_cagra_list_sizes.py \
        [--n ROWS] [--dim D] [--seed S] [--no-jax]
    python tests/torch_cagra_list_sizes.py --device cuda --no-jax

``cagra.cluster_knn_graph``'s k-means step at the smoke's ``[cagra]``
shape: ``DeviceSynthetic(n, dim, n_centers=10_000)`` rows (made on
``--device``: CPU and card generators give other rows of the same
distribution), projected onto the build's 128-d basis
(``cagra._build_projection``), n / 1024 lists, the build's train sample
(``np.random.default_rng(seed).choice``, n / 4 rows) and
``KMeansBalancedParams(n_iters=10, seed=seed)``. The port's
``kmeans_balanced.fit``/``predict`` and the JAX package's run on the same
projected rows; one JSON line per package gives the list-size histogram
over all n rows (min, percentiles, max, lists under a quarter of the mean
and past twice it) and the padded list capacity ``L`` the blocked scan
would take (``ivf_common._fit_list_size`` at factor 4). The line
``jax_centers_port_predict`` assigns with the port against the JAX
package's centers, which separates the fit from the assignment.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _histogram(labels, n_lists, n):
    from raft_tpu_torch.neighbors import ivf_common

    sizes = np.bincount(np.asarray(labels, np.int64), minlength=n_lists)
    mean = n / n_lists
    return {"min": int(sizes.min()),
            "p1_p10_p50_p90_p99": [float(v) for v in np.percentile(
                sizes, [1, 10, 50, 90, 99])],
            "max": int(sizes.max()), "mean": mean,
            "under_quarter_mean": int((sizes < mean / 4).sum()),
            "past_twice_mean": int((sizes > 2 * mean).sum()),
            "L": ivf_common._fit_list_size(sizes, max(1, n // n_lists), 4.0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=960)
    ap.add_argument("--seed", type=int, default=7,
                    help="the smoke's --seed: data seed + 3, k-means seed")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--no-jax", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.cluster import kmeans_balanced as tkb
    from raft_tpu_torch.neighbors import cagra

    n, seed = args.n, args.seed
    n_lists = max(8, n // 1024)
    t0 = time.perf_counter()
    ds = DeviceSynthetic(n, args.dim, n_centers=10_000, seed=seed + 3,
                         device=args.device)
    proj = cagra._build_projection(args.dim, 128, seed, ds.device)
    g = ds._gen(1)
    x = torch.cat([ds._sample(min(n, a + 65536) - a, g) @ proj
                   for a in range(0, n, 65536)])
    pick = np.sort(np.random.default_rng(seed).choice(
        n, min(n, max(n_lists * 4, n // 4)), replace=False))
    train = x[torch.from_numpy(pick).to(x.device)]
    print(json.dumps({"rows": [n, 128], "train": int(pick.size),
                      "n_lists": n_lists, "device": args.device,
                      "data_s": time.perf_counter() - t0}), flush=True)

    km = tkb.KMeansBalancedParams(n_iters=10, metric="l2", seed=seed)
    t0 = time.perf_counter()
    centers = tkb.fit(train, n_lists, km)
    labels = torch.cat([tkb.predict(centers, x[a:a + 65536], km)
                        for a in range(0, n, 65536)]).cpu().numpy()
    print(json.dumps({"package": "port", **_histogram(labels, n_lists, n),
                      "seconds": time.perf_counter() - t0}), flush=True)
    if args.no_jax:
        return 0

    import jax.numpy as jnp

    from raft_tpu.cluster import kmeans_balanced as jkb

    xj = jnp.asarray(x.cpu().numpy())
    jkm = jkb.KMeansBalancedParams(n_iters=10, metric="l2", seed=seed)
    t0 = time.perf_counter()
    jcenters = jkb.fit(xj[jnp.asarray(pick)], n_lists, jkm)
    jlabels = np.concatenate([np.asarray(jkb.predict(jcenters,
                                                     xj[a:a + 65536], jkm))
                              for a in range(0, n, 65536)])
    print(json.dumps({"package": "jax", **_histogram(jlabels, n_lists, n),
                      "seconds": time.perf_counter() - t0}), flush=True)
    cross = torch.cat([tkb.predict(torch.from_numpy(np.array(jcenters)),
                                   x[a:a + 65536].cpu(), km)
                       for a in range(0, n, 65536)]).numpy()
    print(json.dumps({"package": "jax_centers_port_predict",
                      **_histogram(cross, n_lists, n),
                      "labels_equal_jax": float((cross == jlabels).mean())}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
