#!/usr/bin/env python3
"""Time the tiered refined search and variants of its pipeline on one card.

    python3 tests/torch_tiered_variants.py [--n ROWS] [--queries M] [--reps R]

First the batch-split check of the library products the scans run: for
[m, 96] × [96, 96] and [m, 96] × [96, 8192] products and the batched
[m, 1, 96] × [m, 96, 400] one, the elements that differ between the whole
10,000-row product and the same rows computed in pieces of m rows.

Then ``chip_smoke.py``'s main IVF-PQ index (10M × 96 ``DeviceSynthetic``
rows, 8192 lists, pq_dim 64, 8-bit codes; n_probes 64, refine_ratio 40,
bf16 LUT, k 10), its base demoted to a host numpy array, and passes of
every query in batches of 500, wall clock with a synchronise at the end,
``--reps`` rounds in turns: resident, serial, the shipped tiered path (one
scan of the batch, then the reader thread's sub-batches), the same with
``prefetch=False``, and variants — the JAX package's pipeline (a scan a
sub-batch, under the fetch of the sub-batch before), 4 gather threads
(``torch.set_num_threads``) and sub-batches of 250
(``RAFT_TPU_TIERED_BATCH``). Every variant's ids must equal the shipped
path's (the bit-equality contract), but for the JAX package's pipeline,
whose products run at the sub-batch's row count: its differing ids are
counted. One JSON line a measurement.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from collections import deque

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def split_check(torch):
    """Elements that differ between a 10,000-row product and its pieces."""
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    out = {}
    a = torch.randn(10_000, 96, device=dev, generator=g) * 10
    for n in (96, 8192):
        b = torch.randn(n, 96, device=dev, generator=g)
        full = a @ b.T
        for m in (32, 63, 125, 250, 500, 2500):
            parts = torch.cat([a[i:i + m] @ b.T
                               for i in range(0, a.shape[0], m)])
            out[f"[m,96]x[96,{n}] m={m}"] = int((parts != full).sum())
    q = torch.randn(1000, 96, device=dev, generator=g)
    rows = torch.randn(1000, 400, 96, device=dev, generator=g)
    full = torch.einsum("md,mcd->mc", q, rows)
    for m in (32, 63, 125, 250, 500):
        parts = torch.cat([torch.einsum("md,mcd->mc", q[i:i + m],
                                        rows[i:i + m])
                           for i in range(0, 1000, m)])
        out[f"[m,1,96]x[m,96,400] m={m}"] = int((parts != full).sum())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_tiered_variants: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import ivf_pq, tiered
    from raft_tpu_torch.neighbors import refine as trefine
    from raft_tpu_torch.ops import build as kbuild
    from raft_tpu_torch.serve import placement
    from raft_tpu_torch.utils import precision

    precision.enforce()
    card = torch.cuda.get_device_name(0)
    print(json.dumps({"card": card, "split_check": split_check(torch)}),
          flush=True)
    kbuild.build_all()
    ds = DeviceSynthetic(args.n, 96, n_centers=10_000, seed=7)
    base = ds.base()
    queries = ds.queries(args.queries)
    index = ivf_pq.build(base, ivf_pq.IndexParams(
        n_lists=8192, pq_dim=64, pq_bits=8, cache_reconstruction="never",
        seed=7))
    host = placement.to_host(base)
    sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                             refine="f32_regen", refine_ratio=40,
                             lut_dtype="bfloat16")
    scan = dataclasses.replace(sp, refine="none")
    B, k, k_cand = 500, 10, 400

    def sub_batch_scans(q):
        """The JAX package's pipeline: a scan a sub-batch, each sub-batch
        re-ranked after the next one's scan was launched."""
        m = q.shape[0]
        mb = tiered.pipeline_batch(m)
        pf = tiered.RowPrefetcher(tiered.host_row_reader(host))
        in_flight, outs = deque(), []

        def consume():
            q_i, ids_i = in_flight.popleft()
            outs.append(trefine.refine_landed(pf.get().ready(), q_i, ids_i,
                                              k, metric=index.metric))
        try:
            for a in range(0, m, mb):
                q_i = q[a:a + mb]
                _, ids_i = ivf_pq.search(index, q_i, k_cand, scan)
                pf.submit(tiered.stage_ids(ids_i))
                in_flight.append((q_i, ids_i))
                if len(in_flight) > 1:
                    consume()
            while in_flight:
                consume()
        finally:
            pf.close()
        return torch.cat([o[1] for o in outs])

    def tiered_call(q, prefetch=True):
        return tiered.search_refined_tiered(
            ivf_pq.search, index, q, k, k_cand, scan, None, host,
            index.metric, prefetch=prefetch)[1]

    def search_call(params, dataset):
        return lambda q: ivf_pq.search(index, q, k, params,
                                       dataset=dataset)[1]

    threads = torch.get_num_threads()

    def setup(threads_=threads, batch=None):
        torch.set_num_threads(threads_)
        if batch is None:
            os.environ.pop("RAFT_TPU_TIERED_BATCH", None)
        else:
            os.environ["RAFT_TPU_TIERED_BATCH"] = str(batch)

    variants = {
        "resident": (search_call(sp, base), {}),
        "serial": (search_call(dataclasses.replace(
            sp, refine_transfer="serial"), host), {}),
        "tiered": (tiered_call, {}),
        "prefetch_false": (lambda q: tiered_call(q, prefetch=False), {}),
        "sub_batch_scans": (sub_batch_scans, {}),
        "threads_4": (tiered_call, {"threads_": 4}),
        "sub_batch_250": (tiered_call, {"batch": 250}),
    }
    ref = None
    for rep in range(args.reps):
        for name, (fn, kw) in variants.items():
            setup(**kw)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ids = torch.cat([fn(queries[a:a + B])
                                 for a in range(0, args.queries, B)])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            finally:
                setup()
            ids = ids.cpu()
            if name == "tiered" and ref is None:
                ref = ids
            same = None if ref is None or name == "resident" else bool(
                torch.equal(ids, ref))
            line = {"rep": rep, "variant": name, "qps": args.queries / secs,
                    "ids_equal_tiered": same}
            if name == "sub_batch_scans":
                line["ids_differing"] = int((ids != ref).sum())
                same = None
            print(json.dumps(line), flush=True)
            if same is False:
                print(f"torch_tiered_variants: {name} differs from the "
                      "tiered path", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
