#!/usr/bin/env python3
"""Time this tree's IVF-PQ LUT scan kernel against the one of another
checkout, in turns, on one card.

    python3 tests/torch_kernel_ab.py --other DIR [--n ROWS] [--rounds R]

DIR is the root of another checkout of the repo, for example a parent
commit unpacked with ``git archive``. Its ``raft_tpu_torch/ops/csrc/
ivfpq_lut_scan.cu`` is built with this tree's ``nvcc`` flags into
``raft_tpu_torch/_build/ab/``; this tree's is built as usual. Both
libraries run behind this tree's wrapper on the same inputs, at the
shapes of ``chip_smoke.py``'s IVF-PQ phase: ``DeviceSynthetic`` 10M x 96,
``ivf_pq.build`` with 8192 lists, pq_dim 64, 8-bit codes, and the first
batch of 500 queries at n_probes 64 with a bf16 LUT. Each round times,
for this tree's library (``this``) and the other's (``other``) in the
order this, other, other, this: the kernel alone on the batch's segment
table (mean of 20 calls), and a whole refined search of the batch
(``refine="f32_regen"``, refine_ratio 40; mean of 20 calls), with CUDA
events. Prints one JSON line per timing, then a summary line that says
whether the two libraries' outputs are bit-identical. Needs a card and
``nvcc``; nothing else of the repo runs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _build_other(other_root: str) -> ctypes.CDLL:
    from raft_tpu_torch.ops import build

    src = os.path.join(other_root, "raft_tpu_torch", "ops", "csrc",
                       "ivfpq_lut_scan.cu")
    out_dir = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "ivfpq_lut_scan-other.so")
    cmd = [build._find_nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-o", out, src]
    subprocess.run(cmd, check=True)
    return build._declare("ivfpq_lut_scan", ctypes.CDLL(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import torch

    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import ivf_common, ivf_pq
    from raft_tpu_torch.ops import build
    from raft_tpu_torch.ops import kernels as K

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    libs = {"this": build.LIBRARIES.get("ivfpq_lut_scan"),
            "other": _build_other(args.other)}

    ds = DeviceSynthetic(args.n, 96, n_centers=10_000, seed=args.seed,
                         std=0.5, scale=10.0)
    base = ds.base()
    q0 = ds.queries(500)
    index = ivf_pq.build(base, ivf_pq.IndexParams(
        n_lists=8192, pq_dim=64, pq_bits=8, cache_reconstruction="never",
        seed=args.seed))
    sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                             refine="f32_regen", refine_ratio=40,
                             lut_dtype="bfloat16")
    _, probes = ivf_pq._coarse_probes(index, q0, 64, False)
    seg = ivf_common.SEGMENT_SIZE
    n_seg = ivf_common.n_segments(q0.shape[0] * 64, index.n_lists, seg)
    seg_list, seg_q, _, _ = ivf_common.segment_probes(probes, index.n_lists,
                                                      seg, n_seg)
    q_rot = (q0 @ index.rotation.T).contiguous()
    scan_args = (seg_list, seg_q, q_rot, index.packed_codes,
                 index.packed_ids, index.packed_norms, index.centers_rot,
                 index.codebooks, "l2")
    scan_kw = dict(pq_bits=index.pq_bits, pq_dim=index.pq_dim,
                   L=index.max_list_size, lut_dtype="bfloat16")

    def use(which):
        build.LIBRARIES._libs["ivfpq_lut_scan"] = libs[which]

    def timed(fn, reps=20):
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

    outs = {}
    for which in ("this", "other"):
        use(which)
        outs[which] = (K.ivfpq_lut_scan_topk(*scan_args, **scan_kw),
                       ivf_pq.search(index, q0, 10, sp, dataset=base))
    same_scan = all(torch.equal(a, b) for a, b in zip(outs["this"][0],
                                                      outs["other"][0]))
    same_search = all(torch.equal(a, b) for a, b in zip(outs["this"][1],
                                                        outs["other"][1]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    for rnd in range(args.rounds):
        for which in ("this", "other", "other", "this"):
            use(which)
            scan_ms = timed(lambda: K.ivfpq_lut_scan_topk(*scan_args,
                                                          **scan_kw))
            search_ms = timed(lambda: ivf_pq.search(index, q0, 10, sp,
                                                    dataset=base))
            print(json.dumps({"round": rnd, "library": which,
                              "scan_ms": scan_ms,
                              "search_batch_ms": search_ms}), flush=True)
    use("this")
    print(json.dumps({"card": card, "n": args.n, "n_seg": n_seg,
                      "max_list_size": index.max_list_size,
                      "scan_outputs_identical": same_scan,
                      "search_outputs_identical": same_search}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
