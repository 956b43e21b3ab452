#!/usr/bin/env python3
"""Time one of this tree's kernels against the one of another checkout,
in turns, on one card.

    python3 tests/torch_kernel_ab.py --other DIR
        [--kernel select_k|ring_topk_merge|ivfpq_lut_scan] [--rounds R]
        [--n ROWS] [--seed S]

DIR is the root of another checkout of the repo, for example a parent
commit unpacked with ``git archive``. Its source of the kernel
(``raft_tpu_torch/ops/csrc/<source>.cu``) is built with this tree's
``nvcc`` flags into ``raft_tpu_torch/_build/ab/``; this tree's is built
as usual. Each round times this tree's kernel (``this``) and the other's
(``other``) in the order this, other, other, this, each a mean of
``reps`` calls with CUDA events, and prints one JSON line per timing;
a summary line says whether the two kernels' outputs are bit-identical.
Needs a card and ``nvcc``.

- ``select_k`` and ``ring_topk_merge``: each side runs behind its own
  checkout's wrapper (``ops/kernels.py``, loaded from DIR for ``other``),
  since the C entry points differ between versions. Shapes are those of
  ``chip_smoke.py``'s rows: select_k at [500, 8192] k 64 (IVF-PQ coarse
  probes: 500 queries against 8192 centers of ``DeviceSynthetic`` 96-d
  rows), [320,000, 256] k 10 (IVF-Flat bin rows: 256 bins of squared
  distances, 30 % of them +inf) and [128, 20] k 10 (the sharded ring's
  incoming ++ local cut); ring_topk_merge over 4 ranks on one card of
  [500, 10] sorted tables with int32 ids, k 10.
- ``ivfpq_lut_scan`` (the default): both libraries run behind this
  tree's wrapper (their C interface is the same), at the IVF-PQ phase's
  shapes: ``DeviceSynthetic`` ``--n`` x 96, ``ivf_pq.build`` with 8192
  lists, pq_dim 64, 8-bit codes, and the first batch of 500 queries at
  n_probes 64 with a bf16 LUT: the kernel alone on the batch's segment
  table, and a whole refined search of the batch (``refine="f32_regen"``,
  refine_ratio 40).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SOURCES = {"select_k": "select_k", "ring_topk_merge": "ring_topk",
           "ivfpq_lut_scan": "ivfpq_lut_scan"}


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build_other(other_root: str, source: str) -> ctypes.CDLL:
    """The other checkout's ``source`` library, declared by the other
    checkout's own ``ops/build.py``."""
    from raft_tpu_torch.ops import build

    ops = os.path.join(other_root, "raft_tpu_torch", "ops")
    out_dir = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{source}-other.so")
    cmd = [build._find_nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-o", out,
           os.path.join(ops, "csrc", f"{source}.cu")]
    subprocess.run(cmd, check=True)
    other_build = _load_module(os.path.join(ops, "build.py"), "ab_other_build")
    return other_build._declare(source, ctypes.CDLL(out))


def _timed(fn, reps: int) -> float:
    import torch

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


def _same(a, b) -> bool:
    """Outputs bit for bit: tensors, or (nested) lists and tuples of them."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.shape == b.shape and torch.equal(a, b)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def _wrapper_cases(kernel: str, seed: int):
    """(name, call(kernels_module), reps) at chip_smoke.py's shapes."""
    import torch

    from raft_tpu_torch.bench.dataset import DeviceSynthetic

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    if kernel == "ring_topk_merge":
        vals = [torch.rand((500, 10), generator=g, device="cuda").sort(1)[0]
                for _ in range(4)]
        ids = [torch.randint(0, 20_000_000, (500, 10), generator=g,
                             device="cuda", dtype=torch.int32)
               for _ in range(4)]
        return [("4 ranks x [500,10], k 10",
                 lambda K: K.ring_topk_merge(vals, ids, 10), 100)]
    ds = DeviceSynthetic(100_000, 96, n_centers=10_000, seed=seed, std=0.5,
                         scale=10.0)
    q = ds.queries(500)
    c = ds.base()[:8192]
    coarse = ((q * q).sum(1)[:, None] + (c * c).sum(1)[None, :]
              - 2.0 * (q @ c.T)).contiguous()
    bins = torch.rand((320_000, 256), generator=g, device="cuda") * 2000.0
    bins[torch.rand((320_000, 256), generator=g, device="cuda") < 0.3] = (
        float("inf"))
    cut = torch.cat([torch.rand((128, 10), generator=g, device="cuda")
                     .sort(1)[0] for _ in range(2)], 1).contiguous()
    return [("[500,8192] k 64", lambda K: K.select_k_cuda(coarse, 64), 50),
            ("[320000,256] k 10", lambda K: K.select_k_cuda(bins, 10), 20),
            ("[128,20] k 10", lambda K: K.select_k_cuda(cut, 10), 200)]


def _ab_wrapper(args, card: str) -> None:
    from raft_tpu_torch.ops import kernels as this_k

    source = SOURCES[args.kernel]
    other_lib = _build_other(args.other, source)
    other_k = _load_module(os.path.join(args.other, "raft_tpu_torch", "ops",
                                        "kernels.py"), "ab_other_kernels")
    other_k._lib = lambda name: other_lib
    mods = {"this": this_k, "other": other_k}
    cases = _wrapper_cases(args.kernel, args.seed)
    same = {name: _same(call(this_k), call(other_k))
            for name, call, _ in cases}
    for rnd in range(args.rounds):
        for which in ("this", "other", "other", "this"):
            for name, call, reps in cases:
                ms = _timed(lambda: call(mods[which]), reps)
                print(json.dumps({"kernel": args.kernel, "round": rnd,
                                  "library": which, "shape": name,
                                  "ms": ms}), flush=True)
    print(json.dumps({"card": card, "kernel": args.kernel,
                      "outputs_identical": same}), flush=True)


def _ab_lut_scan(args, card: str) -> None:
    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import ivf_common, ivf_pq
    from raft_tpu_torch.ops import build
    from raft_tpu_torch.ops import kernels as K

    libs = {"this": build.LIBRARIES.get("ivfpq_lut_scan"),
            "other": _build_other(args.other, "ivfpq_lut_scan")}
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

    outs = {}
    for which in ("this", "other"):
        use(which)
        outs[which] = (K.ivfpq_lut_scan_topk(*scan_args, **scan_kw),
                       ivf_pq.search(index, q0, 10, sp, dataset=base))
    for rnd in range(args.rounds):
        for which in ("this", "other", "other", "this"):
            use(which)
            scan_ms = _timed(lambda: K.ivfpq_lut_scan_topk(*scan_args,
                                                           **scan_kw), 20)
            search_ms = _timed(lambda: ivf_pq.search(index, q0, 10, sp,
                                                     dataset=base), 20)
            print(json.dumps({"kernel": "ivfpq_lut_scan", "round": rnd,
                              "library": which, "scan_ms": scan_ms,
                              "search_batch_ms": search_ms}), flush=True)
    use("this")
    print(json.dumps({"card": card, "kernel": "ivfpq_lut_scan", "n": args.n,
                      "n_seg": n_seg, "max_list_size": index.max_list_size,
                      "scan_outputs_identical": _same(outs["this"][0],
                                                      outs["other"][0]),
                      "search_outputs_identical": _same(outs["this"][1],
                                                        outs["other"][1])}),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--kernel", choices=sorted(SOURCES),
                    default="ivfpq_lut_scan")
    ap.add_argument("--n", type=int, default=10_000_000,
                    help="rows of the ivfpq_lut_scan comparison")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    if args.kernel == "ivfpq_lut_scan":
        _ab_lut_scan(args, card)
    else:
        _ab_wrapper(args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
