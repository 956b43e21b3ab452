#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``raft_tpu_torch``) on one card.

    python3 chip_smoke.py [--n ROWS] [--queries M] [--seed S] [--obs-dir DIR]

Phases (any failure exits non-zero; nothing is caught and continued):

1. probe — a CUDA card must be present; prints the card's name and power
   limit as ``nvidia-smi`` reports them, and the host's RAM and CPU count;
2. build — compiles every kernel from ``raft_tpu_torch/ops/csrc`` with
   ``nvcc`` (one process per source, all started together) and prints
   ptxas' registers and spill bytes of each kernel entry;
3. IVF-PQ path — DEEP-10M-shaped synthetic data (10M x 96 f32, 10,000
   centers), ``ivf_pq.build`` with 8192 lists, pq_dim 64, 8-bit codes,
   then refined search of 10,000 queries in batches of 500 (n_probes 64,
   scan_select="pallas", refine="f32_regen", refine_ratio 40, bf16 LUT)
   against the device-resident base; launch counts are zeroed just before
   and read just after, and each of its four kernels must have launched;
   checks: recall@10 against ``brute_force.knn`` on 1,000 queries (also
   with an f32 LUT), and the kernel path's recall on 200 queries against
   the plain path's (the same search on the CPU, where every wrapper runs
   its plain PyTorch version): it may be at most 0.01 lower; then its four
   kernels against their plain versions on the path's inputs
   (fused_l2_argmin bound by its design's three TF32 products, with the
   time of ``torch.matmul`` alone at full fp32 on its row and its fp32
   bound logged; the LUT scan's shared-memory look-up floor logged beside
   its bytes bound; gather_refine_topk timed with the L2 cold, beside
   its warm time, the kernel alone in a CUDA graph and the wrapper's host
   time), and a stage breakdown of one batch; ``[refine bf16]`` (ROADMAP
   A8) before it: the same refined path against the base cast to bf16
   (counts zeroed before and read after: B2 must launch on the 2-byte
   rows), QPS, recall@10 at least 0.95 against the ground truth and,
   against the bf16 rows' own ground truth, within 0.01 of the f32 base's,
   B2 on bf16 rows against its plain version (row ``ivf_pq_bf16``, its
   bound at 2 bytes a value); then ``[filter main]``, the
   path filtered (ROADMAP A6): keep masks drawn as the JAX bench draws
   them (``bench_keep``) at selectivity 0.1 and 0.01, each leg with the
   counts zeroed just before and read just after (B1 and B2 must launch
   with their filter operands every batch), three passes of QPS, recall@10
   against ``brute_force.knn(filter_bitset=)``, no returned id with its
   bit clear, the kernel path within 0.01 of the plain path on 200
   queries; an all-pass bitset must give the unfiltered kernel path's ids
   and distances exactly; and B1 and B2 with their filter operands against
   their plain versions at selectivity 0.1 (rows ``ivf_pq_filter``);
   then ``[tiered]`` (ROADMAP A12): the base demoted to host memory
   (``serve.placement.to_host``), the same queries through the tiered
   prefetch path, the serialized host gather and the pipeline with
   ``prefetch=False`` — equal bit for bit — against the resident path
   (recall@10 at most 0.01 below, ids equal but at f32 ties), a filtered
   tiered pass at selectivity 0.1 with no cleared id, wall-clock QPS of
   each, prefetch hits and stalls, and one batch's stages (the batch's
   scan; a sub-batch's host gather by torch and by numpy, H2D copy, whole
   fetch and landed re-rank), counts zeroed before the tiered pass and
   read after; then ``[resilient]``
   (ROADMAP A11): ``search_resilient`` under the injected plan
   ``RESILIENT_PLAN`` must walk ``RESILIENT_PATH`` (the JAX package's path,
   held by tests/test_torch_robust.py) and equal direct calls with its
   final knobs bit for bit, and under a memory fraction capping the
   allocator below one native search's peak a real
   ``torch.cuda.OutOfMemoryError`` must be classified (no fault fired),
   walked and recovered, equal to uncapped calls with the final knobs;
   then ``[obs …]`` (ROADMAP A13; the build above ran with observability
   on, no sync mode, every search pass before with it off): ``[obs
   spans]`` ten refined batches under sync-mode recording spans, each
   span's count, median and p99 (the children's sum within the root's
   within the wall time; the root's median within 25 % of ``[stages]``'s
   ``search_total``); ``[obs hbm]`` the ``hbm.*`` gauges equal to
   ``torch.cuda.memory_stats()`` and ``bytes_limit`` following a memory
   fraction; ``[obs index]`` ``describe_index`` of the index (list skew,
   drift over 256 lists, PQ error on 2,048 rows) and the build's
   ``index.*{index=ivf_pq.build}`` gauges; ``[obs timeline]`` the event
   ring exported as a Chrome trace and loaded back with every span name,
   a flight dump with metrics, events and the fleet stamp, and
   ``ExpoServer``'s ``/metrics`` parsed back to the registry's series;
   ``[obs prof]`` 20 warm refined batches under ``obs.prof.capture``
   (``torch.profiler``), the device time of the top 10 kernels by name
   and the device idle share of the window, B1–B3 named in it and B4 in
   one ``fused_l2_argmin`` call after them in the same capture; ``[obs off]`` the cost of
   a disabled span (32 of them under 2 % of a batch) and a refined batch
   under ``sanitize.no_host_transfers()`` (any host sync is logged with
   its line, and fails the leg); ``--obs-dir DIR`` keeps the leg's files;
   then ``[serve …]`` (ROADMAP A14): the serving plane over the same index
   and parameters (``SERVE_CONFIG``: buckets 1…512, queue 8192, linger 2
   ms, SLO 100 ms), answering single-query requests, observability on
   (no sync, no hbm sampling): ``[serve warm]`` warmup seconds by bucket
   and each bucket's first served batch after warmup against its warm
   median (fails past 5 × and 2 ms over it); ``[serve parity]`` 500
   single-query submits equal to direct searches of one query but at f32
   ties, distances within 1e-5 relative; ``[serve load]`` an open-loop
   sweep at ``SERVE_STEPS`` for 3 s a step over the 10,000 queries with
   their exact ground truth (launch counts zeroed before and read after:
   B1–B3 must launch; every request a result or a typed error, no error,
   recall@10 ≥ 0.95; the highest step with p99 under the SLO); ``[serve
   prof]`` the 20,000/s step under ``obs.prof.capture``: the idle share
   and the top kernels, B1–B3 named; ``[serve expo]`` ``/metrics``,
   ``/healthz``, ``/indexz``, ``/costz`` fetched and parsed during the
   sweep, the cost ledger's conservation within 1e-6, the flight dump's
   ``serve_registry``, ``quality`` and ``cost`` sections; ``[serve
   quality]`` the shadow verifier's exact host replays and their Wilson
   interval (fails only if its upper bound is under 0.95); ``[serve
   chaos]`` an injected OOM in the served search walks the ladder (rows
   equal direct calls with the final knobs, tenant ``degraded``), a stall
   past the SLO sheds by deadline, ``stop(drain=False)`` sheds the queue
   as draining, no future unresolved; ``[serve tiers]`` a registry whose
   budget holds one tenant and the other's codes: admitting a second
   tenant demotes the first's raw vectors (counter, ``index.bytes``
   gauges, ``memory_allocated`` falling by the base), its served rows
   equal the resident answers but at ties, then the reader thread against
   the inline fetch (``prefetch=False``) at ``SERVE_AB_QPS``, in turns;
   ``[serve router]`` two pods sharing the card, the tenant replicated,
   ``SERVE_STORM`` single-query requests from 4 threads with pod b killed
   at a hop: every request answered by pod a (equal to direct searches
   but at ties) or shed typed, the ``serve.router.*`` counters matching;
3b. the same path at its target scale, ``[chunked]`` — DEEP-100M-shaped
   ``DeviceSyntheticChunks`` (100M x 96, 10,000 centers, 1M-row blocks,
   never materialized): ``ivf_pq.build_chunked`` with
   ``tools/build_deep100m.py``'s parameters (8192 lists, pq_dim 64, 8-bit,
   spill, 10 k-means iterations) but the list cap, 4 x the mean load
   (``--chunked-cap`` only reproduces the tool's 1.5), its seconds by
   stage and the generator's rate; an unrefined scan of the queries at
   k_cand 400 (n_probes 64, bf16 LUT, batch 500) in three passes, then the exact re-rank of 1,000
   of them by ``refine_provider``; counts zeroed before the build and read
   after the re-rank (fused_l2_argmin, select_k and the LUT scan must have
   launched); checks: every row indexed once or counted as dropped,
   recall@10 >= 0.95 against ``compute_groundtruth``'s streamed ground
   truth; then those three kernels against their plain versions at the
   path's shapes, and a 4M-row checkpointed build stopped by an injected
   ``build.chunk_encode`` error, resumed, and held bit for bit to a
   completion from the same trained quantizers;
4. IVF-Flat path — the 1M x 128 ``make_synthetic_hard`` set of the repo's
   hard_config bench (``FLAT_N`` rows, not cut), ``ivf_flat.build`` with
   1024 lists, spill, cap factor 1.5; searches of 10,000 queries (k 10)
   with scan_select="approx" at n_probes 16/32/64/128 and "exact" at 32
   (twice),
   and batch-10 and batch-1 legs at 32, with counts zeroed before the build
   and read after the last search (fused_l2_argmin, select_k and both scan
   kernels must have launched); checks: recall@10 of every leg against
   exact search, the exact grouped tier against the per_query tier, approx
   recall not falling with n_probes, and kernel path against plain path on
   200 queries; then the path's four kernels against their plain versions
   at its own shapes (both scans on the first batch's segment table,
   select_k on that batch's bin rows, fused_l2_argmin at the build's
   final k-means sweep), select_k against the stable sort at the path's
   other short-row shapes, and a stage breakdown of one approx batch;
   ``[flat filter]`` at selectivity 0.1: the exact leg at 32 (the grouped
   scan over the id table with the cleared ids at −1; it must launch) and
   the approx leg at 32 (the plain grouped tier: the segmented scan
   declines filtered searches, as in the JAX package, and must not
   launch), checked against the filtered ground truth, the filtered
   per_query tier (within 0.002) and the plain path (exact, within 0.01);
   ``[flat resilient]``: IVF-Flat ``search_resilient`` of 500 queries under
   two injected RESOURCE_EXHAUSTED, equal to direct calls with its final
   knobs;
   then the IVF-PQ recon leg on the same data, queries and ground truth:
   the repo's bench config ``ivf_pq.n1024.d64`` (bench.py:211-243; 1024
   lists, pq_dim 64, spill, cap factor 1.5, the default
   ``cache_reconstruction``, whose rule builds the bf16 cache), refined
   (refine_ratio 4) approx search over the cache at n_probes 64 and 128,
   batch-10 and batch-1 legs at 64, a refined exact leg at 64, and a twin
   built with ``"never"`` whose exact leg at 32 runs the plain grouped
   tier; counts zeroed before the build and read after the twin's leg
   (the same four kernels must have launched); checks: recall@10 of every
   leg, approx recall not falling from 64 to 128, the exact leg within
   0.01 of approx at 64, the kernel path no more than 0.01 below the plain
   path on 200 queries; ``[pq filter]``: the config's filter legs, approx
   at 64 with refine_ratio 4 at selectivity 0.01, 0.1 and 0.5 (the
   segmented scan over the masked id table must launch, then the gather
   re-rank with the filter), each against its filtered ground truth, no
   id with its bit clear, and at 0.1 the plain path; then both scans
   against their plain versions on
   the n_probes 64 segment table over the bf16 cache (bounds: two TF32
   products, 2-byte rows), and a stage breakdown of one approx batch;
   ``[pq per_cluster]`` (ROADMAP A9, ``pq_per_cluster_leg``): the same
   config with ``codebook_kind="per_cluster"``, its build by stage with
   ``_train_per_cluster`` timed alone, refined approx at 64 and 128, exact
   at 64 and ``scan_select="pallas"`` at 64 (the LUT-scan kernel declines
   it: the fallback counter, no B1 launch), recall beside the
   per_subspace index's and its rules, and 100 queries on the card equal
   to the CPU's but at f64 ties;
   ``[flat uint8]`` (ROADMAP A19, ``flat_uint8_leg``, inside the IVF-Flat
   phase): the 1M x 128 set cast to uint8 by one affine map, ``ivf_flat.
   n1024`` on the bytes: approx at 16–128 and exact at 32 over uint8
   lists, a filtered exact leg at selectivity 0.1, the f32 cell's recall
   rules against exact search on the bytes, B5 and B6 against their plain
   versions (rows ``ivf_flat_uint8``), the index's bytes beside the f32
   index's;
5. sharded path — BASELINE.md target 5's shape cut to one card: 20M x 128
   ``DeviceSynthetic`` rows (``SHARD_N``) on a 4-rank mesh whose ranks share
   cuda:0, ``parallel.build_ivf_pq`` (8192 lists, pq_dim 64, 8-bit codes,
   distributed Lloyd); counts zeroed before the build and read after leg 3
   (all six kernels of the path must have launched): leg 1 ``sharded_knn``
   of 1,000 queries with both merge tiers against single-rank
   ``brute_force.knn``; leg 2 refined search of 10,000 queries in batches of
   500 on the ring merge (QPS over three warm passes, recall@10 ≥ 0.95, the
   allgather tier giving the same ids); leg 3 the fused scan-in-ring tier at
   batch 32 against the unfused ring search (per-call latency, ids equal
   away from key ties); the kernel path's recall on 200 queries within 0.01
   of the plain path's (the same sharded search on CPU ranks); leg 4 the
   comms byte model of one batch (ring ≤ half the allgather's); then the
   ring kernels and B1–B4 against their plain versions at the path's
   shapes; ``[shard filter]`` at selectivity 0.1 over the global row ids:
   a refined batch of 500 (each rank's LUT scan with its keep bytes; the
   ring and allgather tiers equal but at ties) and the fused scan-in-ring
   tier at batch 32 with each rank's keep bytes against the filtered
   allgather tier (equal except at f32 ties, checked in f64), counts
   zeroed before and read after, and B8 with its filter operand against
   its plain version (row ``sharded_filter``); ``[shard hier]``: the same
   four ranks as a (dcn, ici) = (2, 2) mesh (``hier_mesh``), counts zeroed
   before and read after: ``sharded_knn`` and a refined batch of 500 with
   ``merge="hier"`` equal to the allgather tier (values bit for bit, ids
   but at f32 ties, checked in f64), the hier
   tier taken once a call, B7 launched once a pod, the dcn bytes equal to
   the survivor model, and B7 over a pod's two ranks against its plain
   version (row ``sharded_hier``). The ranks share cuda:0 whatever the
   card count: the ring kernels over ranks on several cards are not
   ported yet;
   after the IVF-Flat phase, ``[shard flat]``: sharded IVF-Flat on its
   1M x 128 set over the 4 ranks (``shard_flat_leg``: both builds, QPS and
   recall at batch 10,000, the ring tier against the allgather, the
   exhaustive search against brute force, the flat sha under the
   determinism mode);
5b. ``[cagra]`` (ROADMAP A16; BASELINE.md target 4, GIST-1M's shape):
   ``CAGRA_N`` x ``CAGRA_DIM`` ``DeviceSynthetic`` rows, 1,000 queries,
   ``cagra.build`` with graph_degree 64 (the cluster algorithm over the
   auto 128-d projection), searches at itopk 64, width 8, 6 iterations:
   f32, int8 traversal, filtered at selectivity 0.1, each with QPS at batch
   1,000, latency at batch 10 and recall@10; counts zeroed before the build
   and read after the f32 passes (fused_l2_argmin must launch); the graph's
   invariants, the card's search equal to the CPU's on 100 queries but at
   f64 ties or where its traversal parts from the CPU's at a rounding tie
   (``cagra_card_vs_cpu``), the nn_descent refusal, B4 at the build's predict shape (row
   ``cagra_build``), then the ivf_pq build algorithm on ``CAGRA_PQ_N`` rows
   with counts zeroed before its build (fused_l2_argmin and select_k must
   launch; rows ``cagra_ivf_pq``: B4 at its label pass's shape, B3 at its
   coarse select's) (``cagra_leg``); ``[cagra nn_descent]`` before the rows
   are freed: ``build_algo="nn_descent"`` on the same rows (20 sweeps),
   its stages, peak, invariants, edge recall, QPS and recall@10, and
   NN-Descent on 20,000 x 16 small-integer rows on the card equal to the
   CPU's bit for bit (``cagra_nn_descent_leg``); ``[gist flat]`` (ROADMAP
   A10, ``gist_flat_leg``) on the same rows: ``gist.ivf_flat.n1024``,
   whose 8.87 GB pack takes ``pack_rows_chunked`` (counter), equal bit for
   bit to the one-shot ``pack_lists`` of its labels, each pack's peak,
   every row once or dropped, approx at 32 and 64 and exact at 32, B5 and
   B6 at d 960 (rows ``gist_flat``);
5c. ``[ball_cover]`` (ROADMAP A16): 1M x 3 ``DeviceSynthetic`` rows and the
   same rows on the unit sphere for haversine, ``ball_cover.build`` with
   1,000 landmarks and three passes of ``knn`` (k 10, 32 lists a round;
   select_k must launch), checked against the general brute force, the
   CPU's search and f64 thresholding of ``eps_nn``; select_k at one probe
   round's merge shape (row ``ball_cover``); then ``[eps]``:
   ``eps_neighbors_l2sq`` of 2,000 rows against the 1M, mean degree 20-50,
   against the CPU (``ball_cover_leg``);
6. ``[dist build]``: the SIFT-1B-shaped distributed build of
   ``DIST_RANK_CHUNKS`` x 2^20 rows a rank on the 4 ranks
   (``dist_build_phase``: ``ivf_pq.build_distributed`` and
   ``build_chunked`` of one provider held by ``index_sha16`` under
   ``torch.use_deterministic_algorithms``, every row once or dropped, the
   build's comms allgatherv only, the per-shard output searched refined
   against the streamed ground truth and by the fused tier, B4 at the
   label pass's chunk against its plain version (row ``dist_build``), and
   ``[dist resume]``: a build stopped at rank 2's second encode chunk,
   resumed to the sha of the uninterrupted build, made with prefetch on
   and again off); ``CUBLAS_WORKSPACE_CONFIG`` is set for that mode's
   blocks only (``deterministic``);
5d. ``[kmeans]`` (ROADMAP A5, ``kmeans_leg``): SIFT-1M's shape (1M x 128
   ``DeviceSynthetic`` rows around 1,000 centers): ``kmeans.fit`` with
   k-means++ (25 sweeps; init and Lloyd timed by their sync-mode spans),
   with ``init="random"``, and ``fit_minibatch`` (batch 65,536, 100
   steps), counts zeroed before and read after (B4 must launch); checks
   as the function says, B4's row ``kmeans`` at [1M, 128] x [1000, 128];
   ``find_k`` on 12 well-separated centers; then ``[bf index]`` (A3, A4,
   ``bf_index_leg``) on the same rows: ``brute_force.build`` and
   ``knn(index, …)`` of 10,000 queries (impl auto and sort, equal to
   ``knn_arrays`` bit for bit, QPS), a filter at selectivity 0.1,
   ``merge_parts`` of 8 parts, B3's row ``bf_index`` at the tile's shape;
   after the sharded phase, ``[shard axis]`` (A15 on one card,
   ``shard_axis_leg``): IVF-PQ over one axis of a 2 x 2 mesh, refined
   search and ``sharded_knn`` under allgather and ring (``ring_ppermute``:
   no B7), bit for bit the same shards' answer on a 1-D mesh, every
   replica group equal; ``[tristates]`` (A1, ``tristates_leg``, after
   ``[serve]``): ``RAFT_TPU_PALLAS_LUTSCAN`` and ``_REFINE`` off on the
   main index, ``_GROUPED`` off on the IVF-Flat index (in ``flat_phase``),
   each leaving its kernel's counter at 0 and its recall no more than
   0.005 below the default's, and ``RAFT_TPU_FP8_LUT``'s auto/off;
5e. ``[prims …]`` (ROADMAP A17's first half, ``prims_leg``, after
   ``[bf index]``): a clustering job and an embedding evaluated as cuML
   does at SIFT-1M's shape — ``random.make_blobs`` of 1M x 128 rows
   around 1,000 centers (card = CPU on 100,000 rows), ``kmeans.fit``
   (random init, 10 sweeps; B4 must launch) scored by the contingency
   metrics (card = CPU, = float64 from the counts), ``linalg`` and
   ``stats`` on the rows (cov, eig, rsvd, qr, lstsq, the rank-1 Cholesky
   update, multi-variable gaussians, reduce by key, histogram, each
   against float64 or numpy), silhouette and trustworthiness (against
   float64 and the CPU), and ``label.connected_components`` of a kNN
   graph (B3 must launch) and an RMAT graph against scipy's, with
   ``merge_labels`` of two halves; B3's row ``prims`` at the kNN tile;
7. the run's wall time, the card's line, the kernel JSON line, then
   ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

# The kernels each path must launch.
PQ_KERNELS = ("fused_l2_argmin", "select_k", "ivfpq_lut_scan_topk",
              "gather_refine_topk")
FLAT_KERNELS = ("fused_l2_argmin", "select_k", "segmented_scan_topk",
                "grouped_scan_topk")
# Rows of the IVF-Flat phase: the bench's own size (bench.py:585).
FLAT_N = 1_000_000
# The sharded phase: BASELINE.md target 5's shape (SIFT-shaped 128-d rows,
# n_lists 8192, pq_dim 64, 8-bit codes) cut to one card: 20M rows on a
# 4-rank mesh, 5M a rank.
SHARD_N = 20_000_000
SHARD_DIM = 128
SHARD_RANKS = 4
SHARD_KERNELS = PQ_KERNELS + ("ring_topk_merge", "ring_lut_scan_merge")
# The [chunked] phase: the DEEP-100M shape (BASELINE.md target 3), built
# by ivf_pq.build_chunked; its resume check at a smaller row count.
CHUNKED_N = 100_000_000
CHUNKED_DIM = 96
CHUNKED_RESUME_N = 4_000_000
# The [dist build] phase: BASELINE.md target 5's SIFT-1B over 64 chips is
# 15.6M rows a chip; here 10 chunks of 2^20 rows a rank on the sharded
# phase's 4 ranks (41,943,040 rows): at 15 chunks a rank the shards' lists,
# padded to the fattest list of any shard (18,816 slots), took 44.4 GB,
# which with the 32.2 GB re-rank base does not fit the card. Its resume
# check at 2 chunks a rank (cut from 4 for the run's time limit): the fault
# still stops the build midway, at rank 2's last chunk, rank 3 not begun.
DIST_RANK_CHUNKS = 10
DIST_RESUME_RANK_CHUNKS = 2
# The [cagra] leg: BASELINE.md target 4 (GIST-1M: 1M x 960, its 1,000 test
# queries, graph_degree 64), the ivf_pq build algorithm on the first
# CAGRA_PQ_N of those rows.
CAGRA_N = 1_000_000
CAGRA_DIM = 960
CAGRA_QUERIES = 1_000
CAGRA_DEGREE = 64
CAGRA_PQ_N = 100_000
CAGRA_KERNELS = ("fused_l2_argmin",)
CAGRA_PQ_KERNELS = ("fused_l2_argmin", "select_k")
# CAGRA's nn_descent build and its small exactness check (card = CPU bit
# for bit on small-integer rows).
CAGRA_NND_EXACT_N = 20_000
# The [ball_cover] leg: exact kNN over a point cloud of 1M three-dimensional
# rows, and the same rows on the unit sphere as (lat, lon) radians for
# haversine; L landmarks, ROUND_LISTS lists a probe round; then [eps]:
# EPS_ROWS of those rows against all of them.
BALL_N = 1_000_000
BALL_QUERIES = 1_000
BALL_LANDMARKS = 1_000
BALL_ROUND_LISTS = 32
BALL_KERNELS = ("select_k",)
EPS_ROWS = 2_000

# The [resilient] leg's injected plan, and the rungs its walk must take
# from the main path's knobs (bf16 LUT, refined against the resident
# base): the path the JAX package's ladder takes for the same plan and
# knobs (tests/test_torch_robust.py holds both packages to it on the CPU).
RESILIENT_PLAN = {"faults": [{"site": "ivf_pq.search", "kind": "oom",
                              "times": 3}]}
RESILIENT_PATH = ["halve_batch", "fp8_lut", "demote_raw"]

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 non-tensor rate,
# dense TF32 tensor-core rate; 132 SMs, each reading 32 shared-memory words
# a clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
N_SMS = 132
SMEM_WORDS_PER_CLOCK = 32


def _log(msg: str) -> None:
    print(msg, flush=True)


def _timed(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs after one warm-up (CUDA
    events around the whole run)."""
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


def _timed_cold(fn, reps: int, flush_mb: int = 256) -> float:
    """Mean ms of ``fn()`` with the L2 cold: a ``flush_mb`` MB buffer (over
    five times the 50 MB L2) is read before each call, and CUDA events
    bracket the call alone, so the buffer's own time is not in it (the
    host enqueues the call while the card reads the buffer). Read, not
    written: written lines would be dirty, and their write-backs would
    fall on the call."""
    import torch

    flush = torch.ones(flush_mb << 18, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / reps


def _graph_ms(fn, reps: int) -> float:
    """Mean ms of the kernels of ``fn()`` alone: ``reps`` calls captured
    in one CUDA graph, so the replay runs the launches without the
    wrapper's Python (warm: back to back on the same inputs)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = _timed(graph.replay, 3) / reps
    del graph
    return ms


def _host_ms(fn, reps: int) -> float:
    """Mean ms of the host's part of ``fn()``: the calls are enqueued
    back to back without a synchronisation (checks, allocations, the
    ctypes call), the card draining them behind."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _timed_best(fn, reps: int, rounds: int = 5) -> float:
    """The least of ``rounds`` means of ``reps`` calls (:func:`_timed`):
    for calls bound by the host, whose means swing with its load. Kernel
    and library call of one row are timed alike."""
    return min(_timed(fn, reps) for _ in range(rounds))


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the builds compared
    by sha, with the cuBLAS workspace setting it requires
    (``CUBLAS_WORKSPACE_CONFIG=:4096:8``, PyTorch's default size on
    Hopper) set for the block only: PyTorch reads the variable at every
    cuBLAS call, which costs the host ~60 µs a product while it is set
    (``tests/torch_lut_host_cost.py --isolated``), and the other legs
    time their searches as a process without it runs them."""
    import torch

    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if saved is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved


def _bound_ms(n_bytes: float, flops: float,
              flop_rate: float = FP32_FLOP_PER_S):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / flop_rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _sm_clock_hz() -> float:
    """The SM clock the card runs at under load, as ``nvidia-smi`` reports
    it (``clocks.max.sm``, MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def bench_keep(n: int, sel: float, k: int):
    """The JAX bench's filter-leg keep mask (raft_tpu/bench/runner.py:
    _filter_leg): a draw seeded by the selectivity keeping a ``sel`` share
    of the n rows, and at least k of them."""
    import numpy as np

    rng = np.random.default_rng(981_000 + int(round(sel, 6) * 1_000_000))
    keep = rng.random(n) < sel
    if keep.sum() < k:
        keep[rng.permutation(n)[:k]] = True
    return keep


def _check_kept(ids, keep, what):
    """No returned id may have its bit clear."""
    import numpy as np

    got = np.asarray(ids)
    got = got[got >= 0]
    if not keep[got].all():
        raise SmokeFailure(f"{what}: {int((~keep[got]).sum())} returned ids "
                           f"have their filter bit clear")
    return int((np.asarray(ids) < 0).sum())


def _recall(found, truth) -> float:
    import numpy as np

    f, t = np.asarray(found), np.asarray(truth)
    k = t.shape[1]
    return float(np.mean([len(set(a[:k]) & set(b)) / k for a, b in zip(f, t)]))


def _row(rows, path, name, src, line, n_launches, err, ms, plain_ms, nbytes,
         flops, lib_ms, shape, flop_rate=FP32_FLOP_PER_S, logged=None,
         floor_ms=None, **extra):
    """One kernel's entry of the JSON line (at one path's shapes, with
    that path's launch count), and its log line. ``flops`` run at
    ``flop_rate``; ``floor_ms``: a further operations bound (shared-memory
    look-ups), which is the bound where it is the larger; ``extra``:
    further numbers measured in this run (a yardstick), in the entry and
    the log line; ``logged``: numbers computed beside the bound (a second
    bound), in the log line only."""
    b_ms, b_by = _bound_ms(nbytes, flops, flop_rate)
    if floor_ms is not None and floor_ms > b_ms:
        b_ms, b_by = floor_ms, "operations"
    rows.append({"name": name, "path": path, "route": "cuda",
                 "source": f"raft_tpu_torch/ops/csrc/{src}",
                 "replaces": f"raft_tpu/ops/pallas_kernels.py:{line}",
                 "launches": n_launches, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms, "shape": shape,
                 **extra})
    more = "".join(f", {k} {v:.3f}" if isinstance(v, float) else f", {k} {v}"
                   for k, v in {**extra, **(logged or {})}.items())
    _log(f"[kernel] {path} {name} {shape}: max|d| {err:.3g}, {ms:.3f} ms "
         f"(plain {plain_ms:.3f} ms, library "
         f"{'-' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
         f"{b_ms:.3f} ms by {b_by}{more})")


class SmokeFailure(Exception):
    """A check of a phase failed; the script exits non-zero."""


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def _check_scan(name, tk, ti, pk, pi, seg_q, q, key_of):
    """Kernel output (tk, ti) against its plain version (pk, pi), both
    [n_seg, S, w]: the (+inf, −1) sentinel on pad slots, the same
    finite/infinite pattern on live slots, keys within 1e-4 + 1e-5·(|key| +
    ‖q‖²) (the expanded l2 form cancels ‖q‖² + ‖x‖²), and picks equal
    except where the f64 key of the kernel's pick (``key_of``) ties the
    plain key within that tolerance. Returns (max |Δkey|, pick agreement)."""
    import torch

    live = seg_q >= 0
    if not bool(torch.isinf(tk[~live]).all() and (ti[~live] == -1).all()):
        raise SmokeFailure(f"{name}: pad slots lack the sentinel")
    fin = torch.isfinite(pk) & live[..., None]
    if not torch.equal(torch.isfinite(tk) & live[..., None], fin):
        raise SmokeFailure(f"{name}: finite/infinite pattern differs")
    qsq = (q * q).sum(1)[seg_q.clamp_min(0).long()]
    tol = 1e-4 + 1e-5 * (pk.abs() + qsq[..., None])
    diff = (tk - pk).abs()[fin]
    if not bool((diff <= tol[fin]).all()):
        raise SmokeFailure(f"{name}: keys differ by {float(diff.max())}")
    bad = torch.nonzero((ti != pi) & fin, as_tuple=True)
    if bad[0].numel():
        k64 = key_of(bad[0], bad[1], ti[bad])
        if not bool(((k64 - pk[bad].double()).abs() <= tol[bad]).all()):
            raise SmokeFailure(f"{name}: picks differ away from key ties")
    agree = float((ti == pi)[fin].float().mean())
    return float(diff.max()), agree


def _argmin_row(rows, path, launches, xa, ya, shape):
    """fused_l2_argmin against its plain version on (xa, ya): distances
    within 1e-4 + 1e-5·(‖x‖² + ‖y‖²) (the expanded form cancels those
    terms), and where the argmins differ the kernel's pick must tie the
    minimum within the same tolerance; then its row."""
    import torch

    from raft_tpu_torch.ops import kernels as K

    d_k, i_k = K.fused_l2_argmin(xa, ya)
    d_p, i_p = K.fused_l2_argmin_plain(xa, ya)
    x_sq = (xa * xa).sum(1)
    y_sq = (ya * ya).sum(1)
    err = float((d_k - d_p).abs().max())
    if not bool(((d_k - d_p).abs()
                 <= 1e-4 + 1e-5 * (x_sq + y_sq[i_p.long()])).all()):
        raise SmokeFailure(f"fused_l2_argmin distances differ by {err}")
    same = i_k == i_p
    bad = ~same
    if bool(bad.any()):
        xb, yb = xa[bad], ya[i_k[bad].long()]
        d_pick = ((xb * xb).sum(1) + (yb * yb).sum(1)
                  - 2.0 * (xb * yb).sum(1)).clamp_min(0.0)
        if not bool(((d_pick - d_p[bad]).abs()
                     <= 1e-4 + 1e-5 * (x_sq[bad] + (yb * yb).sum(1))).all()):
            raise SmokeFailure("fused_l2_argmin picked a non-minimal center")
    m_, dim = xa.shape
    n_ = ya.shape[0]
    del d_k, i_k, d_p, i_p
    torch.cuda.empty_cache()
    flops = 2.0 * m_ * n_ * dim
    # the bound of the design: three TF32 products on the tensor cores;
    # that of one fp32 product on the CUDA cores (PR 1-4's row) is logged
    _row(rows, path, "fused_l2_argmin", "fused_l2_argmin.cu", 112,
         launches["fused_l2_argmin"], err,
         _timed(lambda: K.fused_l2_argmin(xa, ya), 3),
         _timed(lambda: K.fused_l2_argmin_plain(xa, ya), 1),
         (m_ + n_) * dim * 4 + m_ * 8, 3.0 * flops, None,
         f"[{m_},{dim}]x[{n_},{dim}] {shape}argmin agreement "
         f"{float(same.float().mean()):.6f}", flop_rate=TF32_FLOP_PER_S,
         logged=dict(bound_fp32_ms=flops / FP32_FLOP_PER_S * 1e3),
         matmul_fp32_ms=_product_ms(xa, ya))


def _product_ms(xa, ya, chunk: int = 1 << 16) -> float:
    """ms of ``torch.matmul(x, y.T)`` alone at full fp32 (TF32 off) over
    all of x, in row chunks whose [chunk, n] products go to one reused
    buffer: the product-alone yardstick of fused_l2_argmin (no single
    PyTorch call computes the argmin)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    yt = ya.T
    out = torch.empty((min(chunk, xa.shape[0]), ya.shape[0]),
                      dtype=torch.float32, device=xa.device)

    def run():
        for a in range(0, xa.shape[0], chunk):
            xc = xa[a:a + chunk]
            torch.matmul(xc, yt, out=out[:xc.shape[0]])

    ms = _timed(run, 1)
    del out
    torch.cuda.empty_cache()
    return ms


def _select_k_check(scores, k, bias=None):
    """The select_k kernel against its plain version (a stable sort), with
    the bias row where the path passes one: values and positions must be
    equal. Returns (kernel ms, sort ms)."""
    import torch

    from raft_tpu_torch.ops import kernels as K

    v_k, p_k = K.select_k_cuda(scores, k, True, bias)
    v_p, p_p = K.select_k_plain(scores, k, True, bias)
    if not (torch.equal(v_k, v_p) and torch.equal(p_k, p_p)):
        raise SmokeFailure(f"select_k differs from its plain version at "
                           f"{list(scores.shape)} k={k}"
                           + (" with its bias row" if bias is not None
                              else ""))
    return (_timed_best(lambda: K.select_k_cuda(scores, k, True, bias), 100),
            _timed(lambda: K.select_k_plain(scores, k, True, bias), 5))


def _select_k_row(rows, path, launches, scores, k, shape, bias=None):
    """B3's row. With ``bias`` the kernel ranks bias − 2·scores (the coarse
    probe's form); its library call is ``torch.topk`` over those keys
    formed beforehand, and the kernel's time over the formed keys without
    the bias row stands beside it (``keys_formed_ms``)."""
    import torch

    from raft_tpu_torch.ops import kernels as K

    ms, plain_ms = _select_k_check(scores, k, bias)
    keys = (scores if bias is None
            else torch.sub(bias.reshape(1, -1), scores, alpha=2.0))
    extra = ({} if bias is None else dict(keys_formed_ms=_timed_best(
        lambda: K.select_k_cuda(keys, k), 100)))
    _row(rows, path, "select_k", "select_k.cu", 1317, launches["select_k"],
         0.0, ms, plain_ms,
         scores.numel() * 4 + scores.shape[0] * k * 8
         + (0 if bias is None else bias.numel() * 4), 0.0,
         _timed_best(lambda: torch.topk(keys, k, largest=False), 100),
         f"[{scores.shape[0]},{scores.shape[1]}] k={k}"
         + (" with bias row" if bias is not None else "") + shape, **extra)


def _lut_scan_row(rows, path, launches, index, q0, n_probes, lut_dtype,
                  shape="", filter_bits=None, plain_reps=2):
    """ivfpq_lut_scan_topk against its plain version on the segment table
    of ``q0``'s coarse probes over ``index``: the [B, n_probes, 256] pair
    rows with the same filled bins, keys within 1e-3 + 1e-5·(|key| +
    ‖q‖²), ids agreeing on 99.9 % of filled bins; then its row, with the
    shared-memory look-up floor beside the bytes bound. ``filter_bits``:
    both take the keep bytes over the index's id table, and the bound
    counts the kept rows (the kernel loads nothing of a row it drops) and
    the keep bytes. Returns the scan's operands and outputs for the stage
    breakdown."""
    import torch

    from raft_tpu_torch.neighbors import ivf_common, ivf_pq, sample_filter
    from raft_tpu_torch.ops import kernels as K

    B = q0.shape[0]
    _, probes = ivf_pq._coarse_probes(index, q0, n_probes, False)
    seg = ivf_common.SEGMENT_SIZE
    n_seg = ivf_common.n_segments(B * n_probes, index.n_lists, seg)
    seg_list, seg_q, pair_seg, pair_slot = ivf_common.segment_probes(
        probes, index.n_lists, seg, n_seg)
    q_rot = (q0 @ index.rotation.T).contiguous()
    scan_args = (seg_list, seg_q, pair_seg, pair_slot, q_rot,
                 index.packed_codes, index.packed_ids, index.packed_norms,
                 index.list_sizes, index.centers_rot, index.codebooks)
    fbytes = (None if filter_bits is None else
              sample_filter.list_filter_bytes(filter_bits, index.packed_ids))
    scan_kw = dict(pq_bits=index.pq_bits, pq_dim=index.pq_dim,
                   L=index.max_list_size, lut_dtype=lut_dtype,
                   filter_bytes=fbytes)
    kk, ki = K.ivfpq_lut_scan_topk(*scan_args, "l2", **scan_kw)
    cb = K.lut_codebook(index.codebooks, lut_dtype)
    plain_args = (seg_list, pair_seg, q_rot, index.packed_codes,
                  index.packed_ids, index.packed_norms, index.list_sizes,
                  index.centers_rot, cb, "l2", index.pq_bits, fbytes)
    pk, pi = K.ivfpq_lut_scan_topk_plain(*plain_args)
    if kk.shape != (B, n_probes, K.LUT_SCAN_BINS) or kk.shape != pk.shape:
        raise SmokeFailure(f"ivfpq_lut_scan_topk: output {list(kk.shape)}, "
                           f"plain {list(pk.shape)}")
    fin = torch.isfinite(pk)
    if not torch.equal(torch.isfinite(kk), fin):
        raise SmokeFailure("ivfpq_lut_scan_topk: filled bins differ")
    if not bool((ki[~fin] == -1).all()):
        raise SmokeFailure("ivfpq_lut_scan_topk: empty bins lack the -1 id")
    diff = (kk[fin] - pk[fin]).abs()
    err = float(diff.max())
    # keys = ‖c+d‖² − 2⟨q, c+d⟩: rounding scales with ‖q‖² and the key
    q_sq = (q_rot * q_rot).sum(1)[:, None, None].expand_as(pk)
    scale = (pk.abs() + q_sq)[fin]
    if not bool((diff <= 1e-3 + 1e-5 * scale).all()):
        raise SmokeFailure(f"ivfpq_lut_scan_topk keys differ by {err}")
    id_agree = float((ki[fin] == pi[fin]).float().mean())
    if id_agree < 0.999:
        raise SmokeFailure(f"ivfpq_lut_scan_topk ids agree on {id_agree}")
    del pk, pi, fin, q_sq
    # the bound counts what this batch's data needs: codes, ids and norms
    # of the probed lists' real rows (the kernel reads no row past a
    # list's size), the lists' sizes and centers, the codebook, the
    # queries, the segment and pair tables, and the [B, P, 256] output
    live = seg_q >= 0
    lists = torch.unique(seg_list[live.any(1)].long())
    L = index.max_list_size
    sizes = index.list_sizes.long()
    n_live = int(live.sum())
    nb = index.packed_codes.shape[2]
    rows_real = int(sizes[lists].sum())
    keep_bytes = 0
    if fbytes is not None:
        # the rows a search needs are the kept real rows, and each probed
        # list's keep bytes up to its size
        kept = K.unpack_filter_bytes(fbytes, L) & (
            torch.arange(L, device=sizes.device)[None, :] < sizes[:, None])
        keep_bytes = int(((sizes[lists] + 7) // 8).sum())
        sizes = kept.sum(1)
        del kept
    rows_kept = int(sizes[lists].sum())
    pair_rows = int((live.sum(1).long() * sizes[seg_list.long()]).sum())
    scan_bytes = (rows_kept * (nb + 8) + keep_bytes + lists.numel() * (
        q_rot.shape[1] + 1) * 4 + cb.numel() * 4 + q_rot.numel() * 4
        + seg_list.numel() * 4 + seg_q.numel() * 4 + pair_seg.numel() * 8
        + kk.numel() * 8)
    # per live pair: its LUT (a multiply-add per codebook entry) and, per
    # real row, one add per subspace
    scan_flops = n_live * 2 * cb.numel() + pair_rows * index.pq_dim
    # the look-ups: pq_dim shared-memory reads per (live pair, real row),
    # 32 words a clock on each of the card's 132 SMs
    clock = _sm_clock_hz()
    floor_ms = (pair_rows * index.pq_dim
                / (SMEM_WORDS_PER_CLOCK * N_SMS * clock) * 1e3)
    b_ms, _ = _bound_ms(scan_bytes, scan_flops)
    _row(rows, path, "ivfpq_lut_scan_topk", "ivfpq_lut_scan.cu", 807,
         launches["ivfpq_lut_scan_topk"], err,
         _timed(lambda: K.ivfpq_lut_scan_topk(*scan_args, "l2", **scan_kw),
                10),
         _timed(lambda: K.ivfpq_lut_scan_topk_plain(*plain_args),
                plain_reps),
         scan_bytes, scan_flops, None,
         f"{shape}n_seg {n_seg} x {seg} slots ({n_live} live pairs), L {L}, "
         f"{lists.numel()} lists of {rows_real} real rows"
         + ("" if fbytes is None else f" ({rows_kept} kept)")
         + f", {pair_rows} ({'kept ' if fbytes is not None else ''}live "
         f"pair, real row) pairs, id agreement {id_agree:.6f}",
         logged=dict(lookup_floor_ms=floor_ms, sm_clock_mhz=clock / 1e6,
                     larger_bound="lookups" if floor_ms > b_ms else "bytes"))
    return dict(kk=kk, ki=ki, probes=probes, seg=seg, n_seg=n_seg,
                q_rot=q_rot)


def _refine_row(rows, path, launches, base, q0, cand, k, shape="",
                filter_bits=None):
    """gather_refine_topk against its plain version on ``q0``'s candidates
    into ``base`` (f32 or bf16 rows: both versions widen bf16 to f32):
    keys within 1e-5·(‖q‖² + |key|), ids equal away from key ties; then
    its row: ms with the L2 cold, beside the warm, kernel-alone and host
    times. The bound counts the rows at the base's bytes a value.
    ``filter_bits``: both take the bitset's words, and the bound counts
    the kept candidates' rows and a word a candidate."""
    import torch

    from raft_tpu_torch.neighbors import sample_filter
    from raft_tpu_torch.ops import kernels as K

    B, dim = q0.shape
    gk, gi = K.gather_refine_topk(base, q0, cand, k, "l2",
                                  filter_bits=filter_bits)
    pk2, pi2 = K.gather_refine_topk_plain(base, q0, cand, k, "l2",
                                          filter_bits)
    err = float((gk - pk2).abs().max())
    # the expanded key cancels ‖q‖² + ‖r‖²; rounding scales with it
    tol = 1e-5 * ((q0 * q0).sum(1, keepdim=True) + pk2.abs())
    if not bool(((gk - pk2).abs() <= tol).all()):
        raise SmokeFailure(f"gather_refine_topk keys differ by {err}")
    # ids may differ only where the plain keys tie within the tolerance
    # (a neighbour in the sorted list, or the k-th against the k+1-th)
    gap = (pk2[:, 1:] - pk2[:, :-1]).abs() <= tol[:, 1:]
    tie = torch.zeros_like(gap[:, :1]).expand(-1, k).clone()
    tie[:, 1:] |= gap
    tie[:, :-1] |= gap
    tie[:, -1] = True
    if not bool(((gi == pi2) | tie).all()):
        raise SmokeFailure("gather_refine_topk ids differ away from key ties")
    id_agree = float((gi == pi2).float().mean())
    C = cand.shape[1]
    call = lambda: K.gather_refine_topk(  # noqa: E731
        base, q0, cand, k, "l2", filter_bits=filter_bits)
    # the rows a re-rank needs: its valid candidates', or with a filter its
    # kept candidates' and a 4-byte word a candidate
    n_rows = int(sample_filter.masked_ids(filter_bits, cand).ge(0).sum())
    words = 0 if filter_bits is None else B * C * 4
    # what the caller sees: the rows cold (it runs after the LUT scan has
    # streamed the codes); beside it warm back-to-back calls, the kernel
    # alone (a CUDA graph of the launches) and the wrapper's host time
    _row(rows, path, "gather_refine_topk", "gather_refine.cu", 1176,
         launches["gather_refine_topk"], err, _timed_cold(call, 30),
         _timed(lambda: K.gather_refine_topk_plain(base, q0, cand, k, "l2",
                                                   filter_bits), 10),
         n_rows * dim * base.element_size() + B * C * 4 + words
         + B * dim * 4 + B * k * 8,
         4.0 * n_rows * dim, None,
         f"{shape}[{B},{C}] candidates ({n_rows} rows to load) into "
         f"[{base.shape[0]},{dim}] {str(base.dtype)[6:]}, k={k}, id "
         f"agreement {id_agree:.6f}, ms with the L2 cold",
         warm_ms=_timed(call, 50), kernel_ms=_graph_ms(call, 50),
         host_ms=_host_ms(call, 20))


def refine_bf16_leg(args, rows, index, base, queries, sp, B, k, gt,
                    rec_f32_base, q0, cand):
    """``[refine bf16]`` (ROADMAP A8): the main path re-ranked against the
    DEEP-10M-shaped base cast to bf16 (a store that keeps its re-rank
    copy at half the memory): every query in batches of ``B`` through
    ``ivf_pq.search(..., dataset=base_bf16)`` (k_cand 400), counts zeroed
    just before and read just after (gather_refine_topk must launch: the
    fused tier takes bf16 rows), three passes of QPS (CUDA events),
    recall@10 against the f32 ground truth ``gt`` at least 0.95; against
    the ground truth of the bf16 rows themselves (``brute_force.knn`` on
    their f32 cast: what an exact re-rank of these rows can reach) within
    0.01 of the f32 base's recall against ``gt`` (``rec_f32_base``, the
    same queries, knobs and scan), like for like. The rows' own rounding
    costs recall against ``gt``: the ceiling, exact search over the bf16
    rows against ``gt``, is logged beside it. Then B2 on bf16 rows against
    its plain version at the first batch's 400 candidates (row
    ``ivf_pq_bf16``, the bound at 2 bytes a value). Frees the bf16 copy.
    Raises SmokeFailure; returns the summary."""
    import torch

    from raft_tpu_torch.neighbors import brute_force, ivf_pq
    from raft_tpu_torch.ops import kernels as K

    base_bf16 = base.to(torch.bfloat16)
    n_gt = gt.shape[0]
    _, gt16 = brute_force.knn_arrays(base_bf16.float(), queries[:n_gt], k,
                                     metric="sqeuclidean")
    gt16 = gt16.cpu()
    ceiling = _recall(gt16, gt)

    def search_pass():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        start.record()
        for a in range(0, args.queries, B):
            out.append(ivf_pq.search(index, queries[a:a + B], k, sp,
                                     dataset=base_bf16)[1])
        end.record()
        torch.cuda.synchronize()
        return torch.cat(out), start.elapsed_time(end) / 1e3

    K.reset_launch_counts()
    ids, secs = search_pass()
    launches = K.launch_counts()
    if launches["gather_refine_topk"] == 0:
        raise SmokeFailure(f"[refine bf16]: gather_refine_topk never "
                           f"launched on the bf16 base: {launches}")
    qps = [args.queries / secs] + [args.queries / search_pass()[1]
                                   for _ in range(2)]
    ids = ids.cpu()
    rec = _recall(ids[:n_gt], gt)
    rec16 = _recall(ids[:n_gt], gt16)
    _log(f"[refine bf16] {base.shape[0]} x {base.shape[1]} bf16 base "
         f"({base_bf16.numel() * 2 / 1e9:.2f} GB against "
         f"{base.numel() * 4 / 1e9:.2f} GB in f32), k_cand "
         f"{int(round(k * sp.refine_ratio))}, batch {B}: QPS "
         + ", ".join(f"{x:.0f}" for x in qps) + f" (CUDA events); recall@10 "
         f"on {n_gt} queries {rec:.4f} against the f32 ground truth (the "
         f"bf16 rows' exact search reaches {ceiling:.4f}), {rec16:.4f} "
         f"against the bf16 rows' own (f32 base against its own "
         f"{rec_f32_base:.4f}); launches {json.dumps(launches)}")
    if ids.shape != (args.queries, k) or bool((ids < 0).any()):
        raise SmokeFailure("[refine bf16]: malformed id table")
    if rec < 0.95 or abs(rec16 - rec_f32_base) > 0.01:
        raise SmokeFailure(f"[refine bf16]: recall@10 {rec} against the f32 "
                           f"ground truth (under 0.95?), {rec16} against the "
                           f"bf16 rows' (more than 0.01 from the f32 base's "
                           f"{rec_f32_base}?)")
    _refine_row(rows, "ivf_pq_bf16", launches, base_bf16, q0, cand, k)
    del base_bf16
    torch.cuda.empty_cache()
    return {"qps": qps, "recall_at_10": rec, "recall_bf16_truth": rec16,
            "bf16_exact_ceiling": ceiling, "recall_f32_base": rec_f32_base,
            "launches": launches}


def filter_main_leg(args, rows, index, base, queries, index_cpu, base_cpu,
                    sp, B, k, n_gt, n_pl):
    """The main path filtered (ROADMAP A6), on the IVF-PQ phase's index:
    keep masks drawn as the JAX bench draws them at selectivity 0.1 and
    0.01, packed with ``bitset.from_mask``, their exact ground truth from
    ``brute_force.knn(filter_bitset=)``. For each, with the counts zeroed
    just before: the refined search of every query in batches of B (three
    passes); B1 and B2 must have launched with their filter operands.
    Checks: no returned id has its bit clear, and the kernel path's recall
    on n_pl queries no more than 0.01 below the plain path's (the same
    filtered search on the CPU copy of the index). Then an all-pass
    bitset must give the unfiltered kernel path's ids and distances
    exactly, and B1 and B2 at selectivity 0.1 against their plain versions
    (their filtered rows). Raises SmokeFailure; returns the summary."""
    import torch

    from raft_tpu_torch.core import bitset
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, sample_filter
    from raft_tpu_torch.ops import kernels as K

    N, nq = base.shape[0], queries.shape[0]

    def search_pass(bits):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        start.record()
        for a in range(0, nq, B):
            out.append(ivf_pq.search(index, queries[a:a + B], k, sp,
                                     filter_bitset=bits, dataset=base)[1])
        end.record()
        torch.cuda.synchronize()
        return torch.cat(out), start.elapsed_time(end) / 1e3

    summary, kept_bits = {}, {}
    for sel in (0.1, 0.01):
        keep = bench_keep(N, sel, k)
        bits = bitset.from_mask(keep, device=base.device)
        kept_bits[sel] = bits
        _, fgt = brute_force.knn(brute_force.build(base, "sqeuclidean"),
                                 queries[:n_gt], k, filter_bitset=bits)
        fgt = fgt.cpu()
        K.reset_launch_counts()
        ids_f, t_f = search_pass(bits)
        launches = K.launch_counts()
        filtered = K.filtered_launch_counts()
        n_batches = -(-nq // B)
        for name in ("ivfpq_lut_scan_topk", "gather_refine_topk"):
            if filtered[name] != n_batches or launches[name] != n_batches:
                raise SmokeFailure(f"filtered main path: {name} launched "
                                   f"{launches[name]} times, {filtered[name]}"
                                   f" with its filter, for {n_batches} "
                                   f"batches")
        qps = [nq / t_f] + [nq / search_pass(bits)[1] for _ in range(2)]
        ids_f = ids_f.cpu()
        n_empty = _check_kept(ids_f, keep, f"filtered main path at {sel}")
        rec = _recall(ids_f[:n_gt], fgt)
        t0 = time.perf_counter()
        _, ids_pl = ivf_pq.search(index_cpu, queries[:n_pl].cpu(), k, sp,
                                  filter_bitset=bits.cpu(), dataset=base_cpu,
                                  device="cpu")
        _check_kept(ids_pl, keep, f"filtered plain path at {sel}")
        rec_plain = _recall(ids_pl, fgt[:n_pl])
        rec_kern = _recall(ids_f[:n_pl], fgt[:n_pl])
        _log(f"[filter main] selectivity {sel} ({int(keep.sum())} of {N} "
             f"rows kept, bitset {bits.numel() * 4 / 1e6:.2f} MB, keep bytes "
             f"{index.n_lists * ((index.max_list_size + 7) // 8) / 1e6:.2f} "
             f"MB): {nq} queries in batches of {B}, three passes (CUDA "
             f"events): " + ", ".join(f"{x:.0f}" for x in qps) + " QPS; "
             f"recall@10 {rec:.4f} on {n_gt} queries against the filtered "
             f"ground truth; {n_empty} empty slots; launches "
             f"{json.dumps(launches)}, with the filter "
             f"{json.dumps(filtered)}; {n_pl} queries: kernel path "
             f"{rec_kern:.4f}, plain path (CPU) {rec_plain:.4f} "
             f"({time.perf_counter() - t0:.1f} s)")
        if not rec_kern >= rec_plain - 0.01:
            raise SmokeFailure(f"filtered kernel-path recall {rec_kern} at "
                               f"{sel} is more than 0.01 below the plain "
                               f"path's {rec_plain}")
        summary[str(sel)] = {"kept": int(keep.sum()), "qps_runs": qps,
                             "recall_at_10": rec, "empty_slots": n_empty,
                             "recall_kernel_200": rec_kern,
                             "recall_plain_200": rec_plain,
                             "launches": launches,
                             "filtered_launches": filtered}

    # an all-pass bitset changes nothing on the kernel path
    allp = sample_filter.make_filter(N, device=base.device)
    for a in range(0, n_gt, B):
        q = queries[a:a + B]
        d0, i0 = ivf_pq.search(index, q, k, sp, dataset=base)
        d1, i1 = ivf_pq.search(index, q, k, sp, filter_bitset=allp,
                               dataset=base)
        if not (torch.equal(i0, i1) and torch.equal(d0, d1)):
            raise SmokeFailure("an all-pass filter changed the kernel path's "
                               "ids or distances")
    _log(f"[filter main] an all-pass bitset: ids and distances equal to the "
         f"unfiltered kernel path's on {n_gt} queries")

    # B1 and B2 with their filter operands at selectivity 0.1, on the
    # first batch's inputs (the filtered scan's 400 candidates)
    bits = kept_bits[0.1]
    q0 = queries[:B].contiguous()
    flaunch = summary["0.1"]["filtered_launches"]
    _lut_scan_row(rows, "ivf_pq_filter", flaunch, index, q0, sp.n_probes,
                  "bfloat16", "selectivity 0.1: ", filter_bits=bits)
    sp_scan = ivf_pq.SearchParams(**{**sp.__dict__, "refine": "none"})
    _, cand = ivf_pq.search(index, q0, 400, sp_scan, filter_bitset=bits)
    _refine_row(rows, "ivf_pq_filter", flaunch, base, q0, cand.contiguous(),
                k, "selectivity 0.1: ", filter_bits=bits)
    return summary


def tiered_leg(index, base, queries, sp, B, k, gt):
    """``[tiered]``: the main path with the base demoted to host memory
    (``placement.to_host``, one numpy array), on the IVF-PQ phase's index
    and queries. Passes over every query in batches of B: resident (B2 on
    the device base), tiered (``refine_transfer="tiered"``, the prefetch
    pipeline), serial (``"serial"``: one host gather a batch) and the
    pipeline with ``prefetch=False``; launch counts zeroed just before the
    tiered pass and read after it (B1 and B3 must launch). Checks: tiered,
    serial and prefetch=False equal bit for bit (ids and distances);
    tiered recall@10 on the ground-truth queries no more than 0.01 below
    the resident path's, and its ids equal the resident ones except at f32
    ties; a tiered pass filtered at selectivity 0.1 returns no cleared id.
    Prints wall-clock QPS of each pass, prefetch hits and stalls, and for
    one batch the ms of its scan and, per sub-batch, of the host gather
    (``time.perf_counter``; torch's gather and numpy's), the H2D copy of
    the pinned rows, the reader's whole fetch (gather and copy, waited on)
    and the landed re-rank (CUDA events). Raises SmokeFailure; returns the
    summary."""
    import dataclasses

    import numpy as np
    import torch

    from raft_tpu_torch.core import bitset
    from raft_tpu_torch.neighbors import ivf_pq, tiered
    from raft_tpu_torch.neighbors import refine as trefine
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.serve import placement

    nq, n_gt = queries.shape[0], gt.shape[0]
    t0 = time.perf_counter()
    host = placement.to_host(base)
    to_host_s = time.perf_counter() - t0
    if placement.dataset_tier(host) != "host":
        raise SmokeFailure("[tiered] to_host left the base on the card")
    k_cand = max(k, int(round(k * sp.refine_ratio)))
    scan_sp = dataclasses.replace(sp, refine="none")

    def run(params, dataset, prefetch=True, bits=None):
        spans.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = []
        for a in range(0, nq, B):
            q = queries[a:a + B]
            if prefetch:
                out.append(ivf_pq.search(index, q, k, params,
                                         filter_bitset=bits, dataset=dataset))
            else:
                out.append(tiered.search_refined_tiered(
                    ivf_pq.search, index, q, k, k_cand, scan_sp, bits,
                    dataset, index.metric, prefetch=False))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        d = torch.cat([o[0] for o in out]).cpu()
        i = torch.cat([o[1] for o in out]).cpu()
        return d, i, nq / secs, spans.counts()

    d_res, i_res, qps_res, _ = run(sp, base)
    # one untimed tiered batch: the first call allocates the pinned buffers
    ivf_pq.search(index, queries[:B], k, dataclasses.replace(
        sp, refine_transfer="tiered"), dataset=host)
    K.reset_launch_counts()
    d_t, i_t, qps_t, c_t = run(dataclasses.replace(
        sp, refine_transfer="tiered"), host)
    launches = K.launch_counts()
    d_s, i_s, qps_s, c_s = run(dataclasses.replace(
        sp, refine_transfer="serial"), host)
    d_n, i_n, qps_n, c_n = run(sp, host, prefetch=False)
    hits = sum(c_t.get("serve.prefetch.hit", {}).values())
    stalls = sum(c_t.get("serve.prefetch.stall", {}).values())
    _log(f"[tiered] base to host in {to_host_s:.2f} s "
         f"({host.nbytes / 1e9:.2f} GB numpy); wall-clock QPS over "
         f"{nq} queries in batches of {B}: resident {qps_res:.0f}, tiered "
         f"{qps_t:.0f}, serial {qps_s:.0f}, prefetch=False {qps_n:.0f}; "
         f"prefetch hits {hits}, stalls {stalls}; refine.dispatch "
         f"{json.dumps(c_t.get('refine.dispatch'))}")
    _log(f"[tiered] launches {json.dumps(launches)}")
    missing = [n for n in ("ivfpq_lut_scan_topk", "select_k")
               if launches[n] == 0]
    if missing:
        raise SmokeFailure(f"[tiered] kernels never launched: {missing}")
    if c_t.get("refine.dispatch", {}).get("tiered_prefetch", 0) == 0:
        raise SmokeFailure("[tiered] the prefetch tier did not serve")
    for name, (d, i) in (("serial", (d_s, i_s)),
                         ("prefetch=False", (d_n, i_n))):
        if not (torch.equal(i, i_t) and torch.equal(d, d_t)):
            raise SmokeFailure(
                f"[tiered] tiered and {name} differ: "
                f"{int((i != i_t).sum())} ids, "
                f"{int((d != d_t).sum())} distances")
    rec_t, rec_r = _recall(i_t[:n_gt], gt), _recall(i_res[:n_gt], gt)
    swaps = _swaps_are_ties(queries, base, i_t.to(base.device),
                            i_res.to(base.device), "[tiered]")
    _log(f"[tiered] recall@10 on {n_gt} queries: tiered {rec_t:.4f}, "
         f"resident {rec_r:.4f}; ids equal to the resident path's but at "
         f"{swaps} f32 ties; tiered = serial = prefetch=False bit for bit")
    if rec_t < rec_r - 0.01:
        raise SmokeFailure(f"[tiered] recall {rec_t} more than 0.01 below "
                           f"the resident path's {rec_r}")

    keep = bench_keep(base.shape[0], 0.1, k)
    bits = bitset.from_mask(keep, device=base.device)
    _, i_f, qps_f, c_f = run(dataclasses.replace(
        sp, refine_transfer="tiered"), host, bits=bits)
    n_empty = _check_kept(i_f, keep, "[tiered] filtered")
    _log(f"[tiered] filtered at selectivity 0.1: no cleared id returned "
         f"({n_empty} empty slots), {qps_f:.0f} QPS, hits "
         f"{sum(c_f.get('serve.prefetch.hit', {}).values())}, stalls "
         f"{sum(c_f.get('serve.prefetch.stall', {}).values())}")

    # one batch, stage by stage
    q0 = queries[:B]
    mb = tiered.pipeline_batch(B)
    _, ids0 = ivf_pq.search(index, q0, k_cand, scan_sp)
    ids_s, qs = ids0[:mb], q0[:mb]
    ids_np = ids_s.cpu().numpy()
    safe = np.clip(ids_np, 0, host.shape[0] - 1).reshape(-1)
    stage = torch.empty((safe.size, host.shape[1]), dtype=torch.float32,
                        pin_memory=True)
    dst = torch.empty(stage.shape, dtype=torch.float32, device=base.device)
    fetch = tiered.host_row_reader(host)

    def host_ms(fn):
        out = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
        return out

    per_sub = {
        "sub_batch": mb, "rows": mb * k_cand,
        "scan_ms_batch": _timed(lambda: ivf_pq.search(index, q0, k_cand,
                                                      scan_sp), 10),
        "gather_torch_ms": host_ms(lambda: trefine.host_gather_rows(
            host, safe, out=stage)),
        "gather_numpy_ms": host_ms(lambda: host[safe]),
        "h2d_ms": _timed(lambda: dst.copy_(stage, non_blocking=True), 10),
        "fetch_ms": host_ms(lambda: fetch(ids_np).event.synchronize()),
    }
    rows = fetch(ids_np).ready()
    per_sub["rerank_ms"] = _timed(lambda: trefine.refine_landed(
        rows, qs, ids_s, k), 10)
    _log(f"[tiered] one batch of {B}, sub-batches of {mb}: "
         f"{json.dumps(per_sub)}")
    return {"qps": {"resident": qps_res, "tiered": qps_t, "serial": qps_s,
                    "prefetch_false": qps_n, "tiered_filtered_0.1": qps_f},
            "prefetch_hits": hits, "prefetch_stalls": stalls,
            "recall_at_10": {"tiered": rec_t, "resident": rec_r},
            "tie_swaps": swaps, "to_host_s": to_host_s,
            "sub_batch": per_sub, "launches": launches}


def _final_knobs(path, knobs, batch, has_lut):
    """Replay a walk's rungs on a fresh ladder: the knobs it ended on."""
    from raft_tpu_torch.robust import degrade

    ladder = degrade.standard_search_ladder(batch, has_lut=has_lut)
    for name in path:
        step, knobs = ladder.advance(knobs)
        if step.name != name:
            raise SmokeFailure(f"[resilient] replay took {step.name} where "
                               f"the walk took {name}")
    return knobs


def _direct(search, index, queries, k, knobs):
    """One call with the knobs, split as the ladder's batched call splits."""
    import torch

    mb = knobs.get("max_batch") or queries.shape[0]
    out = [search(index, queries[a:a + mb], k, knobs["params"],
                  dataset=knobs.get("dataset"))
           for a in range(0, queries.shape[0], mb)]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def resilient_leg(index, base, queries, sp, B, k):
    """``[resilient]`` on the IVF-PQ phase's index: (a) the injected plan
    ``RESILIENT_PLAN`` (RESOURCE_EXHAUSTED at ``ivf_pq.search`` for its
    first three hits) under ``search_resilient`` of one batch of B: the
    walk's path must be ``RESILIENT_PATH`` (the JAX package's path for the
    same plan and knobs) and its results equal, bit for bit, direct calls
    with the knobs the walk ended on. (b) A real
    ``torch.cuda.OutOfMemoryError``: the peak memory of one native search
    of every query at once is measured uncapped, then, after
    ``torch.cuda.empty_cache()``, ``set_per_process_memory_fraction`` caps
    the allocator at what is reserved plus 0.7 of that peak, and
    ``search_resilient`` of the same queries must degrade with
    ``degrade.steps{reason=resource_exhausted}`` and no fault fired, and
    give what uncapped direct calls with its final knobs give; the
    fraction is set back to 1.0 in a ``finally``. Counts zeroed before
    each and read after. Raises SmokeFailure; returns the summary."""
    import torch

    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.robust import degrade, faults

    q0 = queries[:B]
    spans.reset()
    degrade.clear_recent()
    K.reset_launch_counts()
    faults.install_plan(RESILIENT_PLAN)
    t0 = time.perf_counter()
    try:
        d_r, i_r = ivf_pq.search_resilient(index, q0, k, sp, dataset=base)
    finally:
        faults.clear_plan()
    walk_s = time.perf_counter() - t0
    launches_a = K.launch_counts()
    path = [st["to"] for st in degrade.recent_steps()]
    fired = spans.total("faults.fired", site="ivf_pq.search")
    _log(f"[resilient] injected {json.dumps(RESILIENT_PLAN)}: path "
         f"{path}, {fired:.0f} faults fired, {walk_s:.2f} s; launches "
         f"{json.dumps(launches_a)}")
    if path != RESILIENT_PATH:
        raise SmokeFailure(f"[resilient] path {path}, expected "
                           f"{RESILIENT_PATH} (the JAX package's)")
    knobs = _final_knobs(path, {"params": sp, "dataset": base}, B, True)
    d_d, i_d = _direct(ivf_pq.search, index, q0, k, knobs)
    if not (torch.equal(i_r, i_d) and torch.equal(d_r, d_d)):
        raise SmokeFailure("[resilient] injected walk differs from a direct "
                           "call with its final knobs")
    del knobs

    # (b) a real OOM
    nq = queries.shape[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    a0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ivf_pq.search(index, queries, k, sp, dataset=base)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - a0
    del out
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    reserved = torch.cuda.memory_reserved()
    cap = reserved + int(0.7 * peak)
    spans.reset()
    degrade.clear_recent()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        torch.cuda.set_per_process_memory_fraction(cap / total)
        d_r, i_r = ivf_pq.search_resilient(index, queries, k, sp,
                                           dataset=base)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    walk_s = time.perf_counter() - t0
    launches_b = K.launch_counts()
    path_b = [st["to"] for st in degrade.recent_steps()]
    moves = spans.total("degrade.steps", site="ivf_pq.search",
                        reason="resource_exhausted")
    _log(f"[resilient] real OOM: native search of {nq} queries peaks at "
         f"{peak / 2**30:.2f} GiB over {a0 / 2**30:.2f} GiB allocated; "
         f"capped at {cap / 2**30:.2f} GiB ({cap / total:.4f} of the card): "
         f"path {path_b}, {moves:.0f} moves, {walk_s:.2f} s, faults fired "
         f"{spans.total('faults.fired'):.0f}, recovered "
         f"{spans.total('degrade.recovered', site='ivf_pq.search'):.0f}; "
         f"launches {json.dumps(launches_b)}")
    if not path_b or moves < 1 or spans.total("faults.fired") != 0:
        raise SmokeFailure("[resilient] the capped search did not degrade "
                           "on a classified real OOM")
    if spans.total("degrade.recovered", site="ivf_pq.search") != 1:
        raise SmokeFailure("[resilient] the ladder did not recover")
    knobs = _final_knobs(path_b, {"params": sp, "dataset": base}, nq, True)
    d_d, i_d = _direct(ivf_pq.search, index, queries, k, knobs)
    if not (torch.equal(i_r, i_d) and torch.equal(d_r, d_d)):
        raise SmokeFailure("[resilient] the recovered search differs from "
                           "an uncapped call with its final knobs")
    _log("[resilient] both walks equal direct calls with their final knobs "
         "bit for bit")
    return {"injected_path": path, "injected_launches": launches_a,
            "oom_path": path_b, "oom_peak_gib": peak / 2**30,
            "oom_cap_gib": cap / 2**30, "oom_walk_s": walk_s,
            "oom_launches": launches_b}


# the port's kernels by the name of their CUDA entry in the profiler's
# trace (ops/csrc/*.cu) → the TPU kernel each replaces
PROF_KERNELS = (
    ("B1", "ivfpq_lut_scan_topk", ("lut_scan_kernel",)),
    ("B2", "gather_refine_topk", ("gather_refine_kernel",)),
    ("B3", "select_k", ("select_k_short", "select_k_long")),
    ("B4", "fused_l2_argmin", ("fused_l2_argmin_kernel",)),
    ("B5", "segmented_scan_topk", ("segmented_scan_kernel",)),
    ("B6", "grouped_scan_topk", ("grouped_scan_kernel",)),
    ("B7", "ring_topk_merge", ("ring_chain_kernel",)),
    ("B8", "ring_lut_scan_merge", ("ring_local_kernel",)),
)
# the profiler's device activities: kernels, copies, fills
PROF_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kernel_id(name: str):
    for bid, _, entries in PROF_KERNELS:
        if any(e in name for e in entries):
            return bid
    return None


def read_profile(path: str, split: str | None = None):
    """The device activities of a ``torch.profiler`` Chrome trace (what
    ``obs.prof.capture`` wrote): per name, launches and total ms (top
    first), the B-ids seen, and the device idle share — 1 − the union of
    the kernel, copy and fill intervals over the window from the first
    activity's start to the last one's end. With ``split``, the name of a
    ``record_function`` range entered after a synchronize, the activities
    before it and from it on are read apart: → (before, after)."""
    with open(path) as f:
        doc = json.load(f)
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") in PROF_DEVICE_CATS]
    if split is None:
        return _profile_summary(path, events)
    marks = [float(e["ts"]) for e in doc.get("traceEvents", [])
             if e.get("ph") == "X" and e.get("name") == split]
    if not marks:
        raise SmokeFailure(f"[obs prof] the trace {path} has no range "
                           f"{split!r}")
    t = min(marks)
    return (_profile_summary(path, [e for e in events
                                    if float(e["ts"]) < t]),
            _profile_summary(path, [e for e in events
                                    if float(e["ts"]) >= t]))


def _profile_summary(path: str, events):
    if not events:
        raise SmokeFailure(f"[obs prof] the trace {path} holds no device "
                           "activity")
    by_name = {}
    for e in events:
        n, ms = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, ms + float(e["dur"]) / 1e3)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events)
    busy, cur_a, cur_b = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    window = max(b for _, b in spans) - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"top": [{"name": n, "id": _kernel_id(n), "launches": c,
                     "ms": round(ms, 3)} for n, (c, ms) in top],
            "ids": sorted({_kernel_id(n) for n in by_name} - {None}),
            "window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window if window > 0 else 0.0}


def obs_leg(args, index, base, queries, sp, B, k, stages_ms, build_reg):
    """``[obs …]`` on the IVF-PQ phase's index (ROADMAP A13): the main
    path under recording spans, the device-memory gauges, the index's
    health, the timeline, flight dump and exposition, the profile of the
    refined batches, and the cost of spans with observability off. Every
    check raises SmokeFailure; returns the summary."""
    import shutil
    import tempfile
    import urllib.error
    import urllib.request
    import warnings

    import torch

    from raft_tpu_torch import obs
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.obs import (expo, flight, hbm, index_stats, prof,
                                    sanitize, trace)
    from raft_tpu_torch.obs.metrics import quantile_from_state
    from raft_tpu_torch.ops import kernels as K

    out_dir = args.obs_dir or tempfile.mkdtemp(prefix="chip_smoke_obs_")
    os.makedirs(out_dir, exist_ok=True)
    n_b = 10
    batches = [queries[a:a + B] for a in range(0, n_b * B, B)]

    def run(qs):
        return [ivf_pq.search(index, q, k, sp, dataset=base) for q in qs]

    run(batches[:2])  # warm
    torch.cuda.synchronize()

    # [obs spans]: ten refined batches under sync-mode spans
    reg = obs.MetricsRegistry()
    trace.get_buffer().clear()
    obs.enable(sync=True, events=True, registry=reg)
    try:
        t0 = time.perf_counter()
        res = run(batches)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        hists = {n[len("span."):]: st
                 for n, st in reg.snapshot()["histograms"].items()
                 if n.startswith("span.")}
        durs = {}
        for e in trace.get_buffer().snapshot():
            if e.get("ph") == "X":
                durs.setdefault(e["name"], []).append(e["dur"])
        rows = {}
        for name, st in sorted(hists.items()):
            ds = sorted(durs.get(name, []))
            rows[name] = {
                "count": st["count"],
                "median_ms": 1e3 * ds[len(ds) // 2] if ds else None,
                "p50_ms": 1e3 * quantile_from_state(st, 0.5),
                "p99_ms": 1e3 * quantile_from_state(st, 0.99),
                "sum_ms": 1e3 * st["sum"]}
        import threading

        # the host's state, which the root rule reads (ROADMAP C6): an
        # isolated batch waits for the host's launches before B1
        _log(f"[obs spans] {n_b} refined batches of {B}, sync mode, "
             f"device ms by span (count, exact median from the event ring, "
             f"the histogram's p50 and p99): {json.dumps(rows)}; wall "
             f"{wall_s * 1e3:.2f} ms; host load average "
             f"{os.getloadavg()[0]:.2f}, Python threads "
             f"{sorted(t.name for t in threading.enumerate())}")
        root = "ivf_pq.search"
        if rows.get(root, {}).get("count") != n_b:
            raise SmokeFailure(f"[obs spans] root span count "
                               f"{rows.get(root)} for {n_b} batches")
        need = [f"{root}.ivf_pq.search", f"{root}.ivf_pq.search.scan",
                f"{root}.refine", f"{root}.refine.fused_scan"]
        missing = [n for n in need if rows.get(n, {}).get("count") != n_b]
        if missing:
            raise SmokeFailure(f"[obs spans] spans missing or miscounted: "
                               f"{missing}")
        stage_sum = sum(rows[n]["sum_ms"] for n in
                        (f"{root}.ivf_pq.search", f"{root}.refine"))
        root_sum = rows[root]["sum_ms"]
        if not stage_sum <= root_sum <= wall_s * 1e3:
            raise SmokeFailure(f"[obs spans] stages {stage_sum:.3f} ms, root "
                               f"{root_sum:.3f} ms, wall "
                               f"{wall_s * 1e3:.3f} ms: not nested")
        med = rows[root]["median_ms"]
        ref = stages_ms["search_total"]
        _log(f"[obs spans] stages {stage_sum:.3f} ms <= root "
             f"{root_sum:.3f} ms <= wall {wall_s * 1e3:.3f} ms; root median "
             f"{med:.3f} ms against [stages] search_total {ref:.3f} ms "
             f"({(med - ref) / ref:+.1%}); build spans (obs on, no sync): "
             + json.dumps({n[len("span."):]: round(st["sum"], 3) for n, st
                           in build_reg.snapshot()["histograms"].items()}))
        if abs(med - ref) > 0.25 * ref:
            raise SmokeFailure(f"[obs spans] root median {med:.3f} ms is more "
                               f"than 25 % from search_total {ref:.3f} ms")

        # [obs hbm]
        g = reg.snapshot()["gauges"]
        sampled = {n: g.get(n) for n in ("hbm.bytes_in_use",
                                         "hbm.peak_bytes",
                                         "hbm.bytes_limit")}
        hbm.sample(reg)
        stats = torch.cuda.memory_stats()
        g = reg.snapshot()["gauges"]
        total = torch.cuda.get_device_properties(0).total_memory
        _log(f"[obs hbm] at the last root span's exit: "
             f"{json.dumps(sampled)}; sampled again: in use "
             f"{g['hbm.bytes_in_use']:.0f}, peak {g['hbm.peak_bytes']:.0f}, "
             f"limit {g['hbm.bytes_limit']:.0f}; memory_stats: allocated "
             f"{stats['allocated_bytes.all.current']}, peak "
             f"{stats['allocated_bytes.all.peak']}")
        if (g["hbm.bytes_in_use"] != stats["allocated_bytes.all.current"]
                or g["hbm.peak_bytes"] != stats["allocated_bytes.all.peak"]
                or sampled["hbm.bytes_in_use"] is None):
            raise SmokeFailure("[obs hbm] gauges differ from memory_stats")
        try:
            torch.cuda.set_per_process_memory_fraction(0.9)
            capped = hbm.bytes_limit()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        _log(f"[obs hbm] bytes_limit {hbm.bytes_limit()} of {total}; at "
             f"fraction 0.9: {capped}")
        if capped != int(total * 0.9) or hbm.bytes_limit() != total:
            raise SmokeFailure("[obs hbm] bytes_limit does not follow the "
                               "memory fraction")

        # [obs index]
        t0 = time.perf_counter()
        desc = index_stats.describe_index(index, base, sample_rows=2048,
                                          max_lists=256)
        desc_s = time.perf_counter() - t0
        pq = desc.get("pq") or {}
        _log(f"[obs index] describe_index of the {index.size}-row index in "
             f"{desc_s:.2f} s: lists {json.dumps(desc.get('lists'))}; drift "
             f"{json.dumps(desc.get('drift'))}; pq error over "
             f"{pq.get('rows_sampled')} rows: mean {pq.get('mean')}, max "
             f"{pq.get('max')}, rel {pq.get('rel_error')}"
             + (f"; error {desc['error']}" if "error" in desc else ""))
        bg = build_reg.snapshot()["gauges"]
        cheap = {n: v for n, v in bg.items()
                 if n.startswith("index.") and "{index=ivf_pq.build}" in n}
        _log(f"[obs index] the build's gauges: {json.dumps(cheap)}")
        if ("error" in desc or not desc.get("drift") or not pq
                or cheap.get("index.n_lists{index=ivf_pq.build}")
                != index.n_lists
                or "index.list_cv{index=ivf_pq.build}" not in cheap):
            raise SmokeFailure("[obs index] index stats or the build's "
                               "gauges are missing")

        # [obs timeline]
        tl_path = os.path.join(out_dir, "timeline.json")
        n_ev = trace.export_chrome(tl_path)
        doc = trace.load(tl_path)
        names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
        lost = sorted(set(hists) - names)
        dump = flight.dump_now(reason="chip_smoke", dump_dir=out_dir)
        flight.uninstall()
        with open(dump) as f:
            fd = json.load(f)
        fleet = fd.get("fleet") or {}
        server = expo.ExpoServer(port=0, registry=reg).start()
        try:
            with urllib.request.urlopen(server.url + "/metrics",
                                        timeout=30) as r:
                text = r.read().decode()
            codes = {}
            for route in ("/healthz", "/indexz", "/costz"):
                try:
                    with urllib.request.urlopen(server.url + route,
                                                timeout=30) as r:
                        codes[route] = r.status
                except urllib.error.HTTPError as e:
                    codes[route] = e.code
        finally:
            server.stop()
        parsed = expo.parse_prometheus(text)
        unserved = sorted({row["name"] for row in reg.collect()
                           if expo.prom_name(row["name"]) not in parsed})
        _log(f"[obs timeline] {n_ev} events to {tl_path}, loaded back with "
             f"{len(names)} span names ({len(lost)} missing); flight dump "
             f"{dump}: {len(fd.get('events', []))} events, "
             f"{len(fd.get('metrics', {}).get('histograms', {}))} histograms, "
             f"fleet run_id {fleet.get('run_id')} pid {fleet.get('pid')}; "
             f"/metrics {len(text)} bytes, {len(parsed)} families parsed, "
             f"{len(unserved)} series not served; {json.dumps(codes)}")
        if (lost or unserved or not fd.get("events")
                or not fd.get("metrics", {}).get("histograms")
                or not fleet.get("run_id")
                or codes != {"/healthz": 200, "/indexz": 404,
                             "/costz": 404}):
            raise SmokeFailure(f"[obs timeline] lost spans {lost}, unserved "
                               f"series {unserved}, routes {codes}")
    finally:
        obs.disable()
    del res

    # [obs prof]: 20 warm refined batches under torch.profiler, obs off
    prof_batches = [queries[(a % 20) * B:(a % 20 + 1) * B] for a in range(20)]
    run(prof_batches[:2])
    x = base[:1 << 20].contiguous()
    c = index.centers.contiguous()
    K.fused_l2_argmin(x, c)
    # one capture: the batches, then (after a synchronize, in a range of
    # its own) one fused_l2_argmin call for the build's B4 — a second
    # profiler session in one process once came back without device
    # activity
    cap = prof.capture(out_dir).start()
    run(prof_batches)
    torch.cuda.synchronize()
    with torch.profiler.record_function("chip_smoke.fused_l2_argmin"):
        K.fused_l2_argmin(x, c)
    cap.stop()
    if cap.error is not None or cap.path is None:
        raise SmokeFailure(f"[obs prof] capture failed: {cap.error!r}")
    main, build = read_profile(cap.path, split="chip_smoke.fused_l2_argmin")
    _log(f"[obs prof] 20 refined batches of {B}: device idle share "
         f"{main['idle_share']:.4f} of a {main['window_ms']:.3f} ms window "
         f"({main['busy_ms']:.3f} ms busy); top 10 by device time: "
         + json.dumps(main["top"][:10]))
    _log(f"[obs prof] one fused_l2_argmin call [{x.shape[0]}, "
         f"{x.shape[1]}] x [{c.shape[0]}, {c.shape[1]}]: "
         + json.dumps(build["top"][:3]) + f"; kernels seen "
         f"{main['ids'] + build['ids']}")
    seen = set(main["ids"]) | set(build["ids"])
    if not {"B1", "B2", "B3"} <= set(main["ids"]) or "B4" not in seen:
        raise SmokeFailure(f"[obs prof] B1–B4 not all named in the profile: "
                           f"{sorted(seen)}")

    # [obs off]: a disabled span's cost against a batch's time
    assert not obs.enabled()
    n = 50_000
    t0 = time.perf_counter()
    for _ in range(n):
        with tracing.span("overhead_probe"):
            pass
    per_span = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for _ in range(n // 5):
        with torch.profiler.record_function("overhead_probe"):
            pass
    per_rf = (time.perf_counter() - t0) / (n // 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(batches)
    torch.cuda.synchronize()
    per_batch = (time.perf_counter() - t0) / n_b
    _log(f"[obs off] one disabled span enter/exit {per_span * 1e6:.3f} us "
         f"(a record_function range alone {per_rf * 1e6:.3f} us, opened "
         f"only under a capture); 32 spans {32 * per_span * 1e6:.1f} us = "
         f"{32 * per_span / per_batch:.4%} of a {per_batch * 1e3:.3f} ms "
         f"batch")
    if not 32 * per_span < 0.02 * per_batch:
        raise SmokeFailure("[obs off] 32 disabled spans cost 2 % or more of "
                           "a batch")
    q0 = batches[0]
    try:
        with sanitize.no_host_transfers():
            d0, i0 = ivf_pq.search(index, q0, k, sp, dataset=base)
        torch.cuda.synchronize()
        syncs = []
    except RuntimeError as e:
        first = str(e).splitlines()[0]
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ivf_pq.search(index, q0, k, sp, dataset=base)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        syncs = [f"{w.filename}:{w.lineno}" for w in caught]
        for s in syncs:
            _log(f"[obs off] host sync at {s}")
        raise SmokeFailure(f"[obs off] a refined batch under "
                           f"no_host_transfers raised: {first}; "
                           f"{len(syncs)} syncs logged")
    _log("[obs off] a refined batch under sanitize.no_host_transfers() "
         "finished with no host sync")
    if args.obs_dir is None:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"spans_ms": rows, "wall_ms": wall_s * 1e3,
            "hbm": {n: g[n] for n in ("hbm.bytes_in_use", "hbm.peak_bytes",
                                      "hbm.bytes_limit")},
            "index": desc, "index_s": desc_s,
            "prof_top": main["top"][:10], "idle_share": main["idle_share"],
            "prof_window_ms": main["window_ms"],
            "span_off_us": per_span * 1e6,
            "record_function_us": per_rf * 1e6,
            "batch_ms": per_batch * 1e3}

# the [serve …] leg's server settings (PERF.md §4): buckets 1…512 for the
# main path's batch of 500, the JAX package's linger, an SLO of about 20 ×
# a full batch's time
SERVE_CONFIG = {"max_batch": 512, "queue_depth": 8192, "linger_s": 0.002,
                "default_slo_s": 0.1, "expo_port": 0}
SERVE_STEPS = (1_000.0, 5_000.0, 20_000.0, 50_000.0)
SERVE_STEP_S = 3.0
# the A/B's rate: past what the demoted tenant completes, so batches queue
# up past 32 requests and take the tiered pipeline (smaller ones take the
# serial gather, with or without the reader thread)
SERVE_AB_QPS = 10_000.0
SERVE_STORM = 2_000


def _resolve(futs, timeout=30.0):
    """Every future's outcome, each waited on with a timeout: ("ok",
    (distances, ids)), ("shed", reason), ("deadline", None) or ("error",
    repr). An unresolved future raises SmokeFailure."""
    import concurrent.futures as cf

    from raft_tpu_torch import serve

    out = []
    for f in futs:
        try:
            out.append(("ok", f.result(timeout=timeout)))
        except cf.TimeoutError:
            raise SmokeFailure("[serve] a future was left unresolved")
        except serve.ShedError as e:
            out.append(("shed", e.reason))
        except serve.DeadlineExceeded:
            out.append(("deadline", None))
        except Exception as e:  # noqa: BLE001 — counted, checked
            out.append(("error", repr(e)))
    return out


def _served_rows(outcomes, what):
    import numpy as np

    bad = [o for o in outcomes if o[0] != "ok"]
    if bad:
        raise SmokeFailure(f"{what}: {len(bad)} requests not served: "
                           f"{bad[:3]}")
    return (np.stack([o[1][0] for o in outcomes]),
            np.stack([o[1][1] for o in outcomes]))


def _check_rows(queries, base, d_got, i_got, d_ref, i_ref, what):
    """Served rows against reference rows: ids equal but at f32 ties
    (checked in f64), distances within 1e-5 relative where the ids
    agree. Returns the tie count."""
    import numpy as np
    import torch

    i_got = torch.as_tensor(np.asarray(i_got)).to(base.device)
    i_ref = torch.as_tensor(np.asarray(i_ref)).to(base.device)
    ties = _swaps_are_ties(queries, base, i_got, i_ref, what)
    same = (i_got == i_ref).cpu().numpy()
    d_got, d_ref = np.asarray(d_got), np.asarray(d_ref)
    err = np.abs(d_got - d_ref)[same]
    lim = (1e-5 * np.abs(d_ref))[same]
    if np.any(err > lim):
        raise SmokeFailure(f"{what}: distances differ by up to "
                           f"{float((err / np.maximum(lim, 1e-30)).max()):.3g}"
                           " × the 1e-5 relative tolerance")
    return ties


def _span_totals(reg):
    """``(count, seconds)`` of every ``span.serve.dispatch*`` histogram of
    a metrics registry: the batcher's time in dispatch and in the stages
    under it."""
    return {n[len("span."):]: (h["count"], h["sum"])
            for n, h in reg.snapshot()["histograms"].items()
            if n.startswith("span.serve.dispatch")}


def serve_leg(args, index, base, queries, sp, B, k):
    """``[serve …]`` (ROADMAP A14): the serving plane over the IVF-PQ
    phase's index, searched with the phase's parameters and re-ranked
    against its device base, answering single-query traffic. Parts:
    ``[serve warm]`` (warmup seconds by bucket; each bucket's first
    served batch after warmup against its warm median), ``[serve
    parity]`` (500 single-query submits equal to direct searches but at
    f32 ties), ``[serve load]`` (an open-loop sweep at SERVE_STEPS, every
    request a result or a typed error, recall@10 ≥ 0.95), ``[serve
    prof]`` (the 20,000/s step under ``obs.prof.capture``), ``[serve
    expo]`` (the endpoints over HTTP during the sweep, the cost ledger's
    conservation, the flight dump's sections), ``[serve quality]`` (the
    shadow verifier's Wilson interval), ``[serve chaos]`` (an injected
    OOM walks the ladder, a stall sheds by deadline, a stop sheds the
    queue as draining), ``[serve tiers]`` (a second tenant demotes the
    first's raw vectors to host; the reader thread against the inline
    fetch at SERVE_AB_QPS) and ``[serve router]`` (two pods, pod b killed
    mid-storm). Raises SmokeFailure; returns the summary."""
    import dataclasses
    import functools
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from raft_tpu_torch import obs, serve
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, tiered
    from raft_tpu_torch.obs import expo, flight, prof, trace
    from raft_tpu_torch.obs.metrics import counter_sum
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.robust import degrade, faults
    from raft_tpu_torch.serve import dispatch as sdispatch
    from raft_tpu_torch.serve import loadgen
    from raft_tpu_torch.serve.server import _FILL_BUCKETS

    t_leg = time.perf_counter()
    dev = base.device
    out = {}
    q_host = queries.cpu().numpy()
    nq = q_host.shape[0]
    slo = SERVE_CONFIG["default_slo_s"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    mreg = obs.MetricsRegistry()
    obs.enable(registry=mreg, hbm=False, events=True)
    trace.get_buffer().clear()
    os.environ["RAFT_TPU_FLIGHT_DIR"] = tmp
    registry = serve.IndexRegistry(device=dev)
    t0 = time.perf_counter()
    registry.admit("deep10m", index, params=sp, default_k=k, dataset=base)
    admit_s = time.perf_counter() - t0
    # the verifier offers 2 % of completed requests (the JAX package's
    # default fraction) and takes one a second (its token bucket): 10–30
    # replays over the sweep and its profile
    cfg = serve.ServerConfig(**SERVE_CONFIG, verify_sample=0.02,
                             verify_rate_per_s=1.0)
    srv = serve.MicroBatchServer(registry, cfg)
    try:
        # [serve warm]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        srv.start(warmup=True)
        warm_s = time.perf_counter() - t0
        launches = K.launch_counts()
        obs.enable(registry=mreg, hbm=False)  # events off from here on
        by_bucket = {}
        for e in trace.get_buffer().snapshot():
            a = e.get("args") or {}
            if e.get("name") == "serve.dispatch" and "batch" in a:
                by_bucket.setdefault(int(a["batch"]), []).append(e["dur"])
        tenant = registry.peek("deep10m")
        _log(f"[serve warm] admit {admit_s:.2f} s (index stats with the "
             f"base); start(warmup=True) {warm_s:.2f} s over buckets "
             f"{list(srv.buckets)}, seconds by bucket "
             + json.dumps({b: round(sum(v), 4)
                           for b, v in sorted(by_bucket.items())})
             + f"; state {tenant.state}; launches {json.dumps(launches)}")
        if sorted(by_bucket) != list(srv.buckets) or tenant.state != \
                "serving":
            raise SmokeFailure("[serve warm] warmup did not run every "
                               "bucket through dispatch")
        missing = [n for n in PQ_KERNELS if n != "fused_l2_argmin"
                   and launches[n] == 0]
        if missing:
            raise SmokeFailure(f"[serve warm] kernels never launched: "
                               f"{missing}")
        ratios = {}
        for j, b in enumerate(srv.buckets):
            qb = np.zeros((b, q_host.shape[1]), np.float32)
            qb[:] = q_host[(j * 512 + np.arange(b)) % nq]
            qd = torch.from_numpy(qb).to(base.device)
            times = []
            for _ in range(6):
                t = time.perf_counter()
                sdispatch.dispatch_batch(tenant, qd, k)
                times.append((time.perf_counter() - t) * 1e3)
            med = float(np.median(times[1:]))
            ratios[b] = (round(times[0], 3), round(med, 3),
                         round(times[0] / med, 3))
        _log("[serve warm] first served batch after warmup against the warm "
             "median, ms (first, median of 5, ratio): " + json.dumps(ratios))
        slow = {b: r for b, r in ratios.items()
                if r[2] > 5.0 and r[0] - r[1] > 2.0}
        if slow:
            raise SmokeFailure(f"[serve warm] first batches > 5 × and > 2 ms "
                               f"over their warm medians: {slow}")
        out["warm"] = {"admit_s": admit_s, "start_s": warm_s,
                       "by_bucket_s": {b: sum(v) for b, v in
                                       by_bucket.items()},
                       "first_vs_warm_ms": ratios}

        # [serve parity]
        n_par = 500
        with srv._cond:  # one batch: the batcher waits for the lock
            futs = [srv.submit("deep10m", q_host[j], k, slo_s=None)
                    for j in range(n_par)]
        d_s, i_s = _served_rows(_resolve(futs), "[serve parity]")
        ref = [ivf_pq.search(index, queries[j:j + 1], k, sp, dataset=base,
                             device=dev) for j in range(n_par)]
        d_r = torch.cat([r[0] for r in ref]).cpu().numpy()
        i_r = torch.cat([r[1] for r in ref]).cpu().numpy()
        ties = _check_rows(queries[:n_par], base, d_s, i_s, d_r, i_r,
                           "[serve parity]")
        _log(f"[serve parity] {n_par} single-query submits (one batch of "
             f"{n_par}, bucket 512) equal {n_par} direct searches of one "
             f"query: ids but at {ties} f32 ties, distances within 1e-5 "
             "relative")
        out["parity_ties"] = ties

        # [serve load] with [serve expo] fetching during it
        t0 = time.perf_counter()
        gt = torch.cat([brute_force.knn_arrays(base, queries[a:a + 1000], k,
                                               metric="sqeuclidean", device=dev)[1]
                        for a in range(0, nq, 1000)]).cpu().numpy()
        gt_s = time.perf_counter() - t0
        scraped = {}
        stop_scrape = threading.Event()

        def scrape():
            url = srv.expo.url
            while not stop_scrape.is_set():
                for ep in ("/metrics", "/healthz", "/indexz", "/costz"):
                    with urllib.request.urlopen(url + ep, timeout=10) as r:
                        body = r.read().decode()
                    scraped[ep] = (expo.parse_prometheus(body)
                                   if ep == "/metrics" else json.loads(body))
                    scraped.setdefault("n", 0)
                    scraped["n"] += 1
                stop_scrape.wait(0.5)

        scraper = threading.Thread(target=scrape, daemon=True)
        scraper.start()
        K.reset_launch_counts()
        rows = []
        fills = []
        for j, rate in enumerate(SERVE_STEPS[:2]):
            h0 = mreg.histogram("serve.batch_fill", buckets=_FILL_BUCKETS).state()
            rows.append(loadgen.run_step(srv, "deep10m", q_host, k, rate,
                                         SERVE_STEP_S, seed=j,
                                         ground_truth=gt))
            h1 = mreg.histogram("serve.batch_fill", buckets=_FILL_BUCKETS).state()
            fills.append((h1["sum"] - h0["sum"])
                         / max(h1["count"] - h0["count"], 1))
        # [serve prof]: the 20,000/s step under the profiler
        cap = prof.capture(os.path.join(tmp, "prof")).start()
        spans0 = _span_totals(mreg)
        h0 = mreg.histogram("serve.batch_fill", buckets=_FILL_BUCKETS).state()
        rows.append(loadgen.run_step(srv, "deep10m", q_host, k,
                                     SERVE_STEPS[2], SERVE_STEP_S, seed=2,
                                     ground_truth=gt))
        h1 = mreg.histogram("serve.batch_fill", buckets=_FILL_BUCKETS).state()
        fills.append((h1["sum"] - h0["sum"])
                     / max(h1["count"] - h0["count"], 1))
        cap.stop()
        spans1 = _span_totals(mreg)
        for j, rate in enumerate(SERVE_STEPS[3:], start=3):
            h0 = mreg.histogram("serve.batch_fill", buckets=_FILL_BUCKETS).state()
            rows.append(loadgen.run_step(srv, "deep10m", q_host, k, rate,
                                         SERVE_STEP_S, seed=j,
                                         ground_truth=gt))
            h1 = mreg.histogram("serve.batch_fill", buckets=_FILL_BUCKETS).state()
            fills.append((h1["sum"] - h0["sum"])
                         / max(h1["count"] - h0["count"], 1))
        stop_scrape.set()
        scraper.join(timeout=15)
        launches = K.launch_counts()
        _log(f"[serve load] launches over the sweep {json.dumps(launches)}")
        missing = [n for n in PQ_KERNELS if n != "fused_l2_argmin"
                   and launches[n] == 0]
        if missing:
            raise SmokeFailure(f"[serve load] kernels never launched: "
                               f"{missing}")
        for row, fill in zip(rows, fills):
            row["arrival_rate"] = row["sent"] / SERVE_STEP_S
            row["mean_fill"] = fill
            row.pop("slow_trace_ids", None)
            _log("[serve load] " + json.dumps(
                {key: row[key] for key in (
                    "offered_qps", "arrival_rate", "qps", "latency_p50_s",
                    "latency_p99_s", "sent", "completed", "shed",
                    "shed_reasons", "deadline_missed", "errors",
                    "mean_fill", "recall", "device_s", "cost_share")}))
            ends = (row["completed"] + row["shed"] + row["deadline_missed"]
                    + row["errors"])
            if ends != row["sent"]:
                raise SmokeFailure(f"[serve load] {row['sent']} sent, "
                                   f"{ends} ended")
            if row["errors"]:
                raise SmokeFailure(f"[serve load] {row['errors']} errors at "
                                   f"{row['offered_qps']}/s")
            if row["completed"] and row["recall"] < 0.95:
                raise SmokeFailure(f"[serve load] recall@10 {row['recall']}"
                                   f" < 0.95 at {row['offered_qps']}/s")
        under = [r["offered_qps"] for r in rows
                 if r["latency_p99_s"] is not None
                 and r["latency_p99_s"] < slo]
        best = max(under) if under else None
        arrived = {r["offered_qps"]: round(r["arrival_rate"], 1)
                   for r in rows}
        _log(f"[serve load] ground truth of {nq} queries in {gt_s:.1f} s; "
             f"the highest offered step with p99 under the {slo * 1e3:.0f} "
             f"ms SLO: {best} (arrivals the open-loop client reached, "
             f"by offered rate: {json.dumps(arrived)})")
        out["load"] = rows
        out["best_step_under_slo"] = best

        summ = read_profile(cap.path)
        ids = summ["ids"]
        _log(f"[serve prof] {SERVE_STEPS[2]:.0f}/s for {SERVE_STEP_S} s "
             f"under torch.profiler: device idle {summ['idle_share']:.4f} "
             f"of {summ['window_ms']:.1f} ms; top kernels "
             + json.dumps([{key: t[key] for key in ("name", "id", "launches",
                                                    "ms")}
                           for t in summ["top"][:10]]))
        host = {n_: (v[0] - spans0.get(n_, (0, 0.0))[0],
                     (v[1] - spans0.get(n_, (0, 0.0))[1]) * 1e3)
                for n_, v in spans1.items()}
        n_disp, disp_ms = host.get("serve.dispatch", (0, 0.0))
        _log(f"[serve prof] host: {n_disp} batches in the step, "
             f"serve.dispatch spans {disp_ms:.1f} ms in all "
             f"({disp_ms / max(n_disp, 1):.2f} ms a batch, the card busy "
             f"{summ['busy_ms'] / max(n_disp, 1):.2f} ms a batch); spans "
             "(count, ms): " + json.dumps({n_: [v[0], round(v[1], 1)]
                                          for n_, v in host.items()}))
        if not {"B1", "B2", "B3"} <= set(ids):
            raise SmokeFailure(f"[serve prof] B1–B3 not all named: {ids}")
        out["prof"] = {"idle_share": summ["idle_share"],
                       "window_ms": summ["window_ms"],
                       "top": summ["top"][:10], "batches": n_disp,
                       "dispatch_ms": disp_ms}

        # [serve expo]
        if scraped.get("n", 0) < 4:
            raise SmokeFailure("[serve expo] the endpoints were not scraped")
        fams = scraped["/metrics"]
        need = ("raft_tpu_serve_requests", "raft_tpu_serve_latency_s",
                "raft_tpu_cost_device_s")
        if not all(any(f.startswith(n) for f in fams) for n in need):
            raise SmokeFailure(f"[serve expo] /metrics lacks {need}")
        health, indexz = scraped["/healthz"], scraped["/indexz"]
        costz = scraped["/costz"]
        if health.get("tenants", {}).get("deep10m") != "serving" or \
                "deep10m" not in indexz.get("tenants", {}) or \
                "deep10m" not in costz.get("ledger", {}).get("tenants", {}):
            raise SmokeFailure("[serve expo] a payload misses the tenant")
        cons = srv.ledger.conservation()
        path = flight.dump_now(reason="serve_smoke")
        with open(path) as f:
            dump = json.load(f)
        flight.uninstall()
        sections = [s for s in ("serve_registry", "quality", "cost")
                    if s in dump]
        _log(f"[serve expo] {scraped['n']} scrapes during the sweep: "
             f"/metrics {len(fams)} families; /healthz "
             f"{json.dumps({k2: health[k2] for k2 in ('status', 'tenants', 'resident')})}"
             f"; /indexz lists {indexz['tenants']['deep10m']['stats']['lists']['n_lists']}"
             f" lists, bytes {json.dumps(indexz['tenants']['deep10m'].get('bytes'))}"
             f"; /costz device_s "
             f"{costz['ledger']['tenants']['deep10m']['device_s']:.4f}; "
             f"conservation {json.dumps(cons)}; flight dump sections "
             f"{sections}")
        if cons["rel_err"] > 1e-6:
            raise SmokeFailure(f"[serve expo] conservation off by "
                               f"{cons['rel_err']}")
        if len(sections) != 3:
            raise SmokeFailure(f"[serve expo] the dump has {sections}")
        out["expo"] = {"scrapes": scraped["n"], "families": len(fams),
                       "conservation": cons}

        # [serve quality]: wait for the verdicts
        t0 = time.perf_counter()
        ver = srv.verifier
        while time.perf_counter() - t0 < 60.0:
            with ver._lock:
                pending = len(ver._pending)
            if not pending:
                break
            time.sleep(0.2)
        time.sleep(3.0)  # the replay in flight
        summary = ver.recall_summary("deep10m").get(k, {})
        state = ver.state()
        _log(f"[serve quality] {state['verified_total']} exact host replays "
             f"(waited {time.perf_counter() - t0:.1f} s after the sweep): "
             f"recall@10 {summary.get('recall')}, Wilson 95 % interval "
             f"[{summary.get('ci_low')}, {summary.get('ci_high')}] over "
             f"{summary.get('n')} verdicts; skips "
             + json.dumps({key: v for key, v in
                           mreg.snapshot()["counters"].items()
                           if key.startswith("quality.skipped")}))
        if not summary or summary["ci_high"] < 0.95:
            raise SmokeFailure(f"[serve quality] interval {summary}")
        out["quality"] = {**summary, "verified": state["verified_total"]}

        # [serve chaos]
        degrade.clear_recent()
        n_c = 64
        faults.install_plan({"faults": [{"site": "ivf_pq.search",
                                         "kind": "oom", "times": 1}]})
        try:
            with srv._cond:
                futs = [srv.submit("deep10m", q_host[j], k, slo_s=None)
                        for j in range(n_c)]
            d_c, i_c = _served_rows(_resolve(futs), "[serve chaos] oom")
        finally:
            faults.clear_plan()
        path_c = [st["to"] for st in degrade.recent_steps()
                  if st["site"] == "ivf_pq.search"]
        knobs = _final_knobs(path_c, {"params": sp, "dataset": base}, n_c,
                             True)
        d_d, i_d = _direct(functools.partial(ivf_pq.search, device=dev),
                           index, queries[:n_c], k, knobs)
        if not (np.array_equal(i_c, i_d.cpu().numpy())
                and np.array_equal(d_c, d_d.cpu().numpy())):
            raise SmokeFailure("[serve chaos] the walked batch differs from "
                               "direct calls with its final knobs")
        st_oom = registry.peek("deep10m").state
        if st_oom != "degraded" or not path_c:
            raise SmokeFailure(f"[serve chaos] path {path_c}, state "
                               f"{st_oom}")
        shed0 = counter_sum(mreg.collect(), "serve.shed", reason="deadline")
        faults.install_plan({"faults": [{"site": "serve.dispatch",
                                         "kind": "sleep",
                                         "sleep_s": 2.5 * slo,
                                         "times": 1}]})
        try:
            slow_f = srv.submit("deep10m", q_host[0], k, slo_s=None)
            time.sleep(0.05)
            doomed = srv.submit("deep10m", q_host[1], k)
            o_stall = _resolve([slow_f, doomed])
        finally:
            faults.clear_plan()
        shed1 = counter_sum(mreg.collect(), "serve.shed", reason="deadline")
        if o_stall[0][0] != "ok" or o_stall[1][0] != "deadline" or \
                shed1 - shed0 != 1:
            raise SmokeFailure(f"[serve chaos] stall: {o_stall}, deadline "
                               f"sheds {shed1 - shed0}")
        faults.install_plan({"faults": [{"site": "serve.dispatch",
                                         "kind": "sleep", "sleep_s": 0.3,
                                         "times": 0}]})
        try:
            first = srv.submit("deep10m", q_host[0], k, slo_s=None)
            time.sleep(0.05)
            queued = [srv.submit("deep10m", q_host[j], k, slo_s=None)
                      for j in range(32)]
            srv.stop(drain=False)
            o_stop = _resolve([first] + queued)
        finally:
            faults.clear_plan()
        kinds = [o[0] if o[0] != "shed" else o[1] for o in o_stop]
        _log(f"[serve chaos] injected OOM in the served search: path "
             f"{path_c}, {n_c} rows equal direct calls with its final knobs "
             f"bit for bit, tenant {st_oom}; a {2.5 * slo:.2f} s stall at "
             f"serve.dispatch: {[o[0] for o in o_stall]}, serve.shed"
             f"{{reason=deadline}} +{shed1 - shed0:.0f}; stop(drain=False) "
             f"with 32 queued: {kinds.count('ok')} ok, "
             f"{kinds.count('draining')} draining; no future unresolved")
        if kinds.count("draining") < 1 or set(kinds) - {"ok", "draining"}:
            raise SmokeFailure(f"[serve chaos] stop outcomes {kinds}")
        out["chaos"] = {"oom_path": path_c, "stop": kinds.count("draining")}
    finally:
        srv.stop(drain=False)
        flight.uninstall()

    # [serve tiers]
    s_idx = serve.index_device_bytes(index, dev)
    s_raw = base.numel() * base.element_size()
    budget = 2 * s_idx + s_raw + s_raw // 2
    treg = serve.IndexRegistry(budget_bytes=budget, headroom_frac=0.0,
                               device=dev)
    treg.admit("t_a", index, params=sp, default_k=k, dataset=base.clone())
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    treg.admit("t_b", index, params=sp, default_k=k, dataset=base)
    demote_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    freed = alloc0 - torch.cuda.memory_allocated()
    gauges = {(r["labels"]["index"], r["labels"]["tier"]): r["value"]
              for r in mreg.collect()
              if r["name"] == "index.bytes" and r["kind"] == "gauge"}
    demoted = counter_sum(mreg.collect(), "serve.registry.demote",
                          tenant="t_a")
    want = {("t_a", "hbm"): s_idx, ("t_a", "host"): s_raw,
            ("t_b", "hbm"): s_idx + s_raw, ("t_b", "host"): 0}
    _log(f"[serve tiers] budget {budget:,} B (two tenants need "
         f"{2 * (s_idx + s_raw):,}): admitting t_b demoted t_a's raw "
         f"vectors in {demote_s:.2f} s (serve.registry.demote "
         f"{demoted:.0f}); memory_allocated fell {freed:,} B (the base is "
         f"{s_raw:,}); index.bytes "
         + json.dumps({f"{a}/{b}": v for (a, b), v in sorted(
             gauges.items()) if a in ("t_a", "t_b")}))
    if demoted != 1 or any(gauges.get(key) != v for key, v in want.items()):
        raise SmokeFailure("[serve tiers] demotion counters or gauges wrong")
    if abs(freed - s_raw) > s_raw // 100:
        raise SmokeFailure(f"[serve tiers] {freed} B freed, not the base's")
    tsrv = serve.MicroBatchServer(treg, serve.ServerConfig(**{
        **SERVE_CONFIG, "expo_port": None}))
    orig = tiered.search_refined_tiered
    try:
        tsrv.start(warmup=True)
        with tsrv._cond:
            futs = [tsrv.submit("t_a", q_host[j], k, slo_s=None)
                    for j in range(B)]
        d_h, i_h = _served_rows(_resolve(futs), "[serve tiers]")
        d_res, i_res = ivf_pq.search(index, queries[:B], k, sp,
                                     dataset=base, device=dev)
        ties_t = _swaps_are_ties(queries[:B], base,
                                 torch.from_numpy(i_h).to(base.device),
                                 i_res, "[serve tiers]")
        ab = []
        for mode in ("thread", "inline", "thread", "inline"):
            tiered.search_refined_tiered = (
                orig if mode == "thread"
                else functools.partial(orig, prefetch=False))
            spans_before = mreg.snapshot()["counters"]
            row = loadgen.run_step(tsrv, "t_a", q_host, k, SERVE_AB_QPS,
                                   SERVE_STEP_S, seed=11)
            after = mreg.snapshot()["counters"]
            hits = sum(v - spans_before.get(key, 0) for key, v in
                       after.items() if key.startswith("serve.prefetch.hit"))
            stalls = sum(v - spans_before.get(key, 0) for key, v in
                         after.items()
                         if key.startswith("serve.prefetch.stall"))
            ab.append({"mode": mode, "qps": row["qps"],
                       "p50_s": row["latency_p50_s"],
                       "p99_s": row["latency_p99_s"], "sent": row["sent"],
                       "shed": row["shed"],
                       "missed": row["deadline_missed"],
                       "errors": row["errors"], "hits": hits,
                       "stalls": stalls})
    finally:
        tiered.search_refined_tiered = orig
        tsrv.stop(drain=False)
    _log(f"[serve tiers] the demoted tenant's {B} served rows equal the "
         f"resident answers but at {ties_t} f32 ties")
    for r in ab:
        _log("[serve tiers] A/B " + json.dumps(r))
    if any(r["errors"] for r in ab):
        raise SmokeFailure("[serve tiers] errors in the A/B steps")
    out["tiers"] = {"freed_bytes": freed, "demote_s": demote_s,
                    "ties": ties_t, "ab": ab}
    for name in ("t_a", "t_b"):
        treg.evict(name)
    del treg, tsrv
    torch.cuda.empty_cache()

    # [serve router]
    pods = [serve.Pod(n, registry=serve.IndexRegistry(device=dev))
            for n in "ab"]
    router = serve.FleetRouter(pods)
    placed = router.place("deep10m", index, hot=True, params=sp,
                          default_k=k, dataset=base)
    for p in pods:
        p.registry.mark("deep10m", "serving")
    c0 = mreg.snapshot()["counters"]
    kill_at = SERVE_STORM // 4
    faults.install_plan({"faults": [{"site": "serve.router.hop.b",
                                     "kind": "error", "after": kill_at // 2,
                                     "times": 0}]})
    results = [None] * SERVE_STORM
    qd = queries[:SERVE_STORM]

    def client(lo, hi):
        for j in range(lo, hi):
            try:
                d, i = router.dispatch("deep10m", qd[j:j + 1], k)
                results[j] = ("ok", d.cpu(), i.cpu())
            except serve.ShedError as e:
                results[j] = ("shed", e.reason)
            except Exception as e:  # noqa: BLE001 — checked below
                results[j] = ("error", repr(e))

    t0 = time.perf_counter()
    try:
        per = SERVE_STORM // 4
        threads = [threading.Thread(target=client, args=(a, a + per))
                   for a in range(0, SERVE_STORM, per)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        faults.clear_plan()
    storm_s = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise SmokeFailure("[serve router] a request was left unanswered")
    c1 = {key: v - c0.get(key, 0)
          for key, v in mreg.snapshot()["counters"].items()
          if key.startswith(("serve.router.", "faults.fired"))
          and v != c0.get(key, 0)}
    ok = [j for j, r in enumerate(results) if r[0] == "ok"]
    shed = [r for r in results if r[0] == "shed"]
    errs = [r for r in results if r[0] == "error"]
    d_o = torch.cat([results[j][1] for j in ok])
    i_o = torch.cat([results[j][2] for j in ok])
    ref = [ivf_pq.search(index, qd[j:j + 1], k, sp, dataset=base, device=dev)
           for j in ok]
    d_ref = torch.cat([r[0] for r in ref]).cpu()
    i_ref = torch.cat([r[1] for r in ref]).cpu()
    ties_r = _check_rows(qd[ok], base, d_o.numpy(), i_o.numpy(),
                         d_ref.numpy(), i_ref.numpy(), "[serve router]")
    down = c1.get("serve.router.pod_down{pod=b}", 0)
    fired = c1.get("faults.fired{kind=error,site=serve.router.hop.b}", 0)
    _log(f"[serve router] pods {placed} hold the tenant (replicate); "
         f"{SERVE_STORM} single-query requests from 4 threads in "
         f"{storm_s:.2f} s, pod b killed at its {kill_at // 2}th hop: "
         f"{len(ok)} answered (equal to direct searches but at {ties_r} f32 "
         f"ties), {len(shed)} shed, {len(errs)} errors; pod b healthy "
         f"{pods[1].healthy}; counters {json.dumps(c1)}")
    if errs or shed or len(ok) != SERVE_STORM or pods[1].healthy:
        raise SmokeFailure(f"[serve router] outcomes: {errs[:2]} {shed[:2]}")
    if c1.get("serve.router.requests{tenant=deep10m}") != SERVE_STORM or \
            down != fired or down < 1 or \
            c1.get("serve.router.degraded{reason=pod_lost}") != down or \
            c1.get("serve.router.shed{reason=pod_unhealthy}", 0) != 0:
        raise SmokeFailure(f"[serve router] counters {c1} do not match the "
                           "outcomes")
    out["router"] = {"answered": len(ok), "pod_down": down,
                     "storm_s": storm_s, "ties": ties_r}
    for p in pods:
        p.registry.evict("deep10m")
    del pods, router
    obs.disable()
    os.environ.pop("RAFT_TPU_FLIGHT_DIR", None)
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["leg_s"] = time.perf_counter() - t_leg
    _log(f"[serve] leg in {out['leg_s']:.1f} s")
    return out


def flat_resilient_leg(index, queries, k):
    """``[flat resilient]``: IVF-Flat ``search_resilient`` of 500 queries
    (approx at n_probes 32) under an injected plan of two
    RESOURCE_EXHAUSTED at ``ivf_flat.search``: the walk must recover and
    equal direct calls with its final knobs bit for bit."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.robust import degrade, faults

    q0 = queries[:500]
    sp = ivf_flat.SearchParams(n_probes=32, scan_mode="grouped",
                               scan_select="approx")
    plan = {"faults": [{"site": "ivf_flat.search", "kind": "oom",
                        "times": 2}]}
    spans.reset()
    degrade.clear_recent()
    K.reset_launch_counts()
    faults.install_plan(plan)
    try:
        d_r, i_r = ivf_flat.search_resilient(index, q0, k, sp)
    finally:
        faults.clear_plan()
    launches = K.launch_counts()
    path = [st["to"] for st in degrade.recent_steps()]
    knobs = _final_knobs(path, {"params": sp, "dataset": None}, 500, False)
    d_d, i_d = _direct(ivf_flat.search, index, q0, k, knobs)
    same = torch.equal(i_r, i_d) and torch.equal(d_r, d_d)
    _log(f"[flat resilient] {json.dumps(plan)}: path {path}, recovered "
         f"{spans.total('degrade.recovered', site='ivf_flat.search'):.0f}, "
         f"equal to direct calls with its final knobs: {same}; launches "
         f"{json.dumps(launches)}")
    if not path or not same:
        raise SmokeFailure("[flat resilient] the walk did not recover to "
                           "its final knobs' results")
    return {"path": path, "launches": launches}


def flat_phase(args, rows):
    """IVF-Flat at the repo's 1M hard_config shape (bench.py:194-210,
    255-260): build, the approx legs at n_probes 16/32/64/128 and the exact
    leg at 32 (batch 10,000), small-batch legs, recall and tier checks, and
    the path's four kernels against their plain versions at its shapes.
    Raises SmokeFailure on any failed check. Returns (the base, queries and
    ground truth of the first 1,000 queries, for the IVF-PQ leg; the
    phase's summary)."""
    import numpy as np
    import torch

    from raft_tpu_torch.bench.dataset import make_synthetic_hard
    from raft_tpu_torch.neighbors import brute_force, ivf_common, ivf_flat
    from raft_tpu_torch.ops import kernels as K

    N, dim, nq, k = FLAT_N, 128, 10_000, 10
    t0 = time.perf_counter()
    ds = make_synthetic_hard("sift-1000k-hard-synth", N, dim, nq,
                             seed=args.seed)
    base = torch.from_numpy(ds.base).cuda()
    queries = torch.from_numpy(ds.queries).cuda()
    del ds
    torch.cuda.synchronize()
    _log(f"[flat data] make_synthetic_hard {N} x {dim} + {nq} queries in "
         f"{time.perf_counter() - t0:.1f} s")

    # the path: build, then every search leg; counts zeroed just before
    K.reset_launch_counts()
    stages = {}
    t0 = time.perf_counter()
    index = ivf_flat.build(base, ivf_flat.IndexParams(
        n_lists=1024, spill=True, list_size_cap_factor=1.5, seed=args.seed),
        stage_seconds=stages)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    L = index.max_list_size
    dropped = N - index.size
    _log(f"[flat build] {build_s:.2f} s ("
         + ", ".join(f"{s} {v:.2f}s" for s, v in stages.items())
         + f"); L = {L}; dropped rows {dropped}")

    def sp(n_probes, select, mode="grouped"):
        return ivf_flat.SearchParams(n_probes=n_probes, scan_mode=mode,
                                     scan_select=select)

    def timed_search(params, q):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ivf_flat.search(index, q, k, params)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / 1e3

    legs = {}
    for n_probes in (16, 32, 64, 128):
        passes = 3 if n_probes == 32 else 1
        secs = []
        for _ in range(passes):
            (_, ids), t = timed_search(sp(n_probes, "approx"), queries)
            secs.append(t)
        legs[f"approx_{n_probes}"] = {"ids": ids.cpu(),
                                      "qps": [nq / t for t in secs]}
    secs = []
    for _ in range(2):   # the first pass is the grouped tier's first call
        (_, ids), t = timed_search(sp(32, "exact"), queries)
        secs.append(t)
    legs["exact_32"] = {"ids": ids.cpu(), "qps": [nq / t for t in secs]}
    small = {}
    for bsz, n_small in ((10, 200), (1, 50)):
        lat, out = [], []
        for a in range(0, n_small, bsz):
            (_, ids), t = timed_search(sp(32, "approx", "auto"),
                                       queries[a:a + bsz])
            lat.append(t * 1e3)
            out.append(ids)
        small[bsz] = (torch.cat(out).cpu(), lat)
    launches = K.launch_counts()
    _log(f"[flat] launches {json.dumps(launches)}")
    missing = [n for n in FLAT_KERNELS if launches[n] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the IVF-Flat path: "
                           f"{missing}")
    for name, leg in legs.items():
        if leg["ids"].shape != (nq, k) or bool((leg["ids"] < 0).any()):
            raise SmokeFailure(f"IVF-Flat leg {name}: malformed id table")

    # recall against exact search, every leg
    n_gt = 1000
    _, gt = brute_force.knn_arrays(base, queries[:n_gt], k,
                                   metric="sqeuclidean")
    gt = gt.cpu()
    recall = {name: _recall(leg["ids"][:n_gt], gt)
              for name, leg in legs.items()}
    for bsz, (ids, lat) in small.items():
        recall[f"batch{bsz}_approx_32"] = _recall(ids, gt[:ids.shape[0]])
    (_, ids_pq), t_pq = timed_search(sp(32, "approx", "per_query"),
                                     queries[:n_gt])
    recall["per_query_32"] = _recall(ids_pq.cpu(), gt)
    for name, leg in legs.items():
        _log(f"[flat leg] {name}: QPS "
             + ", ".join(f"{x:.0f}" for x in leg["qps"])
             + f" (batch {nq}, CUDA events; batch ms "
             + ", ".join(f"{nq / x * 1e3:.3f}" for x in leg["qps"])
             + f"); recall@10 {recall[name]:.4f}")
    for bsz, (ids, lat) in small.items():
        _log(f"[flat leg] batch {bsz}, approx n_probes 32 (per_query tier): "
             f"{len(lat)} calls, per call ms median {np.median(lat):.3f}, "
             f"min {min(lat):.3f}, max {max(lat):.3f}; recall@10 "
             f"{recall[f'batch{bsz}_approx_32']:.4f}")
    _log(f"[flat recall] per_query tier, n_probes 32, {n_gt} queries: "
         f"{recall['per_query_32']:.4f} ({t_pq * 1e3:.1f} ms)")
    if abs(recall["exact_32"] - recall["per_query_32"]) > 0.002:
        raise SmokeFailure(f"exact grouped recall {recall['exact_32']} vs "
                           f"per_query {recall['per_query_32']}")
    curve = [recall[f"approx_{p}"] for p in (16, 32, 64, 128)]
    if any(b < a for a, b in zip(curve, curve[1:])):
        raise SmokeFailure(f"approx recall falls as n_probes rises: {curve}")
    # [tristates] RAFT_TPU_PALLAS_GROUPED=off: neither scan launches, the
    # plain grouped tier answers (ROADMAP A1)
    grouped_off = {}
    for select in ("approx", "exact"):
        grouped_off[select] = _tristate_off(
            "RAFT_TPU_PALLAS_GROUPED", ("segmented_scan_topk",
                                        "grouped_scan_topk"),
            lambda: ivf_flat.search(index, queries[:n_gt], k,
                                    sp(32, select))[1],
            gt, recall[f"{select}_32"], f"IVF-Flat {select} at n_probes 32, "
            f"{n_gt} queries")[0]

    # kernel path against the plain path: the same index on the CPU
    n_pl = 200
    t0 = time.perf_counter()
    index_cpu = ivf_flat.from_numpy(*ivf_flat.to_numpy(index), device="cpu")
    q_cpu = queries[:n_pl].cpu()
    plain_rec = {}
    for select in ("approx", "exact"):
        _, ids_pl = ivf_flat.search(index_cpu, q_cpu, k, sp(32, select),
                                    device="cpu")
        plain_rec[select] = _recall(ids_pl, gt[:n_pl])
        kern = _recall(legs[f"{select}_32"]["ids"][:n_pl], gt[:n_pl])
        _log(f"[flat recall] {select} n_probes 32, {n_pl} queries: kernel "
             f"path {kern:.4f}, plain path (CPU) {plain_rec[select]:.4f}")
        if not kern >= plain_rec[select] - 0.01:
            raise SmokeFailure(f"{select}: kernel-path recall {kern} more "
                               f"than 0.01 below the plain path's "
                               f"{plain_rec[select]}")
    _log(f"[flat recall] plain path took {time.perf_counter() - t0:.1f} s")
    filt_summary = flat_filter_leg(index, index_cpu, base, queries, k, nq,
                                   n_gt, n_pl)
    del index_cpu

    # the two scan kernels on the first batch's segment table (n_probes 32)
    n_probes, seg = 32, ivf_common.SEGMENT_SIZE
    mt = ivf_flat.resolve_metric(index.metric)
    probes = ivf_flat._probes(index, queries, n_probes, mt)
    n_seg = ivf_common.n_segments(nq * n_probes, index.n_lists, seg)
    seg_list, seg_q, pair_seg, pair_slot = ivf_common.segment_probes(
        probes, index.n_lists, seg, n_seg)
    args_k = (seg_list, seg_q, queries, index.packed_data, index.packed_ids)
    live = seg_q >= 0
    sizes = index.list_sizes.long()
    lists = torch.unique(seg_list[live.any(1)].long())
    rows_real = int(sizes[lists].sum())
    n_live = int(live.sum())
    pair_rows = int((live.sum(1).long() * sizes[seg_list.long()]).sum())
    flops = 2.0 * dim * pair_rows
    in_bytes = (rows_real * (dim * 4 + 4) + queries.numel() * 4
                + seg_list.numel() * 4 + seg_q.numel() * 4)
    shape = (f"n_seg {n_seg} x {seg} slots ({n_live} live), L {L}, "
             f"{lists.numel()} lists of {rows_real} real rows, d {dim}")
    qrow = seg_q.clamp_min(0).long()

    def l2_key64(si, sj, xrow):
        qv = queries[qrow[si, sj]].double()
        x = xrow.double()
        return ((qv - x) ** 2).sum(1)

    sk, si_ = K.segmented_scan_topk(*args_k, "l2")
    spk, spi = K.segmented_scan_topk_plain(*args_k, "l2")
    err, agree = _check_scan(
        "segmented_scan_topk", sk, si_, spk, spi, seg_q, queries,
        lambda a, b, picks: l2_key64(a, b, base[picks.long()]))
    # the bound of the design: three TF32 products (f32 lists) on the
    # tensor cores; one fp32 product on the CUDA cores (PRs 2-5's row) and
    # the bytes are logged beside it
    beside = dict(bound_fp32_ms=flops / FP32_FLOP_PER_S * 1e3)
    _row(rows, "ivf_flat", "segmented_scan_topk", "segmented_scan.cu", 397,
         launches["segmented_scan_topk"], err,
         _timed(lambda: K.segmented_scan_topk(*args_k, "l2"), 5),
         _timed(lambda: K.segmented_scan_topk_plain(*args_k, "l2"), 1),
         in_bytes + sk.numel() * 8, 3.0 * flops, None,
         shape + f", id agreement {agree:.6f}", flop_rate=TF32_FLOP_PER_S,
         logged=dict(beside, bound_bytes_ms=(in_bytes + sk.numel() * 8)
                     / HBM_BYTES_PER_S * 1e3))
    scan_ms = rows[-1]["ms"]
    del spk, spi

    gk, gp = K.grouped_scan_topk(*args_k, k, "l2")
    pgk, pgp = K.grouped_scan_topk_plain(*args_k, k, "l2")
    lst_of = seg_list.long()
    err, agree = _check_scan(
        "grouped_scan_topk", gk, gp, pgk, pgp, seg_q, queries,
        lambda a, b, picks: l2_key64(
            a, b, index.packed_data[lst_of[a], picks.long()]))
    _row(rows, "ivf_flat", "grouped_scan_topk", "grouped_scan.cu", 281,
         launches["grouped_scan_topk"], err,
         _timed(lambda: K.grouped_scan_topk(*args_k, k, "l2"), 5),
         _timed(lambda: K.grouped_scan_topk_plain(*args_k, k, "l2"), 1),
         in_bytes + gk.numel() * 8, 3.0 * flops, None,
         shape + f", kk {k}, position agreement {agree:.6f}",
         flop_rate=TF32_FLOP_PER_S,
         logged=dict(beside, bound_bytes_ms=(in_bytes + gk.numel() * 8)
                     / HBM_BYTES_PER_S * 1e3))
    del pgk, pgp, gk, gp

    # select_k on the same batch's bin rows: merge_bin_results' per-slot
    # cut, one [256] row per live pair
    cut = sk.reshape(-1, K.LUT_SCAN_BINS)[
        (pair_seg.long() * seg + pair_slot.long()).reshape(-1)]
    _select_k_row(rows, "ivf_flat", launches, cut, k,
                  ", the bin rows of n_probes 32")
    # fused_l2_argmin at the build's last k-means sweeps: the trainset
    # against all 1024 centers
    frac = ivf_flat.IndexParams().kmeans_trainset_fraction
    n_train = min(N, max(1024 * 4, int(N * frac)))
    tr = np.sort(np.random.default_rng(args.seed).choice(N, n_train,
                                                         replace=False))
    _argmin_row(rows, "ivf_flat", launches,
                base[torch.as_tensor(tr, device=base.device)],
                index.centers.contiguous(), "(trainset x centers) ")

    # select_k against the stable sort at the path's other short rows
    coarse = ivf_flat._coarse_distances(queries, index.centers, mt)[0]
    c_sq = (index.centers * index.centers).sum(1)
    # predict_topk's row tile of the build's [tile, n_lists] Gram
    tile = max(1024, min(N, (256 << 20) // (4 * index.n_lists)))
    shapes = {"coarse_probes_16": (coarse, 16),
              "coarse_probes_32": (coarse, 32),
              "coarse_probes_64": (coarse, 64),
              "coarse_probes_batch10": (coarse[:10].contiguous(), 32),
              "coarse_probes_batch1": (coarse[:1].contiguous(), 32),
              "merge_query_cut": (K.select_k_plain(cut, k)[0].reshape(
                  nq, n_probes * k), k),
              "predict_topk_tile": ((c_sq[None, :] - 2.0 * (
                  base[:tile] @ index.centers.T)).contiguous(),
                  ivf_common.SPILL_DEPTH)}
    sel_ms = {}
    for name, (scores, kq) in shapes.items():
        ms, sort_ms = _select_k_check(scores, kq)
        sel_ms[name] = {"shape": list(scores.shape), "k": kq,
                        "kernel_ms": ms, "sort_ms": sort_ms}
    _log(f"[flat select_k] kernel against the stable sort, values and "
         f"positions equal: {json.dumps(sel_ms)}")
    del cut, coarse, shapes, scores

    # where one approx batch's time goes (n_probes 32), each stage alone
    stages_ms = {
        "coarse_probes": _timed(lambda: ivf_flat._probes(
            index, queries, n_probes, mt), 10),
        "segment_probes": _timed(lambda: ivf_common.segment_probes(
            probes, index.n_lists, seg, n_seg), 10),
        "segmented_scan": scan_ms,
        "merge_bin_results": _timed(lambda: ivf_common.merge_bin_results(
            sk, si_, pair_seg, pair_slot, k, True, float("inf")), 5),
        "search_total": _timed(lambda: ivf_flat.search(
            index, queries, k, sp(32, "approx")), 3),
    }
    _log(f"[flat stages] one approx batch of {nq} queries at n_probes 32, "
         f"ms: {json.dumps(stages_ms)}")
    bin_bytes = {p: ivf_common.n_segments(nq * p, index.n_lists, seg) * seg
                 * K.LUT_SCAN_BINS * 8 for p in (16, 32, 64, 128)}
    resil = flat_resilient_leg(index, queries, k)
    del sk, si_, pair_seg, pair_slot
    uint8 = flat_uint8_leg(args, rows, index, base, queries)
    data = {"base": base, "queries": queries, "gt": gt}
    return data, {"n": N, "dim": dim, "n_lists": 1024, "max_list_size": L,
            "dropped_rows": dropped, "build_s": build_s,
            "build_stages_s": stages,
            "qps": {name: leg["qps"] for name, leg in legs.items()},
            "small_batch_ms": {bsz: lat for bsz, (_, lat) in small.items()},
            "recall_at_10": recall, "recall_plain_200": plain_rec,
            "bin_table_bytes": bin_bytes, "batch_stages_ms": stages_ms,
            "select_k_ms": sel_ms, "launches": launches,
            "filter": filt_summary, "resilient": resil, "uint8": uint8,
            "grouped_off_recall": grouped_off}


def _index_bytes(index) -> int:
    """Bytes of an IVF-Flat index's arrays on the card."""
    return sum(t.numel() * t.element_size() for t in (
        index.centers, index.packed_data, index.packed_ids,
        index.packed_norms, index.list_sizes))


def _scan_rows(rows, path, launches, seg_list, seg_q, q, packed, ids,
               sizes, k, key_of, shape):
    """B5 and B6 against their plain versions on one segment table over
    ``packed`` lists (any row type the kernels take), checked by
    ``_check_scan`` with ``key_of(si, sj, picks_b5, picks_b6)`` giving the
    f64 keys of the picks; then their rows. The bound: the probed lists'
    real rows at the lists' bytes a value (and a 4-byte id), the queries
    and tables, the output; ⟨q, x⟩ as two TF32 products per (live pair,
    real row) for 2- and 1-byte rows, three for f32."""
    import torch

    from raft_tpu_torch.ops import kernels as K

    args_k = (seg_list, seg_q, q, packed, ids)
    dim = q.shape[1]
    live = seg_q >= 0
    lists = torch.unique(seg_list[live.any(1)].long())
    rows_real = int(sizes[lists].sum())
    pair_rows = int((live.sum(1).long() * sizes[seg_list.long()]).sum())
    products = 3.0 if packed.dtype == torch.float32 else 2.0
    flops = products * 2.0 * dim * pair_rows
    in_bytes = (rows_real * (dim * packed.element_size() + 4)
                + q.numel() * 4 + seg_list.numel() * 4 + seg_q.numel() * 4)
    shape = (f"{shape}{str(packed.dtype)[6:]} lists: n_seg "
             f"{seg_list.numel()} x {seg_q.shape[1]} slots "
             f"({int(live.sum())} live), L {packed.shape[1]}, "
             f"{lists.numel()} lists of {rows_real} real rows, d {dim}")
    sk, si_ = K.segmented_scan_topk(*args_k, "l2")
    spk, spi = K.segmented_scan_topk_plain(*args_k, "l2")
    err, agree = _check_scan(f"segmented_scan_topk ({path})", sk, si_, spk,
                             spi, seg_q, q,
                             lambda a, b, picks: key_of(a, b, picks, None))
    del spk, spi
    beside = dict(bound_bytes_ms=in_bytes / HBM_BYTES_PER_S * 1e3)
    _row(rows, path, "segmented_scan_topk", "segmented_scan.cu", 397,
         launches["segmented_scan_topk"], err,
         _timed(lambda: K.segmented_scan_topk(*args_k, "l2"), 5),
         _timed(lambda: K.segmented_scan_topk_plain(*args_k, "l2"), 1),
         in_bytes + sk.numel() * 8, flops, None,
         shape + f", id agreement {agree:.6f}", flop_rate=TF32_FLOP_PER_S,
         logged=beside)
    del sk, si_
    gk, gp = K.grouped_scan_topk(*args_k, k, "l2")
    pgk, pgp = K.grouped_scan_topk_plain(*args_k, k, "l2")
    err, agree = _check_scan(f"grouped_scan_topk ({path})", gk, gp, pgk,
                             pgp, seg_q, q,
                             lambda a, b, picks: key_of(a, b, None, picks))
    del pgk, pgp
    _row(rows, path, "grouped_scan_topk", "grouped_scan.cu", 281,
         launches["grouped_scan_topk"], err,
         _timed(lambda: K.grouped_scan_topk(*args_k, k, "l2"), 5),
         _timed(lambda: K.grouped_scan_topk_plain(*args_k, k, "l2"), 1),
         in_bytes + gk.numel() * 8, flops, None,
         shape + f", kk {k}, position agreement {agree:.6f}",
         flop_rate=TF32_FLOP_PER_S, logged=beside)


def flat_uint8_leg(args, rows, index_f32, base, queries):
    """``[flat uint8]`` (ROADMAP A19): the IVF-Flat phase's 1M x 128 hard
    set cast to uint8 by one affine map of its value range (uint8 is
    SIFT's and BIGANN's own type), the queries through the same map, and
    ``ivf_flat.n1024`` (bench.py:194-210: 1024 lists, spill, cap 1.5)
    built on the bytes. Counts zeroed before the build and read after the
    last search (fused_l2_argmin, select_k and both scans must launch).
    Legs at batch 10,000: approx at n_probes 16/32/64/128 (the segmented
    scan over uint8 lists), exact at 32 (the grouped scan), exact at 32
    filtered at selectivity 0.1 (``bench_keep``), each with QPS and
    recall@10 against exact ``brute_force.knn`` on the uint8 values as f32
    (filtered: with the bitset); the f32 cell's rules: exact grouped
    within 0.002 of per_query, approx recall not falling as n_probes
    rises, no cleared id returned. Then B5 and B6 against their plain
    versions on the n_probes 32 segment table (rows ``ivf_flat_uint8``),
    and the index's bytes against the f32 index's. Raises SmokeFailure;
    returns the summary."""
    import torch

    from raft_tpu_torch.core import bitset
    from raft_tpu_torch.neighbors import brute_force, ivf_common, ivf_flat
    from raft_tpu_torch.ops import kernels as K

    t_leg = time.perf_counter()
    N, dim = base.shape
    nq, k, n_gt = queries.shape[0], 10, 1000
    lo, hi = float(base.min()), float(base.max())
    scale = 255.0 / (hi - lo)

    def to_u8(x):
        return ((x - lo) * scale).round().clamp(0, 255).to(torch.uint8)

    base8 = to_u8(base)
    q8 = to_u8(queries).float()
    _, gt = brute_force.knn_arrays(base8.float(), q8[:n_gt], k,
                                   metric="sqeuclidean")
    gt = gt.cpu()
    K.reset_launch_counts()
    stages = {}
    t0 = time.perf_counter()
    index = ivf_flat.build(base8, ivf_flat.IndexParams(
        n_lists=1024, spill=True, list_size_cap_factor=1.5, seed=args.seed),
        stage_seconds=stages)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if index.packed_data.dtype != torch.uint8:
        raise SmokeFailure(f"[flat uint8]: lists kept as "
                           f"{index.packed_data.dtype}")

    def sp(n_probes, select, mode="grouped"):
        return ivf_flat.SearchParams(n_probes=n_probes, scan_mode=mode,
                                     scan_select=select)

    def timed(params, q, fb=None):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ivf_flat.search(index, q, k, params, filter_bitset=fb)
        end.record()
        torch.cuda.synchronize()
        return out[1].cpu(), start.elapsed_time(end) / 1e3

    keep = bench_keep(N, 0.1, k)
    bits = bitset.from_mask(keep, device=base.device)
    _, fgt = brute_force.knn(brute_force.build(base8.float(), "sqeuclidean"),
                             q8[:n_gt], k, filter_bitset=bits)
    fgt = fgt.cpu()
    legs = {}
    for name, params, fb, truth in (
            [(f"approx_{p}", sp(p, "approx"), None, gt)
             for p in (16, 32, 64, 128)]
            + [("exact_32", sp(32, "exact"), None, gt),
               ("exact_32_filtered_0.1", sp(32, "exact"), bits, fgt)]):
        secs = []
        for _ in range(2):
            ids, t = timed(params, q8, fb)
            secs.append(t)
        if ids.shape != (nq, k):
            raise SmokeFailure(f"[flat uint8] {name}: malformed id table")
        legs[name] = {"qps": [nq / t for t in secs],
                      "recall_at_10": _recall(ids[:n_gt], truth)}
        if fb is not None:
            legs[name]["empty_slots"] = _check_kept(ids, keep,
                                                    f"[flat uint8] {name}")
        elif bool((ids < 0).any()):
            raise SmokeFailure(f"[flat uint8] {name}: empty slots")
    launches = K.launch_counts()
    ids_pq, _ = timed(sp(32, "approx", "per_query"), q8[:n_gt])
    rec_pq = _recall(ids_pq, gt)
    for name, leg in legs.items():
        _log(f"[flat uint8] {name}: QPS "
             + ", ".join(f"{x:.0f}" for x in leg["qps"])
             + f" (batch {nq}, CUDA events); recall@10 "
             f"{leg['recall_at_10']:.4f}")
    b8, b32 = _index_bytes(index), _index_bytes(index_f32)
    _log(f"[flat uint8] build {build_s:.2f} s (" + ", ".join(
        f"{s_} {v:.2f}s" for s_, v in stages.items())
        + f"); L = {index.max_list_size}; dropped rows {N - index.size}; "
        f"per_query n_probes 32 recall@10 {rec_pq:.4f}; index "
        f"{b8 / 1e9:.3f} GB against the f32 index's {b32 / 1e9:.3f} GB; "
        f"launches {json.dumps(launches)}")
    missing = [n for n in FLAT_KERNELS if launches[n] == 0]
    if missing:
        raise SmokeFailure(f"[flat uint8]: kernels never launched: {missing}")
    if abs(legs["exact_32"]["recall_at_10"] - rec_pq) > 0.002:
        raise SmokeFailure(f"[flat uint8]: exact grouped recall "
                           f"{legs['exact_32']['recall_at_10']} vs per_query "
                           f"{rec_pq}")
    curve = [legs[f"approx_{p}"]["recall_at_10"] for p in (16, 32, 64, 128)]
    if any(b < a for a, b in zip(curve, curve[1:])):
        raise SmokeFailure(f"[flat uint8]: approx recall falls as n_probes "
                           f"rises: {curve}")

    # B5 and B6 on the n_probes 32 segment table over the uint8 lists
    n_probes, seg = 32, ivf_common.SEGMENT_SIZE
    mt = ivf_flat.resolve_metric(index.metric)
    probes = ivf_flat._probes(index, q8, n_probes, mt)
    n_seg = ivf_common.n_segments(nq * n_probes, index.n_lists, seg)
    seg_list, seg_q, _, _ = ivf_common.segment_probes(
        probes, index.n_lists, seg, n_seg)
    qrow = seg_q.clamp_min(0).long()
    lst_of = seg_list.long()

    def key_of(si, sj, picks5, picks6):
        qv = q8[qrow[si, sj]].double()
        x = (base8[picks5.long()] if picks5 is not None
             else index.packed_data[lst_of[si], picks6.long()]).double()
        return ((qv - x) ** 2).sum(1)

    _scan_rows(rows, "ivf_flat_uint8", launches, seg_list, seg_q, q8,
               index.packed_data, index.packed_ids, index.list_sizes.long(),
               k, key_of, "")
    del index, base8, q8
    torch.cuda.empty_cache()
    return {"build_s": build_s, "build_stages_s": stages, "legs": legs,
            "recall_per_query_32": rec_pq, "index_bytes": b8,
            "f32_index_bytes": b32, "affine": [lo, scale],
            "launches": launches, "seconds": time.perf_counter() - t_leg}


def flat_filter_leg(index, index_cpu, base, queries, k, nq, n_gt, n_pl):
    """IVF-Flat filtered (ROADMAP A6), on the IVF-Flat phase's index, the
    bench's keep mask at selectivity 0.1: the exact leg at n_probes 32
    (the grouped scan over the id table with the cleared ids set to −1:
    B6 must launch) and the approx leg at n_probes 32 (the plain grouped
    tier: the segmented scan declines filtered searches, as in the JAX
    package, so B5 must not launch), two passes each with the counts
    zeroed before the legs and read after. Checks: no returned id has
    its bit clear; recall@10 against the filtered ground truth; the exact
    leg within 0.002 of the filtered per_query tier; the exact leg's
    kernel path no more than 0.01 below the plain path on n_pl queries.
    Raises SmokeFailure; returns the summary."""
    import torch

    from raft_tpu_torch.core import bitset
    from raft_tpu_torch.neighbors import brute_force, ivf_flat
    from raft_tpu_torch.ops import kernels as K

    N, sel = base.shape[0], 0.1
    keep = bench_keep(N, sel, k)
    bits = bitset.from_mask(keep, device=base.device)
    _, fgt = brute_force.knn(brute_force.build(base, "sqeuclidean"),
                             queries[:n_gt], k, filter_bitset=bits)
    fgt = fgt.cpu()

    def timed_search(params, q):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ivf_flat.search(index, q, k, params, filter_bitset=bits)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / 1e3

    legs, launches = {}, {}
    for select in ("exact", "approx"):
        params = ivf_flat.SearchParams(n_probes=32, scan_mode="grouped",
                                       scan_select=select)
        K.reset_launch_counts()
        secs = []
        for _ in range(2):
            (_, ids), t = timed_search(params, queries)
            secs.append(t)
        launches[select] = K.launch_counts()
        ids = ids.cpu()
        n_empty = _check_kept(ids, keep, f"filtered IVF-Flat {select}")
        legs[select] = {"qps": [nq / t for t in secs],
                        "recall_at_10": _recall(ids[:n_gt], fgt),
                        "empty_slots": n_empty}
        legs[select]["ids"] = ids
    if launches["exact"]["grouped_scan_topk"] != 2:
        raise SmokeFailure(f"filtered exact leg: the grouped scan launched "
                           f"{launches['exact']['grouped_scan_topk']} times "
                           f"for 2 searches")
    if launches["approx"]["segmented_scan_topk"] != 0:
        raise SmokeFailure("filtered approx leg launched the segmented scan, "
                           "which declines filtered searches")
    (_, ids_pq), _ = timed_search(ivf_flat.SearchParams(
        n_probes=32, scan_mode="per_query"), queries[:n_gt])
    rec_pq = _recall(ids_pq.cpu(), fgt)
    _check_kept(ids_pq.cpu(), keep, "filtered IVF-Flat per_query")
    _, ids_pl = ivf_flat.search(index_cpu, queries[:n_pl].cpu(), k,
                                ivf_flat.SearchParams(n_probes=32,
                                                      scan_mode="grouped",
                                                      scan_select="exact"),
                                filter_bitset=bits.cpu(), device="cpu")
    rec_plain = _recall(ids_pl, fgt[:n_pl])
    rec_kern = _recall(legs["exact"]["ids"][:n_pl], fgt[:n_pl])
    for select, leg in legs.items():
        tier = ("the grouped scan over the masked id table" if select ==
                "exact" else "the plain grouped tier")
        _log(f"[flat filter] {select} n_probes 32, selectivity {sel} "
             f"({int(keep.sum())} of {N} rows kept; {tier}): QPS "
             + ", ".join(f"{x:.0f}" for x in leg["qps"])
             + f" (batch {nq}, CUDA events); recall@10 "
             f"{leg['recall_at_10']:.4f} against the filtered ground truth; "
             f"{leg['empty_slots']} empty slots; launches "
             f"{json.dumps(launches[select])}")
        del leg["ids"]
    _log(f"[flat filter] per_query tier n_probes 32 filtered: recall@10 "
         f"{rec_pq:.4f}; exact leg on {n_pl} queries: kernel path "
         f"{rec_kern:.4f}, plain path (CPU) {rec_plain:.4f}")
    if abs(legs["exact"]["recall_at_10"] - rec_pq) > 0.002:
        raise SmokeFailure(f"filtered exact grouped recall "
                           f"{legs['exact']['recall_at_10']} vs per_query "
                           f"{rec_pq}")
    if not rec_kern >= rec_plain - 0.01:
        raise SmokeFailure(f"filtered exact kernel-path recall {rec_kern} "
                           f"more than 0.01 below the plain path's "
                           f"{rec_plain}")
    return {"selectivity": sel, "legs": legs, "recall_per_query": rec_pq,
            "recall_kernel_200": rec_kern, "recall_plain_200": rec_plain,
            "launches": launches}


def _check_chunked_index(index, n, dropped):
    """The built index holds every row once: valid ids in [0, n), none
    twice, each list's valid slots a prefix of length list_sizes[l], and
    the sum of list_sizes plus the dropped rows equal to n."""
    import torch

    ids = index.packed_ids
    sizes = index.list_sizes.long()
    slot = torch.arange(ids.shape[1], device=ids.device)
    if not torch.equal(ids >= 0, slot[None, :] < sizes[:, None]):
        raise SmokeFailure("chunked build: valid ids are not each list's "
                           "first list_sizes slots")
    got = ids[ids >= 0]
    total = int(sizes.sum())
    if got.numel() != total or total + dropped != n:
        raise SmokeFailure(f"chunked build: {total} rows in the lists, "
                           f"{dropped} dropped, of {n}")
    srt = torch.sort(got.long())[0]
    if int(srt[0]) < 0 or int(srt[-1]) >= n or bool(
            (srt[1:] == srt[:-1]).any()):
        raise SmokeFailure("chunked build: an id is out of [0, n) or "
                           "appears twice")
    del got, srt


def chunked_resume_check(args, params, chunk_rows):
    """A checkpointed build on the card, interrupted by an injected error
    at ``build.chunk_encode`` after two encoded chunks, then resumed, must
    equal an uninterrupted completion from the same quantizers bit for
    bit. Two card builds of one seed differ (the k-means centroid sums are
    ``index_add_`` atomics), so the reference resumes a second checkpoint
    that holds only the first one's trained quantizers and a manifest at
    phase ``label``, the state the build writes after its train phase:
    it runs the label pass and every encode itself."""
    import shutil
    import tempfile

    import torch

    from raft_tpu_torch.bench.dataset import DeviceSyntheticChunks
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.robust import checkpoint as ckpt
    from raft_tpu_torch.robust import faults

    n = CHUNKED_RESUME_N
    ds = DeviceSyntheticChunks(n, CHUNKED_DIM, n_centers=10_000,
                               seed=args.seed + 1, chunk_rows=chunk_rows,
                               device="cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chunked_ckpt_") as tmp:
        d1, d2 = os.path.join(tmp, "interrupted"), os.path.join(tmp, "ref")
        faults.install_plan({"faults": [{"site": "build.chunk_encode",
                                         "kind": "error", "after": 3}]})
        try:
            ivf_pq.build_chunked(ds, params, chunk_rows=chunk_rows,
                                 checkpoint_dir=d1)
            raise SmokeFailure("the injected build.chunk_encode fault did "
                               "not stop the checkpointed build")
        except faults.FaultInjected:
            pass
        finally:
            faults.clear_plan()
        man = ckpt.BuildCheckpoint(d1).load_manifest()
        if man["phase"] != "encode" or man["chunks_done"] != 2:
            raise SmokeFailure(f"interrupted build left phase "
                               f"{man['phase']}, {man['chunks_done']} chunks")
        os.makedirs(d2)
        shutil.copy(os.path.join(d1, "quantizers.npz"), d2)
        ckpt.BuildCheckpoint(d2).write_manifest(
            {**{k: v for k, v in man.items()
                if k not in ("phase", "L", "chunks_done", "schema")},
             "phase": "label"})
        resumed = ivf_pq.build_chunked(ds, params, chunk_rows=chunk_rows,
                                       checkpoint_dir=d1, resume=True)
        reference = ivf_pq.build_chunked(ds, params, chunk_rows=chunk_rows,
                                         checkpoint_dir=d2, resume=True)
    differ = [name for name in ivf_pq._ARRAY_FIELDS
              if not torch.equal(getattr(resumed, name),
                                 getattr(reference, name))]
    if differ:
        raise SmokeFailure(f"resumed chunked build differs from the "
                           f"uninterrupted one in {differ}")
    out = {"n": n, "chunks_replayed": man["chunks_done"],
           "n_chunks": man["n_chunks"], "L": resumed.max_list_size,
           "seconds": time.perf_counter() - t0}
    _log(f"[chunked resume] {n} x {CHUNKED_DIM}: a checkpointed build "
         f"stopped after {man['chunks_done']} of {man['n_chunks']} encode "
         f"chunks, resumed, equals the completion from its quantizers bit "
         f"for bit (all {len(ivf_pq._ARRAY_FIELDS)} arrays) "
         f"({out['seconds']:.1f} s)")
    return out


def chunked_phase(args, rows):
    """``[chunked]``: the main path at the DEEP-100M shape, built by
    ``ivf_pq.build_chunked`` on a ``DeviceSyntheticChunks`` provider in
    1M-row blocks (``tools/build_deep100m.py:40-50``'s parameters but the
    list cap: the package's 4 × the mean load, where the tool's 1.5 drops
    13 % of these rows to the spill and caps recall near 0.85;
    ``--chunked-cap`` exists only to reproduce that reading), then the
    bench's search (``tools/deep100m_r5.py:155,188``): the LUT scan at
    k_cand 400 and the exact re-rank by ``refine_provider``. Checks: the index holds every
    row once, recall@10 ≥ 0.95 against the streamed ground truth on 1,000
    queries, and B4, B3 and B1 launched on the path; then B4, B3 and B1
    against their plain versions at the path's shapes, and the resume
    check. Returns the summary."""
    import numpy as np
    import torch

    from raft_tpu_torch.bench.dataset import (Dataset, DeviceSyntheticChunks,
                                              compute_groundtruth)
    from raft_tpu_torch.neighbors import ivf_common, ivf_pq
    from raft_tpu_torch.neighbors import refine as trefine
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K

    N, dim, B, k, k_cand = CHUNKED_N, CHUNKED_DIM, 500, 10, 400
    nq, n_gt, chunk = args.queries, 1000, 1 << 20
    dev = torch.device("cuda", 0)
    ds = DeviceSyntheticChunks(N, dim, n_centers=10_000, seed=args.seed,
                               chunk_rows=chunk, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_gen = min(N, 4 * chunk)
    ds[0:n_gen]
    torch.cuda.synchronize()
    gen_rate = n_gen / (time.perf_counter() - t0)
    params = ivf_pq.IndexParams(n_lists=8192, pq_dim=64, pq_bits=8,
                                spill=True,
                                list_size_cap_factor=args.chunked_cap,
                                kmeans_n_iters=10, seed=args.seed)
    _log(f"[chunked data] DeviceSyntheticChunks {N} x {dim} f32 "
         f"({N * dim * 4 / 1e9:.1f} GB, never materialized), blocks of "
         f"{chunk} rows: the generator makes {gen_rate:.0f} rows/s")

    # the path: build, scan passes, re-rank; counts zeroed just before
    stages = {}
    drop_site = {"site": "ivf_pq.build_chunked"}
    drops0 = spans.total("ivf_pq.build.dropped", **drop_site)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    index = ivf_pq.build_chunked(ds, params, chunk_rows=chunk,
                                 progress=True, device=dev,
                                 stage_seconds=stages)
    torch.cuda.synchronize()
    dropped = int(spans.total("ivf_pq.build.dropped", **drop_site) - drops0)
    build_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    L = index.max_list_size
    codes_gb = index.packed_codes.numel() / 1e9
    # the lists' loads against the tool's cap of 1.5 × the mean load
    sizes = index.list_sizes.long()
    cap15 = ivf_common._lane_round(int(N // params.n_lists * 1.5))
    over = (sizes - cap15).clamp_min(0)
    _log(f"[chunked build] {build_s:.1f} s: " + ", ".join(
        f"{s} {v:.1f}s" for s, v in stages.items())
         + f"; cap factor {params.list_size_cap_factor}, L = {L}; codes "
         f"{codes_gb:.2f} GB; card peak {peak_gb:.2f} GB; rows dropped "
         f"{dropped}; largest list {int(sizes.max())} rows, "
         f"{int((over > 0).sum())} lists hold {int(over.sum())} rows past "
         f"1.5 x the mean load ({cap15})")
    _check_chunked_index(index, N, dropped)

    queries = ds.queries(nq)
    sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                             lut_dtype="bfloat16")

    def scan_pass():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        start.record()
        for a in range(0, nq, B):
            out.append(ivf_pq.search(index, queries[a:a + B], k_cand, sp)[1])
        end.record()
        torch.cuda.synchronize()
        return torch.cat(out), start.elapsed_time(end) / 1e3

    cand, t_scan = scan_pass()
    qps = [nq / t_scan] + [nq / scan_pass()[1] for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ids_r = trefine.refine_provider(ds, queries[:n_gt], cand[:n_gt], k,
                                       device=dev)
    torch.cuda.synchronize()
    rerank_s = time.perf_counter() - t0
    launches = K.launch_counts()
    _log(f"[chunked] launches {json.dumps(launches)}")
    missing = [n for n in ("fused_l2_argmin", "select_k",
                           "ivfpq_lut_scan_topk") if launches[n] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the chunked path: "
                           f"{missing}")

    t0 = time.perf_counter()
    gtds = compute_groundtruth(Dataset("deep100m-synth", ds, queries), k=k,
                               chunk_rows=chunk, max_queries=n_gt,
                               device=dev)
    gt_s = time.perf_counter() - t0
    gt = gtds.groundtruth
    cand_h = cand[:n_gt].cpu().numpy()
    rec = _recall(ids_r.cpu(), gt)
    rec_cand = _recall(cand_h[:, :k], gt)
    cover = float(np.mean([len(set(a) & set(b)) / k
                           for a, b in zip(cand_h, gt)]))
    _log(f"[chunked search] batch {B}, n_probes 64, bf16 LUT, k_cand "
         f"{k_cand}, unrefined scan of {nq} queries, three passes (CUDA "
         f"events): " + ", ".join(f"{x:.0f}" for x in qps) + " QPS; "
         f"re-rank of {n_gt} queries by refine_provider in {rerank_s:.2f} s;"
         f" recall@10 on {n_gt} queries against the streamed ground truth "
         f"({gt_s:.1f} s): re-ranked {rec:.4f}, candidates' first 10 "
         f"{rec_cand:.4f}, true top-10 among the {k_cand} candidates "
         f"{cover:.4f}")
    if not rec >= 0.95:
        raise SmokeFailure(f"chunked refined recall@10 {rec} < 0.95")

    # the path's kernels against their plain versions at its shapes: B4 at
    # the training sweep's shape (the first 2,097,152 rows: the sample's
    # shape), B3 at the label pass's Gram tile, B1 on the built index
    xa = ds[0:1 << 21].contiguous()
    _argmin_row(rows, "ivf_pq_chunked", launches, xa,
                index.centers.contiguous(), "training sweep shape, ")
    c_sq = (index.centers ** 2).sum(1)
    tile = (256 << 20) // (4 * params.n_lists)
    scores = (c_sq[None, :] - 2.0 * (xa[:tile] @ index.centers.T)
              ).contiguous()
    del xa
    _select_k_row(rows, "ivf_pq_chunked", launches, scores, 6,
                  " (the label pass's tile)")
    del scores
    torch.cuda.empty_cache()
    _lut_scan_row(rows, "ivf_pq_chunked", launches, index,
                  queries[:B].contiguous(), 64, "bfloat16",
                  f"{N} rows, ", plain_reps=1)
    del index, cand
    torch.cuda.empty_cache()
    resume = chunked_resume_check(args, params, chunk)
    return {"n": N, "dim": dim, "n_lists": 8192, "pq_dim": 64,
            "max_list_size": L, "build_s": build_s, "build_stages_s": stages,
            "generator_rows_per_s": gen_rate, "card_peak_gb": peak_gb,
            "rows_dropped": dropped, "scan_qps_runs": qps,
            "rerank_s": rerank_s, "recall_at_10": rec,
            "recall_at_10_candidates": rec_cand, "candidate_cover": cover,
            "groundtruth_s": gt_s, "launches": launches, "resume": resume}


def pq_recon_phase(args, rows, base, queries, gt):
    """IVF-PQ over its bf16 reconstruction cache: the repo's bench config
    ``ivf_pq.n1024.d64`` (bench.py:211-243) on the IVF-Flat phase's 1M x
    128 hard data. Build (1024 lists, pq_dim 64, spill, cap factor 1.5,
    the default cache rule), refined approx search (segmented scan over
    the cache) at n_probes 64 and 128 with refine_ratio 4, batch-10 and
    batch-1 legs at 64, a refined exact leg at 64 (the grouped scan over
    the cache, kk 40), and a twin built with cache_reconstruction="never"
    whose exact leg at 32 runs the plain grouped tier on codes decoded a
    chunk at a time. Counts are zeroed before the build and read after
    the twin's leg. Checks: recall@10 of every leg, approx recall not
    falling from 64 to 128, the exact leg within 0.01 of the approx leg
    at 64, and the kernel path no more than 0.01 below the plain path on
    200 queries; then B5 and B6 against their plain versions on the
    n_probes 64 segment table. Raises SmokeFailure; returns the summary."""
    import numpy as np
    import torch

    from raft_tpu_torch.neighbors import brute_force, ivf_common, ivf_pq
    from raft_tpu_torch.neighbors import refine as trefine
    from raft_tpu_torch.ops import kernels as K

    N, dim = base.shape
    nq, k, n_gt = queries.shape[0], 10, gt.shape[0]
    params = dict(n_lists=1024, pq_dim=64, spill=True,
                  list_size_cap_factor=1.5, seed=args.seed)

    def sp(n_probes, select, mode="auto"):
        return ivf_pq.SearchParams(n_probes=n_probes, scan_mode=mode,
                                   scan_select=select, refine="f32_regen",
                                   refine_ratio=4)

    def timed_search(idx, params_, q):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ivf_pq.search(idx, q, k, params_, dataset=base)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / 1e3

    # the path: the build, every leg and the twin; counts zeroed just before
    K.reset_launch_counts()
    stages = {}
    t0 = time.perf_counter()
    index = ivf_pq.build(base, ivf_pq.IndexParams(**params),
                         stage_seconds=stages)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if index.packed_recon is None:
        raise SmokeFailure("the default build made no recon cache")
    L = index.max_list_size
    recon_gb = index.packed_recon.numel() * 2 / 1e9
    _log(f"[pq build] ivf_pq.n1024.d64 on {N} x {dim}: {build_s:.2f} s ("
         + ", ".join(f"{s_} {v:.2f}s" for s_, v in stages.items())
         + f"); L = {L}; dropped rows {N - index.size}; bf16 recon cache "
         f"{list(index.packed_recon.shape)} = {recon_gb:.3f} GB")
    legs = {}
    for name, n_probes, select, passes in (("approx_64", 64, "approx", 2),
                                           ("approx_128", 128, "approx", 1),
                                           ("exact_64", 64, "exact", 2)):
        secs = []
        for _ in range(passes):
            (_, ids), t = timed_search(index, sp(n_probes, select), queries)
            secs.append(t)
        legs[name] = {"ids": ids.cpu(), "qps": [nq / t for t in secs]}
    small = {}
    for bsz, n_small in ((10, 200), (1, 50)):
        lat, out = [], []
        for a in range(0, n_small, bsz):
            (_, ids), t = timed_search(index, sp(64, "approx"),
                                       queries[a:a + bsz])
            lat.append(t * 1e3)
            out.append(ids)
        small[bsz] = (torch.cat(out).cpu(), lat)
    t0 = time.perf_counter()
    twin = ivf_pq.build(base, ivf_pq.IndexParams(
        **params, cache_reconstruction="never"))
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    secs = []
    for _ in range(2):
        (_, ids), t = timed_search(twin, sp(32, "exact", "grouped"), queries)
        secs.append(t)
    legs["never_exact_32"] = {"ids": ids.cpu(), "qps": [nq / t for t in secs]}
    del twin
    launches = K.launch_counts()
    _log(f"[pq] launches {json.dumps(launches)}")
    missing = [n for n in FLAT_KERNELS if launches[n] == 0]   # the same four
    if missing:
        raise SmokeFailure(f"kernels never launched on the IVF-PQ recon "
                           f"path: {missing}")
    for name, leg in legs.items():
        if leg["ids"].shape != (nq, k) or bool((leg["ids"] < 0).any()):
            raise SmokeFailure(f"IVF-PQ leg {name}: malformed id table")

    recall = {name: _recall(leg["ids"][:n_gt], gt)
              for name, leg in legs.items()}
    for bsz, (ids, lat) in small.items():
        recall[f"batch{bsz}_approx_64"] = _recall(ids, gt[:ids.shape[0]])
    for name, leg in legs.items():
        _log(f"[pq leg] {name}: QPS "
             + ", ".join(f"{x:.0f}" for x in leg["qps"])
             + f" (batch {nq}, refine_ratio 4, CUDA events; batch ms "
             + ", ".join(f"{nq / x * 1e3:.3f}" for x in leg["qps"])
             + f"); recall@10 {recall[name]:.4f}")
    for bsz, (ids, lat) in small.items():
        _log(f"[pq leg] batch {bsz}, approx n_probes 64 (per_query tier): "
             f"{len(lat)} calls, per call ms median {np.median(lat):.3f}, "
             f"min {min(lat):.3f}, max {max(lat):.3f}; recall@10 "
             f"{recall[f'batch{bsz}_approx_64']:.4f}")
    _log(f"[pq build] the cache_reconstruction='never' twin: {twin_s:.2f} s")
    if recall["approx_128"] < recall["approx_64"]:
        raise SmokeFailure(f"approx recall falls from n_probes 64 to 128: "
                           f"{recall['approx_64']} -> {recall['approx_128']}")
    if abs(recall["exact_64"] - recall["approx_64"]) > 0.01:
        raise SmokeFailure(f"exact recall {recall['exact_64']} is not within "
                           f"0.01 of approx {recall['approx_64']} at 64")

    # kernel path against the plain path: the same index on the CPU (the
    # cache rebuilt there from the codes), the same refined approx search
    n_pl = 200
    t0 = time.perf_counter()
    index_cpu = ivf_pq.from_numpy(*ivf_pq.to_numpy(index), device="cpu")
    t_cache = time.perf_counter() - t0
    base_cpu = base.cpu()
    _, ids_pl = ivf_pq.search(index_cpu, queries[:n_pl].cpu(), k,
                              sp(64, "approx", "grouped"),
                              dataset=base_cpu, device="cpu")
    rec_plain = _recall(ids_pl, gt[:n_pl])
    rec_kern = _recall(legs["approx_64"]["ids"][:n_pl], gt[:n_pl])
    _log(f"[pq recall] approx n_probes 64, {n_pl} queries: kernel path "
         f"{rec_kern:.4f}, plain path (CPU) {rec_plain:.4f} ("
         f"{time.perf_counter() - t0:.1f} s, {t_cache:.1f} s of it the "
         f"index and its cache on the CPU)")
    if not rec_kern >= rec_plain - 0.01:
        raise SmokeFailure(f"IVF-PQ recon kernel-path recall {rec_kern} more "
                           f"than 0.01 below the plain path's {rec_plain}")

    # [pq filter]: the bench config's filter legs (bench.py:228-238),
    # approx at n_probes 64, refine_ratio 4, at selectivity 0.01, 0.1, 0.5
    from raft_tpu_torch.core import bitset

    filt = {}
    for sel in (0.01, 0.1, 0.5):
        keep = bench_keep(N, sel, k)
        bits = bitset.from_mask(keep, device=base.device)
        _, fgt = brute_force.knn(brute_force.build(base, "sqeuclidean"),
                                 queries[:n_gt], k, filter_bitset=bits)
        fgt = fgt.cpu()
        K.reset_launch_counts()
        secs = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, ids = ivf_pq.search(index, queries, k, sp(64, "approx"),
                                   filter_bitset=bits, dataset=base)
            end.record()
            torch.cuda.synchronize()
            secs.append(start.elapsed_time(end) / 1e3)
        fl = K.launch_counts()
        if fl["segmented_scan_topk"] != 2 or fl["grouped_scan_topk"]:
            raise SmokeFailure(f"filtered recon leg at {sel} did not take "
                               f"the segmented scan over the masked id "
                               f"table: {fl}")
        ids = ids.cpu()
        n_empty = _check_kept(ids, keep, f"filtered recon leg at {sel}")
        rec = _recall(ids[:n_gt], fgt)
        line = (f"[pq filter] approx n_probes 64, refine_ratio 4, "
                f"selectivity {sel} ({int(keep.sum())} of {N} rows kept): "
                f"QPS " + ", ".join(f"{nq / t:.0f}" for t in secs)
                + f" (batch {nq}, CUDA events); recall@10 {rec:.4f} against "
                f"the filtered ground truth; {n_empty} empty slots; "
                f"launches {json.dumps(fl)}")
        filt[str(sel)] = {"qps": [nq / t for t in secs], "recall_at_10": rec,
                          "empty_slots": n_empty, "launches": fl}
        if sel == 0.1:
            _, ids_pl = ivf_pq.search(index_cpu, queries[:n_pl].cpu(), k,
                                      sp(64, "approx", "grouped"),
                                      filter_bitset=bits.cpu(),
                                      dataset=base_cpu, device="cpu")
            f_plain = _recall(ids_pl, fgt[:n_pl])
            f_kern = _recall(ids[:n_pl], fgt[:n_pl])
            line += (f"; {n_pl} queries: kernel path {f_kern:.4f}, plain "
                     f"path (CPU) {f_plain:.4f}")
            filt[str(sel)].update(recall_kernel_200=f_kern,
                                  recall_plain_200=f_plain)
            if not f_kern >= f_plain - 0.01:
                raise SmokeFailure(f"filtered recon kernel-path recall "
                                   f"{f_kern} more than 0.01 below the "
                                   f"plain path's {f_plain}")
        _log(line)
    del index_cpu, base_cpu

    # B5 and B6 on the n_probes 64 segment table over the bf16 cache
    n_probes, seg = 64, ivf_common.SEGMENT_SIZE
    _, probes = ivf_pq._coarse_probes(index, queries, n_probes, False)
    n_seg = ivf_common.n_segments(nq * n_probes, index.n_lists, seg)
    seg_list, seg_q, pair_seg, pair_slot = ivf_common.segment_probes(
        probes, index.n_lists, seg, n_seg)
    q_rot = (queries @ index.rotation.T).contiguous()
    rot = q_rot.shape[1]
    args_k = (seg_list, seg_q, q_rot, index.packed_recon, index.packed_ids)
    live = seg_q >= 0
    sizes = index.list_sizes.long()
    lists = torch.unique(seg_list[live.any(1)].long())
    rows_real = int(sizes[lists].sum())
    n_live = int(live.sum())
    pair_rows = int((live.sum(1).long() * sizes[seg_list.long()]).sum())
    # the bf16 design: two TF32 products per (live pair, real row), and
    # the cache's real rows at 2 bytes a feature
    flops = 2.0 * 2.0 * rot * pair_rows
    in_bytes = (rows_real * (rot * 2 + 4) + q_rot.numel() * 4
                + seg_list.numel() * 4 + seg_q.numel() * 4)
    shape = (f"bf16 recon cache: n_seg {n_seg} x {seg} slots ({n_live} "
             f"live), L {L}, {lists.numel()} lists of {rows_real} real rows, "
             f"d {rot}")
    qrow = seg_q.clamp_min(0).long()
    flat_recon = index.packed_recon.view(-1, rot)
    valid = index.packed_ids.view(-1) >= 0
    slot_of = torch.full((N,), -1, dtype=torch.long, device=base.device)
    slot_of[index.packed_ids.view(-1)[valid].long()] = torch.nonzero(
        valid).flatten()

    def l2_key64(si, sj, xrow):
        qv = q_rot[qrow[si, sj]].double()
        return ((qv - xrow.double()) ** 2).sum(1)

    sk, si_ = K.segmented_scan_topk(*args_k, "l2")
    spk, spi = K.segmented_scan_topk_plain(*args_k, "l2")
    err, agree = _check_scan(
        "segmented_scan_topk (recon)", sk, si_, spk, spi, seg_q, q_rot,
        lambda a, b, picks: l2_key64(a, b, flat_recon[slot_of[picks.long()]]))
    beside = dict(bound_bytes_ms=in_bytes / HBM_BYTES_PER_S * 1e3)
    _row(rows, "ivf_pq_recon", "segmented_scan_topk", "segmented_scan.cu",
         397, launches["segmented_scan_topk"], err,
         _timed(lambda: K.segmented_scan_topk(*args_k, "l2"), 5),
         _timed(lambda: K.segmented_scan_topk_plain(*args_k, "l2"), 1),
         in_bytes + sk.numel() * 8, flops, None,
         shape + f", id agreement {agree:.6f}", flop_rate=TF32_FLOP_PER_S,
         logged=beside)
    scan_ms = rows[-1]["ms"]
    del spk, spi
    kk = 4 * k
    gk, gp = K.grouped_scan_topk(*args_k, kk, "l2")
    pgk, pgp = K.grouped_scan_topk_plain(*args_k, kk, "l2")
    lst_of = seg_list.long()
    err, agree = _check_scan(
        "grouped_scan_topk (recon)", gk, gp, pgk, pgp, seg_q, q_rot,
        lambda a, b, picks: l2_key64(
            a, b, index.packed_recon[lst_of[a], picks.long()]))
    _row(rows, "ivf_pq_recon", "grouped_scan_topk", "grouped_scan.cu", 281,
         launches["grouped_scan_topk"], err,
         _timed(lambda: K.grouped_scan_topk(*args_k, kk, "l2"), 5),
         _timed(lambda: K.grouped_scan_topk_plain(*args_k, kk, "l2"), 1),
         in_bytes + gk.numel() * 8, flops, None,
         shape + f", kk {kk}, position agreement {agree:.6f}",
         flop_rate=TF32_FLOP_PER_S, logged=beside)
    del pgk, pgp, gk, gp, slot_of

    # where one approx batch's time goes (n_probes 64, k_cand 40), each
    # stage alone (CUDA events)
    sp_scan = ivf_pq.SearchParams(n_probes=64, scan_mode="grouped",
                                  scan_select="approx")
    _, cand = ivf_pq.search(index, queries, 4 * k, sp_scan)
    stages_ms = {
        "coarse_probes": _timed(lambda: ivf_pq._coarse_probes(
            index, queries, n_probes, False), 10),
        "segment_probes": _timed(lambda: ivf_common.segment_probes(
            probes, index.n_lists, seg, n_seg), 10),
        "rotate": _timed(lambda: queries @ index.rotation.T, 10),
        "segmented_scan": scan_ms,
        "merge_bin_results": _timed(lambda: ivf_common.merge_bin_results(
            sk, si_, pair_seg, pair_slot, 4 * k, True, float("inf")), 5),
        "refine": _timed(lambda: trefine.refine(base, queries, cand, k), 5),
        "search_total": _timed(lambda: ivf_pq.search(
            index, queries, k, sp(64, "approx", "grouped"), dataset=base), 3),
    }
    _log(f"[pq stages] one refined approx batch of {nq} queries at n_probes "
         f"64, ms: {json.dumps(stages_ms)}")
    dropped = N - index.size
    del index, cand, sk, si_
    torch.cuda.empty_cache()
    per_cluster = pq_per_cluster_leg(args, base, queries, gt, params, recall)
    return {"n": N, "dim": dim, "n_lists": 1024, "pq_dim": 64,
            "max_list_size": L, "dropped_rows": dropped,
            "recon_cache_gb": recon_gb, "build_s": build_s,
            "build_stages_s": stages, "twin_build_s": twin_s,
            "qps": {name: leg["qps"] for name, leg in legs.items()},
            "small_batch_ms": {bsz: lat for bsz, (_, lat) in small.items()},
            "recall_at_10": recall, "recall_kernel_200": rec_kern,
            "recall_plain_200": rec_plain, "batch_stages_ms": stages_ms,
            "launches": launches, "filter": filt, "per_cluster": per_cluster}


def pq_per_cluster_leg(args, base, queries, gt, params, recall_subspace):
    """``[pq per_cluster]`` (ROADMAP A9): the recon cell's config
    (``ivf_pq.n1024.d64``, bench.py:211-243: 1024 lists, pq_dim 64, spill,
    cap factor 1.5, refine_ratio 4) with ``codebook_kind="per_cluster"``
    on the same 1M x 128 hard set, nothing cut. Counts zeroed before the
    build and read after the last leg. Prints the build's seconds by stage
    with ``_train_per_cluster`` timed on its own, refined approx search at
    n_probes 64 and 128 (the segmented scan over the bf16 cache), the
    refined exact leg at 64 (the grouped scan over it), and
    ``scan_select="pallas"`` at 64, which the LUT-scan kernel declines
    (``ivf_pq.scan.fallback{reason=per_cluster}`` must count, B1 must not
    launch), each with QPS and recall@10 beside the per_subspace index's
    (``recall_subspace``). Checks: the per_subspace cell's rules (the
    exact leg within 0.01 of approx at 64, approx not falling from 64 to
    128), both scans launched, and 100 queries searched unrefined (approx,
    n_probes 64) on the card equal to the same index on the CPU but at
    ties of their f64 distances to the cache rows
    (``bench.dataset.tie_swaps``). Raises SmokeFailure; returns the
    summary."""
    import warnings

    import torch

    from raft_tpu_torch.bench.dataset import tie_swaps
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K

    N, dim = base.shape
    nq, k, n_gt = queries.shape[0], 10, gt.shape[0]
    t_leg = time.perf_counter()
    train_s = []
    trainer = ivf_pq._train_per_cluster

    def timed_trainer(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer(*a, **kw)
        torch.cuda.synchronize()
        train_s.append(time.perf_counter() - t0)
        return out

    spans.reset()
    K.reset_launch_counts()
    stages = {}
    ivf_pq._train_per_cluster = timed_trainer
    try:
        t0 = time.perf_counter()
        index = ivf_pq.build(base, ivf_pq.IndexParams(
            **params, codebook_kind="per_cluster"), stage_seconds=stages)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        ivf_pq._train_per_cluster = trainer
    if index.packed_recon is None or tuple(index.codebooks.shape) != (
            params["n_lists"], 256, dim // params["pq_dim"]):
        raise SmokeFailure(f"[pq per_cluster]: codebooks "
                           f"{list(index.codebooks.shape)}, recon cache "
                           f"{index.packed_recon is not None}")
    _log(f"[pq per_cluster] build {build_s:.2f} s (" + ", ".join(
        f"{s_} {v:.2f}s" for s_, v in stages.items())
        + f"; _train_per_cluster {train_s[0]:.2f}s of train); L = "
        f"{index.max_list_size}; dropped rows {N - index.size}; codebooks "
        f"{list(index.codebooks.shape)}")

    def sp(n_probes, select, refine="f32_regen"):
        return ivf_pq.SearchParams(n_probes=n_probes, scan_select=select,
                                   refine=refine, refine_ratio=4)

    legs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # the pallas leg's
        for name, n_probes, select in (("approx_64", 64, "approx"),
                                       ("approx_128", 128, "approx"),
                                       ("exact_64", 64, "exact"),
                                       ("pallas_64", 64, "pallas")):
            secs = []
            for _ in range(2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _, ids = ivf_pq.search(index, queries, k, sp(n_probes, select),
                                       dataset=base)
                end.record()
                torch.cuda.synchronize()
                secs.append(start.elapsed_time(end) / 1e3)
            ids = ids.cpu()
            if ids.shape != (nq, k) or bool((ids < 0).any()):
                raise SmokeFailure(f"[pq per_cluster] {name}: malformed ids")
            legs[name] = {"qps": [nq / t for t in secs],
                          "recall_at_10": _recall(ids[:n_gt], gt)}
    launches = K.launch_counts()
    fallback = spans.total("ivf_pq.scan.fallback", reason="per_cluster")
    for name, leg in legs.items():
        _log(f"[pq per_cluster] {name}: QPS "
             + ", ".join(f"{x:.0f}" for x in leg["qps"])
             + f" (batch {nq}, refine_ratio 4, CUDA events); recall@10 "
             f"{leg['recall_at_10']:.4f} (per_subspace "
             f"{recall_subspace.get(name, float('nan')):.4f})")
    _log(f"[pq per_cluster] launches {json.dumps(launches)}; "
         f"ivf_pq.scan.fallback{{reason=per_cluster}} {fallback}")
    if launches["ivfpq_lut_scan_topk"] or fallback < 1:
        raise SmokeFailure(f"[pq per_cluster]: the LUT-scan kernel was not "
                           f"declined (launches {launches}, fallback "
                           f"{fallback})")
    if not (launches["segmented_scan_topk"] and launches["grouped_scan_topk"]):
        raise SmokeFailure(f"[pq per_cluster]: the scans over the cache did "
                           f"not both launch: {launches}")
    r = {name: leg["recall_at_10"] for name, leg in legs.items()}
    if r["approx_128"] < r["approx_64"]:
        raise SmokeFailure(f"[pq per_cluster]: approx recall falls from 64 "
                           f"to 128: {r}")
    if abs(r["exact_64"] - r["approx_64"]) > 0.01:
        raise SmokeFailure(f"[pq per_cluster]: exact recall not within 0.01 "
                           f"of approx at 64: {r}")

    # 100 queries on the card against the same index on the CPU
    t0 = time.perf_counter()
    n_cmp = 100
    q_cmp = queries[:n_cmp]
    index_cpu = ivf_pq.from_numpy(*ivf_pq.to_numpy(index), device="cpu")
    sp_cmp = sp(64, "approx", "none")
    d_c, i_c = ivf_pq.search(index, q_cmp, k, sp_cmp)
    d_p, i_p = ivf_pq.search(index_cpu, q_cmp.cpu(), k, sp_cmp, device="cpu")
    # the f64 distances are to the cache rows, in the rotated space
    rot = index.rot_dim
    valid = index.packed_ids.view(-1) >= 0
    by_id = torch.zeros((N, rot), device=base.device)
    by_id[index.packed_ids.view(-1)[valid].long()] = \
        index.packed_recon.view(-1, rot)[valid].float()
    try:
        swaps = tie_swaps(q_cmp @ index.rotation.T, by_id, i_c, d_c, i_p, d_p)
    except ValueError as e:
        raise SmokeFailure(f"[pq per_cluster] card vs CPU: {e}") from e
    _log(f"[pq per_cluster] {n_cmp} queries (approx, n_probes 64, "
         f"unrefined): the card's ids = the CPU's but at f64 ties ({swaps} "
         f"swapped slots; {time.perf_counter() - t0:.1f} s)")
    del index, index_cpu, by_id
    torch.cuda.empty_cache()
    return {"build_s": build_s, "build_stages_s": stages,
            "train_per_cluster_s": train_s[0], "legs": legs,
            "recall_per_subspace": {n: recall_subspace.get(n) for n in legs},
            "launches": launches, "fallback_per_cluster": fallback,
            "card_cpu_swaps": swaps, "seconds": time.perf_counter() - t_leg}


def _ring_topk_row(rows, path, launches, vals, gids, k, shape):
    """ring_topk_merge against its plain version (the plain ring schedule,
    on the same card) on per-rank [m, k] tables: values and ids equal;
    then its row. The library column is torch.topk over the [n·mc, 2k]
    incoming ++ local blocks of every rank, one call a hop."""
    import torch

    from raft_tpu_torch.ops import kernels as K

    n = len(vals)
    m, kin = vals[0].shape
    mc = K.ring_chunk_rows(m, n)
    kv, ki = K.ring_topk_merge(vals, gids, k)
    prep = [K._ring_keys(v, i, mc * n, True) for v, i in zip(vals, gids)]
    keys = [p[0] for p in prep]
    tids = [p[1] for p in prep]
    pv, pi = K.ring_topk_merge_plain(keys, tids, k, mc)
    for r in range(n):
        if not (torch.equal(kv[r], pv[r]) and torch.equal(ki[r], pi[r])):
            raise SmokeFailure(f"ring_topk_merge differs from its plain "
                               f"version on rank {r} ({shape})")
    cat = torch.cat([torch.cat([pv[r], keys[r][:mc, :k]], 1)
                     for r in range(n)]).contiguous()
    # each rank's table read once, the [n, mc, k] result written once
    nbytes = n * m * kin * 8 + n * mc * k * 8
    _row(rows, path, "ring_topk_merge", "ring_topk.cu", 1581,
         launches["ring_topk_merge"], 0.0,
         _timed_best(lambda: K.ring_topk_merge(vals, gids, k), 100),
         _timed(lambda: K.ring_topk_merge_plain(keys, tids, k, mc), 5),
         nbytes, 0.0,
         _timed_best(lambda: [torch.topk(cat, k, largest=False)
                              for _ in range(n - 1)], 100),
         f"{n} ranks of [{m},{kin}] tables, mc {mc}, k {k}, one launch a "
         f"call ({shape})")


def _adc_key64(index, qv_row, gid):
    """f64 ADC key (‖c+d‖² − 2⟨q, c+d⟩) of global id ``gid`` for the
    rotated query ``qv_row``, found in whichever shard holds it."""
    import torch

    from raft_tpu_torch.ops import kernels as K

    for r in range(index.n_shards):
        hit = torch.nonzero(index.packed_ids[r] == int(gid))
        if hit.shape[0]:
            lst, pos = int(hit[0, 0]), int(hit[0, 1])
            code = K.unpack_codes(index.packed_codes[r][lst, pos],
                                  index.pq_dim, index.pq_bits)
            cb = index.codebooks[r].double()
            S, _, P = cb.shape
            q = qv_row.double()
            lut = torch.einsum("sp,skp->sk", q.view(S, P), cb)
            dot = q @ index.centers_rot[r][lst].double() + lut[
                torch.arange(S, device=cb.device), code].sum()
            return float(index.packed_norms[r][lst, pos]) - 2.0 * float(dot)
    raise SmokeFailure(f"id {gid} is in no shard")


def _bin_rule_picks(index, ranked, k):
    """The first ``k`` of a row's exact picks ``ranked`` (global ids, best
    first) that survive the LUT-bin tier's selection: a list's rows fall
    into 128 strided bins (slot mod 128) and each bin keeps its two best,
    so a pick with two better picks in its (rank, list, bin) cell is
    dropped. Returns (ids, [(id, cell)] dropped before the k-th
    survivor)."""
    import torch

    seen, out, lost = {}, [], []
    for gid in ranked.tolist():
        if gid < 0 or len(out) == k:
            break
        for r in range(index.n_shards):
            hit = torch.nonzero(index.packed_ids[r] == gid)
            if hit.shape[0]:
                cell = (r, int(hit[0, 0]), int(hit[0, 1]) % 128)
                break
        else:
            raise SmokeFailure(f"id {gid} is in no shard")
        seen[cell] = seen.get(cell, 0) + 1
        if seen[cell] > 2:
            lost.append((gid, cell))
        else:
            out.append(gid)
    return out + [-1] * (k - len(out)), lost


def _ring_lut_scan_row(rows, path, launches, index, q, k, n_probes, mesh,
                       shape, filter_bits=None):
    """ring_lut_scan_merge against its plain version (on the same card) on
    one batch's chunk tables: the same finite pattern, keys within
    1e-5·(|key| + ‖q‖²) (the f32 rounding of an ADC key and its expanded
    form, as leg 3 and the LUT scan's check allow), ids equal away from key
    ties (the f64 key of the kernel's pick within that tolerance); then its
    row, with the largest difference beside its limit. ``filter_bits``
    (global row ids): each rank's keep bytes over its own id table, and
    the bound counts the kept rows and the keep bytes."""
    import torch

    from raft_tpu_torch.neighbors import sample_filter
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.parallel import ivf as pivf

    ops = pivf._fused_ring_operands(index, q, n_probes, mesh, False)
    lists, ind, qv, packed, ids, norms, sizes_r, ctr, cbs = ops
    fbytes = (None if filter_bits is None else
              [sample_filter.list_filter_bytes(filter_bits, t) for t in ids])
    kw = dict(pq_bits=index.pq_bits, pq_dim=index.pq_dim,
              L=index.max_list_size, lut_dtype="float32",
              filter_bytes=fbytes)
    tk, ti = K.ring_lut_scan_merge(*ops, k, "l2", **kw)
    n = len(packed)
    mc = qv[0].shape[1]
    cb = [K.lut_codebook(c, "float32") for c in cbs]
    rows_i = torch.arange(mc, device=q.device, dtype=torch.int32)
    seg_q = [torch.where(i > 0.5, rows_i, -1).to(torch.int32).contiguous()
             for i in ind]
    plain = lambda: K.ring_lut_scan_merge_plain(  # noqa: E731
        lists, seg_q, qv, packed, ids, norms, sizes_r, ctr, cb, k, "l2",
        index.pq_bits, fbytes)
    pk, pi = plain()
    err, worst, n_tie = 0.0, 0.0, 0
    for r in range(n):
        a, b = tk[r], pk[r]
        if not torch.equal(torch.isinf(a), torch.isinf(b)):
            raise SmokeFailure(f"ring_lut_scan_merge: filled slots differ "
                               f"on rank {r}")
        fin = torch.isfinite(b)
        qsq = (qv[r][r] * qv[r][r]).sum(1)[:, None].expand_as(b)
        tol = 1e-5 * (b.abs() + qsq)
        diff = (a - b).abs()
        if not bool((diff[fin] <= tol[fin]).all()):
            raise SmokeFailure(f"ring_lut_scan_merge keys differ by "
                               f"{float(diff[fin].max())} on rank {r}")
        if bool(fin.any()):
            err = max(err, float(diff[fin].max()))
            worst = max(worst, float((diff[fin] / tol[fin]).max()))
        for row, j in torch.nonzero((ti[r] != pi[r]) & fin).tolist():
            k64 = _adc_key64(index, qv[r][r, row], ti[r][row, j])
            if abs(k64 - float(b[row, j])) > float(tol[row, j]):
                raise SmokeFailure(f"ring_lut_scan_merge picks differ away "
                                   f"from key ties (rank {r}, row {row})")
            n_tie += 1
    # the bound: per (rank, chunk) the codes, ids and norms of the union
    # lists' real rows, their centers, the chunk tables and queries, the
    # outputs once; beside it the look-up floor, pq_dim shared-memory words
    # per (member pair, real row) at 32 words a clock on each of 132 SMs,
    # which is the bound where it is the larger. Operations: a LUT per
    # (rank, chunk row) and an add per subspace per (member pair, real row)
    nb = packed[0].shape[2]
    S, Kc, P = cbs[0].shape
    L = index.max_list_size
    n_bytes, flops, n_pairs, pair_rows = n * mc * k * 8, 0.0, 0, 0
    for r in range(n):
        sizes = index.list_sizes[r].long()
        kept = sizes
        if fbytes is not None:
            kept = (K.unpack_filter_bytes(fbytes[r], L) & (torch.arange(
                L, device=sizes.device)[None, :] < sizes[:, None])).sum(1)
        n_bytes += cbs[r].numel() * 4
        for c in range(n):
            lst = lists[r][c]
            real = lst >= 0
            lsz = torch.where(real, kept[lst.clamp_min(0).long()], 0)
            members = ind[r][c].sum(1)
            pr = int((members * lsz).sum())
            n_pairs += int(members.sum())
            pair_rows += pr
            n_bytes += (int(lsz.sum()) * (nb + 8) + int(real.sum())
                        * ctr[r].shape[1] * 4 + qv[r][c].numel() * 4
                        + ind[r][c].numel() * 4 + lst.numel() * 4)
            if fbytes is not None:   # the union lists' keep bytes
                n_bytes += int(((torch.where(real, sizes[lst.clamp_min(
                    0).long()], 0) + 7) // 8).sum())
            flops += (float((ind[r][c].sum(0) > 0).sum()) * 2 * S * Kc * P
                      + pr * S)
    clock = _sm_clock_hz()
    floor_ms = pair_rows * S / (SMEM_WORDS_PER_CLOCK * N_SMS * clock) * 1e3
    b_ms, _ = _bound_ms(n_bytes, flops)
    # the wrapper's host time a call: checks, the codebook cache, the
    # pointer table, one ctypes call (the card idle, no sync in the loop)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        K.ring_lut_scan_merge(*ops, k, "l2", **kw)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    _row(rows, path, "ring_lut_scan_merge", "ring_lut_scan.cu", 2010,
         launches["ring_lut_scan_merge"], err,
         _timed(lambda: K.ring_lut_scan_merge(*ops, k, "l2", **kw), 10),
         _timed(plain, 1), n_bytes, flops, None,
         f"{n} ranks, {q.shape[0]} queries (mc {mc}), NS "
         f"{lists[0].shape[1]}, {n_pairs} member pairs, {pair_rows} (member "
         f"pair, {'kept ' if fbytes is not None else ''}real row) pairs, "
         f"k {k}, two launches a call, {n_tie} picks "
         f"differ at f64 key ties, largest |dkey| {err:.3g} = {worst:.3f} of "
         f"its limit 1e-5*(|key|+|q|^2) ({shape})",
         floor_ms=floor_ms, host_ms=host_ms,
         logged=dict(lookup_floor_ms=floor_ms, bytes_bound_ms=b_ms,
                     sm_clock_mhz=clock / 1e6))


def _swaps_are_ties(queries, base, ids_a, ids_b, what):
    """Where two [m, k] id tables differ, the two picks must tie: their f64
    squared distances to the query agree within the f32 expanded form's
    rounding, 1e-4 + 1e-5·(‖q‖² + ‖x‖²). The ring breaks a tie by ring
    order, brute force and the allgather by row id. Returns the count."""
    import torch

    bad = torch.nonzero(ids_a != ids_b).tolist()
    for row, j in bad:
        q64 = queries[row].double()
        xa = base[ids_a[row, j]].double()
        xb = base[ids_b[row, j]].double()
        d_a = float(((q64 - xa) ** 2).sum())
        d_b = float(((q64 - xb) ** 2).sum())
        if abs(d_a - d_b) > 1e-4 + 1e-5 * float((q64 * q64).sum()
                                                + (xb * xb).sum()):
            raise SmokeFailure(f"{what}: ids differ away from ties (query "
                               f"{row}: {d_a} vs {d_b})")
    return len(bad)


def sharded_phase(args, rows):
    """The sharded tier on a 4-rank mesh whose ranks share one card:
    distributed build, sharded kNN (leg 1), refined sharded search on the
    ring merge (leg 2), the fused scan-in-ring tier (leg 3), the comms byte
    model (leg 4), then the path's kernels against their plain versions at
    its shapes.
    Raises SmokeFailure on any failed check. Returns the summary."""
    import numpy as np
    import torch

    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import brute_force, ivf_pq
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.parallel import comms, make_mesh
    from raft_tpu_torch.parallel import ivf as pivf
    from raft_tpu_torch.parallel import knn as pknn

    N, dim, nq, k, B = SHARD_N, SHARD_DIM, 10_000, 10, 500
    dev = torch.device("cuda", 0)
    mesh = make_mesh(SHARD_RANKS, device="cuda:0")
    t0 = time.perf_counter()
    ds = DeviceSynthetic(N, dim, n_centers=10_000, seed=args.seed, std=0.5,
                         scale=10.0, device=dev)
    base = ds.base()
    queries = ds.queries(nq)
    torch.cuda.synchronize()
    _log(f"[shard data] {N} x {dim} f32 base ({base.numel() * 4 / 1e9:.2f} "
         f"GB) + {nq} queries in {time.perf_counter() - t0:.1f} s; "
         f"{SHARD_RANKS} ranks on {mesh.distinct_devices}")

    # the path: build and legs 1-3; counts zeroed just before
    K.reset_launch_counts()
    spans.reset()
    t0 = time.perf_counter()
    index = pivf.build_ivf_pq(ivf_pq.IndexParams(
        n_lists=8192, pq_dim=64, pq_bits=8, cache_reconstruction="never",
        seed=args.seed), base, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    L = index.max_list_size
    codes_gb = sum(c.numel() for c in index.packed_codes) / 1e9
    _log(f"[shard build] {build_s:.1f} s; L = {L}; packed codes "
         f"{codes_gb:.2f} GB; rows indexed {index.size} of {N}")

    # leg 1: sharded kNN, both merge tiers, against single-rank brute force
    n_gt = 1000
    qg = queries[:n_gt].contiguous()
    gv, gt = brute_force.knn_arrays(base, qg, k, metric="sqeuclidean")
    knn = {}
    for merge in ("allgather", "ring"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v, i = pknn.sharded_knn(base, qg, k, mesh, merge=merge)
        torch.cuda.synchronize()
        n_diff = _swaps_are_ties(qg, base, i, gt,
                                 f"sharded_knn ({merge}) against brute force")
        rel = float(((v - gv).abs() / gv.abs().clamp_min(1e-30)).max())
        if rel > 1e-5:
            raise SmokeFailure(f"sharded_knn ({merge}) values differ by "
                               f"{rel} relative")
        knn[merge] = {"ids_differing": n_diff, "max_rel_err": rel,
                      "seconds": time.perf_counter() - t1}
        if merge == "allgather":
            knn_ag = (v, i)
    _log(f"[shard leg 1] sharded_knn of {n_gt} queries, k {k}, against "
         f"single-rank brute_force.knn: {json.dumps(knn)}")
    gt = gt.cpu()

    # leg 2: refined sharded search on the ring merge
    sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                             refine="f32_regen", refine_ratio=40,
                             lut_dtype="bfloat16")

    def search_pass(merge="auto", n=nq):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out_i, out_v = [], []
        start.record()
        for a in range(0, n, B):
            v, i = pivf.search_ivf_pq(sp, index, queries[a:a + B], k, mesh,
                                      dataset=base, merge=merge)
            out_v.append(v)
            out_i.append(i)
        end.record()
        torch.cuda.synchronize()
        return torch.cat(out_i), torch.cat(out_v), start.elapsed_time(end) / 1e3

    spans.reset()
    ids_ring, vals_ring, t_cold = search_pass()
    disp = spans.counts().get("parallel.merge.dispatch", {})
    if disp.get("ring_kernel", 0) != nq // B:
        raise SmokeFailure(f"refined leg did not take ring_kernel: {disp}")
    qps = [nq / search_pass()[2] for _ in range(3)]
    ids_ag, vals_ag, _ = search_pass("allgather")
    if not torch.equal(vals_ring, vals_ag):
        raise SmokeFailure("the ring and allgather tiers give different "
                           "values")
    n_tied = _swaps_are_ties(queries, base, ids_ring, ids_ag,
                             "refined search, ring against allgather")
    rec = _recall(ids_ring[:n_gt].cpu(), gt)
    if not rec >= 0.95:
        raise SmokeFailure(f"refined sharded recall@10 {rec} < 0.95")
    _log(f"[shard leg 2] refined search, batch {B}, n_probes 64, "
         f"refine_ratio 40, bf16 LUT, merge auto -> {disp}: cold pass "
         f"{nq / t_cold:.0f} QPS, three warm passes "
         + ", ".join(f"{x:.0f}" for x in qps)
         + f" QPS (CUDA events); recall@10 {rec:.4f} on {n_gt} queries; "
         f"the allgather tier gives the same values and ids ({n_tied} "
         f"swapped at ties)")

    # leg 3: the fused scan-in-ring tier at batch 32, against the unfused
    # ring search of the same batches
    spf = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                              lut_dtype="float32")
    bf, n_f = 32, 50

    def timed_call(q):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = pivf.search_ivf_pq(spf, index, q, k, mesh)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    lat = {}
    res = {}
    for mode in ("on", "off"):
        os.environ["RAFT_TPU_RING_FUSED"] = "auto" if mode == "on" else "off"
        spans.reset()
        ms, outs = [], []
        for c in range(n_f):
            out, t = timed_call(queries[c * bf:(c + 1) * bf])
            ms.append(t)
            outs.append(out)
        lat[mode] = ms
        res[mode] = (torch.cat([o[0] for o in outs]),
                     torch.cat([o[1] for o in outs]))
        d = spans.counts().get("parallel.merge.dispatch", {})
        want = "ring_fused_scan" if mode == "on" else "ring_kernel"
        if d.get(want, 0) != n_f:
            raise SmokeFailure(f"fused leg ({mode}) took {d}, not {want}")
    os.environ.pop("RAFT_TPU_RING_FUSED", None)
    (fv, fi), (uv, ui) = res["on"], res["off"]
    n_swap = 0
    binned = []  # every row where the bin rule dropped a pick, with keys
    for row in sorted({r for r, _ in torch.nonzero(fi != ui).tolist()}):
        # the fused tier keeps a list's two best per strided bin, as the
        # LUT-scan tier does (its contract); the unfused search is exact.
        # Its reference is the unfused top-2k without the ids that bin
        # rule drops: those with two better picks in their (rank, list,
        # bin) cell. Where no id is dropped that is the unfused top-k.
        os.environ["RAFT_TPU_RING_FUSED"] = "off"
        u2 = pivf.search_ivf_pq(spf, index, queries[row:row + 1], 2 * k,
                                mesh)[1][0]
        os.environ.pop("RAFT_TPU_RING_FUSED", None)
        want, lost = _bin_rule_picks(index, u2, k)
        q_rot = queries[row] @ index.rotation[0].T
        qsq = float((q_rot.double() ** 2).sum())
        if lost:
            binned.append({
                "row": row, "fused": fi[row].tolist(), "reference": want,
                "dropped": [{"id": gid, "rank_list_bin": list(cell),
                             "f64_key": _adc_key64(index, q_rot, gid) + qsq}
                            for gid, cell in lost]})
            _log(f"[shard leg 3 bin rule] {json.dumps(binned[-1])}")
        for j in range(k):
            if int(fi[row, j]) == want[j]:
                continue
            # the fused pick and the reference's must tie in f64 (both are
            # ADC keys of the same codes: l2 key + ‖q_rot‖²)
            d_f = _adc_key64(index, q_rot, fi[row, j]) + qsq
            d_u = _adc_key64(index, q_rot, want[j]) + qsq
            if abs(d_f - d_u) > 1e-5 * (abs(d_u) + qsq):
                raise SmokeFailure(
                    f"fused tier ids differ from the unfused search away "
                    f"from key ties (row {row}, slot {j}: fused id "
                    f"{int(fi[row, j])} f64 key {d_f:.9g}, reference id "
                    f"{want[j]} f64 key {d_u:.9g}; fused row "
                    f"{fi[row].tolist()}, unfused row {ui[row].tolist()}, "
                    f"{len(lost)} dropped by the bin rule)")
            n_swap += 1
    _log(f"[shard leg 3] batch {bf}, n_probes 64, f32 LUT: fused "
         f"scan-in-ring per call ms median {np.median(lat['on']):.3f} "
         f"(min {min(lat['on']):.3f}), unfused (per_query scan + ring) "
         f"median {np.median(lat['off']):.3f} (min {min(lat['off']):.3f}); "
         f"ids equal over {n_f * bf} queries but {n_swap} picks at f64 key "
         f"ties and {sum(len(b['dropped']) for b in binned)} ids a list's "
         f"strided bin dropped (its two best kept), in {len(binned)} rows")
    launches = K.launch_counts()
    _log(f"[shard] launches {json.dumps(launches)}")
    missing = [n for n in SHARD_KERNELS if launches[n] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the sharded path: "
                           f"{missing}")

    # the kernel path's recall against the plain path's: the same sharded
    # search on a CPU mesh (every wrapper runs its plain version)
    n_pl = 200
    t0 = time.perf_counter()
    mesh_cpu = make_mesh(SHARD_RANKS, device="cpu")
    index_cpu = pivf.from_numpy(*pivf.to_numpy(index), mesh_cpu)
    base_cpu = base.cpu()
    _, ids_pl = pivf.search_ivf_pq(sp, index_cpu, queries[:n_pl].cpu(), k,
                                   mesh_cpu, dataset=base_cpu)
    rec_plain = _recall(ids_pl, gt[:n_pl])
    rec_kern = _recall(ids_ring[:n_pl].cpu(), gt[:n_pl])
    del index_cpu, base_cpu
    _log(f"[shard recall] {n_pl} queries: kernel path {rec_kern:.4f}, plain "
         f"path (CPU) {rec_plain:.4f} ({time.perf_counter() - t0:.1f} s)")
    if abs(rec_kern - rec_plain) > 0.01:
        raise SmokeFailure(f"sharded kernel-path recall {rec_kern} is not "
                           f"within 0.01 of the plain path's {rec_plain}")

    # leg 4: the comms byte model of one batch, ring against allgather
    byte_model = {}
    for merge in ("ring", "allgather"):
        comms.reset_counters()
        pivf.search_ivf_pq(sp, index, queries[:B], k, mesh, dataset=base,
                           merge=merge)
        c = comms.counters()
        byte_model[merge] = {f"{op}": n for (op, _), n in c["bytes"].items()}
    ring_b = byte_model["ring"]["ring_topk"]
    ag_b = byte_model["allgather"]["allgather"]
    _log(f"[shard comms] bytes of one batch of {B} (the JAX package's byte "
         f"model of a mesh of separate devices, not a measurement: the "
         f"ranks share one card): {json.dumps(byte_model)}")
    if not 2 * ring_b <= ag_b:
        raise SmokeFailure(f"ring bytes {ring_b} > half the allgather's "
                           f"{ag_b}")

    # kernels against their plain versions at the path's shapes
    q0 = queries[:B].contiguous()
    vals, gids = pivf._per_rank_topk(sp, index, q0, k, 64, mesh, base)
    _ring_topk_row(rows, "sharded", launches, vals, gids, k,
                   f"refined batch {B}")
    _ring_lut_scan_row(rows, "sharded", launches, index, queries[:bf], k,
                       64, mesh, f"fused batch {bf}")
    local0 = index.local(0)
    shard0 = base[:index.shard_rows]
    _argmin_row(rows, "sharded", launches, shard0,
                local0.centers.contiguous(), "(rank 0's Lloyd sweep) ")
    # select_k: the ring's plain-schedule cut, incoming ++ local [mc, 2k]
    mc = K.ring_chunk_rows(B, SHARD_RANKS)
    cut = torch.cat([vals[0][:mc], vals[1][:mc]], 1).contiguous()
    _select_k_row(rows, "sharded", launches, cut, k,
                  ", the ring schedule's incoming ++ local cut")
    _lut_scan_row(rows, "sharded", launches, local0, q0, 64, "bfloat16",
                  "rank 0's shard: ")
    sp_scan = ivf_pq.SearchParams(**{**sp.__dict__, "refine": "none"})
    _, cand = ivf_pq.search(local0, q0, 400, sp_scan)
    # rank 0's offset is 0: its global candidate ids are its local rows
    _refine_row(rows, "sharded", launches, shard0, q0, cand.contiguous(), k,
                "rank 0's shard: ")

    # where one refined batch's time goes, each part alone (CUDA events)
    ring_ms = next(r["ms"] for r in rows if r["path"] == "sharded"
                   and r["name"] == "ring_topk_merge")
    stages_ms = {
        "one_rank_refined_search": _timed(lambda: ivf_pq.search(
            local0, q0, k, sp, dataset=shard0), 5),
        "all_ranks_local_topk": _timed(lambda: pivf._per_rank_topk(
            sp, index, q0, k, 64, mesh, base), 5),
        "ring_merge": ring_ms,
        "search_total": _timed(lambda: pivf.search_ivf_pq(
            sp, index, q0, k, mesh, dataset=base), 5),
    }
    _log(f"[shard stages] one refined batch of {B} queries, ms: "
         f"{json.dumps(stages_ms)}")
    filt_summary = shard_filter_leg(rows, index, base, queries, mesh, sp,
                                    spf, B, bf, k)
    hier_summary = shard_hier_leg(rows, index, base, queries, mesh, sp, B,
                                  k, knn_ag)
    del knn_ag

    _log(f"[shard transport] the {SHARD_RANKS} ranks shared cuda:0 "
         f"({torch.cuda.device_count()} card(s) visible): ring_topk_merge "
         f"walked each chunk's merge chain in one launch and "
         f"ring_lut_scan_merge read its neighbours' blocks through local "
         f"pointers; ranks on "
         f"several cards (peer pointers over NVLink) are not ported yet "
         f"(ROADMAP A15), so that transport went unmeasured")
    return {"n": N, "dim": dim, "ranks": SHARD_RANKS, "n_lists": 8192,
            "pq_dim": 64, "max_list_size": L, "build_s": build_s,
            "sharded_knn": knn, "qps_cold": nq / t_cold, "qps_warm": qps,
            "recall_at_10": rec, "recall_kernel_200": rec_kern,
            "recall_plain_200": rec_plain,
            "fused_ms_median": float(np.median(lat["on"])),
            "unfused_ms_median": float(np.median(lat["off"])),
            "fused_bin_rule_rows": binned,
            "byte_model": byte_model, "batch_stages_ms": stages_ms,
            "launches": launches, "filter": filt_summary,
            "hier": hier_summary}


def shard_filter_leg(rows, index, base, queries, mesh, sp, spf, B, bf, k):
    """The sharded tier filtered (ROADMAP A6): the bench's keep mask at
    selectivity 0.1 over the 20M global row ids, replicated. With the
    counts zeroed before and read after: the refined search of a batch of
    B (three passes; each rank's LUT scan with its keep bytes, so B1 must
    launch with its filter once a rank a pass) and the fused
    scan-in-ring tier at batch ``bf`` (B8 with each rank's keep bytes)
    over ten batches, held against the allgather tier's filtered search
    (ids equal except at f32 ties, checked in f64). Checks: no returned
    id has its bit clear; the refined batch on the ring merge gives the
    allgather tier's values and ids but at ties; its recall@10 against
    the filtered ground truth is logged. Then B8 filtered against its
    plain version (its row). Raises SmokeFailure; returns the summary."""
    import numpy as np
    import torch

    from raft_tpu_torch.core import bitset
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.parallel import ivf as pivf

    N, sel, n_f = base.shape[0], 0.1, 10
    keep = bench_keep(N, sel, k)
    bits = bitset.from_mask(keep, device=base.device)
    q0 = queries[:B].contiguous()
    _, fgt = brute_force.knn(brute_force.build(base, "sqeuclidean"), q0, k,
                             filter_bitset=bits)
    K.reset_launch_counts()
    spans.reset()
    secs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, ids = pivf.search_ivf_pq(sp, index, q0, k, mesh, dataset=base,
                                    filter_bitset=bits)
        end.record()
        torch.cuda.synchronize()
        secs.append(start.elapsed_time(end))
    # the ring merge (auto) against the allgather tier, both filtered: the
    # same values, the same ids but at ties
    vals = pivf.search_ivf_pq(sp, index, q0, k, mesh, dataset=base,
                              filter_bitset=bits)[0]
    v_ag, i_ag = pivf.search_ivf_pq(sp, index, q0, k, mesh, dataset=base,
                                    merge="allgather", filter_bitset=bits)
    if not (torch.equal(vals, v_ag) and torch.equal(ids < 0, i_ag < 0)):
        raise SmokeFailure("filtered refined batch: the ring and allgather "
                           "tiers give different values")
    n_tied = _swaps_are_ties(q0, base, ids.clamp_min(0), i_ag.clamp_min(0),
                             "filtered refined batch, ring against "
                             "allgather")
    ids = ids.cpu()
    n_empty = _check_kept(ids, keep, "filtered sharded refined batch")
    rec = _recall(ids, fgt.cpu())
    # the fused tier against the allgather tier, both filtered
    os.environ["RAFT_TPU_RING_FUSED"] = "auto"
    fused, ag, f_ms = [], [], []
    try:
        for c in range(n_f):
            q = queries[c * bf:(c + 1) * bf]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fused.append(pivf.search_ivf_pq(spf, index, q, k, mesh,
                                            filter_bitset=bits))
            end.record()
            torch.cuda.synchronize()
            f_ms.append(start.elapsed_time(end))
            ag.append(pivf.search_ivf_pq(spf, index, q, k, mesh,
                                         merge="allgather",
                                         filter_bitset=bits))
    finally:
        os.environ.pop("RAFT_TPU_RING_FUSED", None)
    launches = K.launch_counts()
    filtered = K.filtered_launch_counts()
    disp = spans.counts()
    n_ranks = len(mesh.devices)
    # five refined searches of the batch (three passes, the ring and the
    # allgather tiers), each a LUT scan a rank
    if filtered["ivfpq_lut_scan_topk"] != 5 * n_ranks:
        raise SmokeFailure(f"filtered sharded refined batches: B1 launched "
                           f"{filtered['ivfpq_lut_scan_topk']} times with its "
                           f"filter for {5 * n_ranks} rank searches")
    if filtered["ring_lut_scan_merge"] != 2 * n_f:
        raise SmokeFailure(f"filtered fused tier: B8 launched "
                           f"{filtered['ring_lut_scan_merge']} times with its "
                           f"filter for {n_f} calls (two a call): {disp}")
    fi = torch.cat([o[1] for o in fused])
    ui = torch.cat([o[1] for o in ag])
    _check_kept(fi.cpu(), keep, "filtered fused tier")
    _check_kept(ui.cpu(), keep, "filtered allgather tier")
    n_swap = 0
    for row, j in torch.nonzero(fi != ui).tolist():
        q_rot = queries[row] @ index.rotation[0].T
        qsq = float((q_rot.double() ** 2).sum())
        if int(fi[row, j]) < 0 or int(ui[row, j]) < 0:
            raise SmokeFailure(f"filtered fused tier: an empty slot where "
                               f"the allgather tier has none (row {row})")
        d_f = _adc_key64(index, q_rot, fi[row, j]) + qsq
        d_u = _adc_key64(index, q_rot, ui[row, j]) + qsq
        if abs(d_f - d_u) > 1e-5 * (abs(d_u) + qsq):
            raise SmokeFailure(f"filtered fused tier ids differ from the "
                               f"allgather tier away from key ties (row "
                               f"{row})")
        n_swap += 1
    _log(f"[shard filter] selectivity {sel} ({int(keep.sum())} of {N} rows "
         f"kept): refined batch of {B}, three passes "
         + ", ".join(f"{t:.3f}" for t in secs)
         + f" ms (CUDA events; " + ", ".join(f"{B / t * 1e3:.0f}"
                                              for t in secs)
         + f" QPS); recall@10 {rec:.4f} against the filtered ground truth; "
         f"{n_empty} empty slots; the allgather tier gives the same values "
         f"and ids ({n_tied} swapped at ties). Fused scan-in-ring at batch "
         f"{bf}, f32 LUT: "
         f"per call ms median {np.median(f_ms):.3f} (min {min(f_ms):.3f}); "
         f"ids equal to the filtered allgather tier's over {n_f * bf} "
         f"queries but {n_swap} picks at f64 key ties; launches "
         f"{json.dumps(launches)}, with the filter {json.dumps(filtered)}; "
         f"dispatch {json.dumps(disp.get('parallel.merge.dispatch', {}))}")
    _ring_lut_scan_row(rows, "sharded_filter", filtered, index,
                       queries[:bf], k, 64, mesh,
                       f"fused batch {bf}, selectivity {sel}",
                       filter_bits=bits)
    return {"selectivity": sel, "kept": int(keep.sum()),
            "refined_batch_ms": secs, "recall_at_10": rec,
            "empty_slots": n_empty,
            "fused_ms_median": float(np.median(f_ms)),
            "fused_ids_at_ties": n_swap, "launches": launches,
            "filtered_launches": filtered}


def shard_hier_leg(rows, index, base, queries, mesh, sp, B, k, knn_ag):
    """``[shard hier]``: the hier tier over a (dcn, ici) = (2, 2) mesh of
    the same four ranks. With the counts zeroed just before and read just
    after: ``sharded_knn`` of 1,000 queries and one refined IVF-PQ batch of
    ``B`` with ``merge="hier"``, each equal to the 1-D mesh's allgather
    tier: values bit for bit, ids but where two rows tie in f32 (the
    per-pod ring breaks a tie by ring order, the allgather by rank order;
    checked in f64), ``parallel.merge.dispatch{impl=
    hier}`` counted once a call, B7 launched once a pod a call, and the
    survivor exchange's ``comms.bytes{axis=dcn,op=alltoall}`` equal to the
    JAX package's model (``tests/test_parallel.py:346-360``): n_outer ·
    (mc / n_outer) · k entries of 8 bytes a rank. Then B7 over a pod's two
    ranks against its plain version. Returns the leg's summary."""
    import torch

    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.parallel import comms, hier_mesh, merge
    from raft_tpu_torch.parallel import ivf as pivf
    from raft_tpu_torch.parallel import knn as pknn

    n_outer, n_inner = 2, SHARD_RANKS // 2
    mesh2 = hier_mesh(n_inner, n_outer, devices="cuda:0")
    axis = ("dcn", "ici")
    qg = queries[:1000].contiguous()
    q0 = queries[:B].contiguous()
    K.reset_launch_counts()
    spans.reset()
    out, dcn, swaps = {}, {}, {}
    ref_pq = pivf.search_ivf_pq(sp, index, q0, k, mesh, dataset=base,
                                merge="allgather")
    for what, run, ref, qs in (
            ("sharded_knn", lambda: pknn.sharded_knn(
                base, qg, k, mesh2, axis=axis, merge="hier"), knn_ag, qg),
            ("refined_ivf_pq", lambda: pivf.search_ivf_pq(
                sp, index, q0, k, mesh2, axis=axis, dataset=base,
                merge="hier"), ref_pq, q0)):
        m = qs.shape[0]
        comms.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, i = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(v, ref[0]):
            bad = torch.nonzero(v != ref[0]).tolist()[:5]
            raise SmokeFailure(f"{what}: the hier tier's values differ from "
                               f"the allgather tier's at {bad}")
        # the ring breaks an f32 tie by ring order, the allgather by rank
        # order: ids may differ only between f64-tied rows
        swaps[what] = _swaps_are_ties(qs, base, i.long(), ref[1].long(),
                                      f"{what}, hier against allgather")
        c = comms.counters()["bytes"]
        mc = merge.hier_chunk_rows(m, n_inner, n_outer)
        model = n_outer * (mc // n_outer) * k * 8
        got = c.get(("alltoall", "dcn"), 0)
        if got != model or set(a for _, a in c) != {"dcn", "ici"}:
            raise SmokeFailure(f"{what}: dcn alltoall bytes {got} against "
                               f"the survivor model {model} ({c})")
        dcn[what] = {"bytes": {f"{op}/{a}": n for (op, a), n in c.items()},
                     "dcn_model": model}
        out[what] = ms
    launches = K.launch_counts()
    disp = spans.counts().get("parallel.merge.dispatch", {})
    if disp.get("hier", 0) != 2:
        raise SmokeFailure(f"the hier tier was not taken once a call: {disp}")
    if launches["ring_topk_merge"] != 2 * n_outer:
        raise SmokeFailure(f"B7 launched {launches['ring_topk_merge']} "
                           f"times, not once a pod a call")
    _log(f"[shard hier] hier_mesh({n_inner}, {n_outer}), axis {axis}: "
         f"sharded_knn of 1000 queries and a refined batch of {B}: values "
         f"equal to the allgather tier's bit for bit, ids equal but "
         f"{json.dumps(swaps)} swapped at f32 ties (checked in f64); dispatch "
         f"{json.dumps(disp)}; launches {json.dumps(launches)}; ms "
         f"{json.dumps(out)}; comms bytes (the JAX package's model of "
         f"separate devices, not a measurement) {json.dumps(dcn)}")
    vals, gids = pivf._per_rank_topk(sp, index, q0, k, 64, mesh, base)
    _ring_topk_row(rows, "sharded_hier", launches, vals[:n_inner],
                   gids[:n_inner], k, f"one pod's {n_inner} ranks, refined "
                   f"batch {B}")
    return {"ms": out, "comms": dcn, "launches": launches,
            "swaps_at_ties": swaps}


def shard_flat_leg(args, rows, base, queries, gt):
    """``[shard flat]``: sharded IVF-Flat on the 4-rank mesh over the flat
    phase's 1M x 128 ``make_synthetic_hard`` set (bench.py:194-210's
    ``ivf_flat.n1024``: 1024 lists; the sharded builds take no spill, so
    the package's cap factor 4), k 10. With the counts zeroed just before
    the builds and read after the last search: ``parallel.build_ivf_flat``
    (distributed Lloyd) and ``ivf_flat.build_distributed`` (chunks of
    125,000 rows); the 10,000 queries at n_probes 32 in one batch (merge
    auto: the allgather, as the ring kernel's rule refuses mc 2,500), QPS
    and recall@10 of both builds; the ring tier (B7, batches of 2,500)
    equal to the allgather tier but at f32 ties checked in f64, values
    equal; at n_probes 1024 the search exhaustive, equal to
    ``brute_force.knn`` but at ties on 200 queries; B4, B3 and B7
    launched. Then, under ``torch.use_deterministic_algorithms``,
    ``index_sha16(assemble_ivf_flat(build_distributed))`` equal to
    ``ivf_flat.build`` with the same parameters. Returns the summary."""
    import torch

    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.parallel import (assemble_ivf_flat, index_sha16,
                                         make_mesh)
    from raft_tpu_torch.parallel import ivf as pivf

    N, nq, k, n_gt = base.shape[0], queries.shape[0], 10, gt.shape[0]
    n_ex = 200  # the exhaustive search gathers every list a query
    mesh = make_mesh(SHARD_RANKS, device="cuda:0")
    params = ivf_flat.IndexParams(n_lists=1024, seed=args.seed)
    chunk = N // SHARD_RANKS // 2
    K.reset_launch_counts()
    built, secs = {}, {}
    for name, build in (
            ("psum_lloyd", lambda: pivf.build_ivf_flat(params, base, mesh)),
            ("build_distributed", lambda: ivf_flat.build_distributed(
                base, params, mesh=mesh, chunk_rows=chunk))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built[name] = build()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    summary = {"build_s": secs}
    sp32 = ivf_flat.SearchParams(n_probes=32)
    for name, index in built.items():
        def run(merge="auto", q=queries, sp=sp32):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            v, i = pivf.search_ivf_flat(sp, index, q, k, mesh, merge=merge)
            end.record()
            torch.cuda.synchronize()
            return v, i, start.elapsed_time(end)

        v_ag, i_ag, ms = run()
        ms2 = run()[2]
        rec = _recall(i_ag[:n_gt].cpu(), gt)
        # both tiers on the same batches: a batch's products (the coarse
        # distances, the candidates' bmm) give other last bits at other
        # row counts
        parts = {mg: [run(mg, queries[a:a + 2500])
                      for a in range(0, nq, 2500)]
                 for mg in ("ring", "allgather")}
        v_r, i_r, v_a, i_a = (torch.cat([p[j] for p in parts[mg]])
                              for mg in ("ring", "allgather")
                              for j in (0, 1))
        if not torch.equal(v_r, v_a):
            raise SmokeFailure(f"[shard flat] {name}: the ring tier's values "
                               f"differ from the allgather tier's")
        n_tied = _swaps_are_ties(queries, base, i_r, i_a,
                                 f"[shard flat] {name}, ring against "
                                 f"allgather")
        v_x, i_x, ms_x = run(q=queries[:n_ex],
                             sp=ivf_flat.SearchParams(n_probes=1024))
        gt_t = torch.as_tensor(gt[:n_ex], device=i_x.device)
        n_x = _swaps_are_ties(queries[:n_ex], base, i_x.long(), gt_t.long(),
                              f"[shard flat] {name} at n_probes 1024 "
                              f"against brute_force.knn")
        summary[name] = {"qps": [nq / (ms / 1e3), nq / (ms2 / 1e3)],
                         "recall_at_10": rec, "ring_swaps_at_ties": n_tied,
                         "exhaustive_swaps_at_ties": n_x,
                         "exhaustive_ms": ms_x, "size": index.size}
        _log(f"[shard flat] {name}: build {secs[name]:.2f} s, "
             f"{index.size} rows indexed, L {index.max_list_size}; n_probes "
             f"32, batch {nq}, merge auto (allgather): {nq / (ms / 1e3):.0f}"
             f" then {nq / (ms2 / 1e3):.0f} QPS (CUDA events), recall@10 "
             f"{rec:.4f} on {n_gt}; ring tier in batches of 2,500 equal "
             f"to the allgather but {n_tied} swaps at f32 ties; n_probes "
             f"1024 over {n_ex} queries ({ms_x:.0f} ms) equal to "
             f"brute_force.knn but {n_x} swaps at ties")
    launches = K.launch_counts()
    missing = [n for n in ("fused_l2_argmin", "select_k", "ring_topk_merge")
               if launches[n] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the sharded "
                           f"IVF-Flat path: {missing}")
    summary["launches"] = launches
    del built
    torch.cuda.empty_cache()
    with deterministic():
        dist = ivf_flat.build_distributed(base, params, mesh=mesh,
                                          chunk_rows=chunk)
        single = ivf_flat.build(base, params)
        sha_d = index_sha16(assemble_ivf_flat(dist))
        sha_s = index_sha16(single)
    del dist, single
    torch.cuda.empty_cache()
    if sha_d != sha_s:
        raise SmokeFailure(f"[shard flat] assemble_ivf_flat(build_"
                           f"distributed) sha {sha_d} != ivf_flat.build's "
                           f"{sha_s}")
    summary["sha"] = sha_d
    _log(f"[shard flat] launches {json.dumps(launches)}; under the "
         f"determinism mode index_sha16(assemble_ivf_flat(build_distributed"
         f")) = index_sha16(ivf_flat.build) = {sha_d}")
    return summary


def _sha_mismatch(a, b):
    """{field: rows differing} of two single-device IVF-PQ indexes."""
    import torch

    from raft_tpu_torch.neighbors import ivf_pq

    out = {}
    for name in ivf_pq._ARRAY_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            continue
        x, y = x.cpu(), y.cpu()
        if x.shape != y.shape:
            out[name] = f"shapes {tuple(x.shape)} vs {tuple(y.shape)}"
        elif not torch.equal(x, y):
            ne = (x != y).reshape(x.shape[0], -1).any(1)
            out[name] = int(ne.sum())
    return out


def dist_resume_check(args, params, chunk, mesh):
    """The distributed build's resume at ``DIST_RESUME_RANK_CHUNKS`` chunks
    a rank: a checkpointed build stopped by a fault at rank 2's second
    encode chunk, resumed, equal (sha) to the uninterrupted build of that
    size (both under the determinism mode); its ``resume.*`` counters;
    the uninterrupted build made twice, ``prefetch=True`` then
    ``prefetch=False`` (their wall times logged, no stage timing), each
    held to the resumed build's sha. Runs under the caller's determinism
    mode. Returns the summary."""
    import tempfile

    import torch

    from raft_tpu_torch.bench.dataset import DeviceSyntheticChunks
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.parallel import index_sha16
    from raft_tpu_torch.robust import checkpoint as ckpt
    from raft_tpu_torch.robust import faults

    per_rank = DIST_RESUME_RANK_CHUNKS
    n = SHARD_RANKS * per_rank * chunk
    ds = DeviceSyntheticChunks(n, SHARD_DIM, n_centers=10_000,
                               seed=args.seed + 1, chunk_rows=chunk,
                               device="cuda")
    site = "ivf_pq.build_distributed"
    spans.reset()
    t0 = time.perf_counter()
    walls = {"on": [], "off": []}
    with tempfile.TemporaryDirectory(prefix="dist_ckpt_") as tmp:
        # ranks 0 and 1 encode their chunks first: rank 2's second chunk
        # is the (2·per_rank + 2)-th encode
        faults.install_plan({"faults": [{
            "site": "build.chunk_encode", "kind": "error",
            "after": 2 * per_rank + 2}]})
        try:
            ivf_pq.build_distributed(ds, params, mesh=mesh, chunk_rows=chunk,
                                     checkpoint_dir=tmp)
            raise SmokeFailure("the injected build.chunk_encode fault did "
                               "not stop the distributed build")
        except faults.FaultInjected:
            pass
        finally:
            faults.clear_plan()
        man = ckpt.BuildCheckpoint(tmp).load_manifest()
        done = man["shard_chunks_done"]
        if man["phase"] != "encode" or done != [per_rank, per_rank, 1, 0]:
            raise SmokeFailure(f"interrupted distributed build left phase "
                               f"{man['phase']}, shard chunks {done}")
        resumed = ivf_pq.build_distributed(ds, params, mesh=mesh,
                                           chunk_rows=chunk,
                                           checkpoint_dir=tmp, resume=True)
        sha_r = index_sha16(resumed)
        del resumed
    resume_counts = {name: spans.total(name, site=site) for name in (
        "resume.attempts", "resume.chunks_replayed")}
    if resume_counts["resume.chunks_replayed"] != sum(done):
        raise SmokeFailure(f"resume replayed {resume_counts} chunks, the "
                           f"manifest recorded {sum(done)}")
    for turn in ("on", "off"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        idx = ivf_pq.build_distributed(ds, params, mesh=mesh,
                                       chunk_rows=chunk,
                                       prefetch=turn == "on")
        torch.cuda.synchronize()
        walls[turn].append(time.perf_counter() - t1)
        sha_u = index_sha16(idx)
        del idx
        if sha_r != sha_u:
            raise SmokeFailure(f"the resumed distributed build's sha {sha_r}"
                               f" != the uninterrupted build's {sha_u} "
                               f"(prefetch {turn})")
    out = {"n": n, "shard_chunks_done": done, "counters": resume_counts,
           "sha": sha_r, "prefetch_wall_s": walls,
           "seconds": time.perf_counter() - t0}
    _log(f"[dist resume] {n} x {SHARD_DIM} ({per_rank} chunks a rank): a "
         f"checkpointed build stopped at rank 2's second encode chunk "
         f"(shard chunks done {done}), resumed: sha {sha_r} = the "
         f"uninterrupted builds' with prefetch=True "
         f"({walls['on'][0]:.2f} s) and prefetch=False "
         f"({walls['off'][0]:.2f} s); {json.dumps(resume_counts)} "
         f"({out['seconds']:.1f} s)")
    return out


def _cagra_passes(search, queries, batch):
    """Seconds of three passes over ``queries`` in batches (cold, then two
    warm; CUDA events around each pass) and the last pass's (distances,
    ids)."""
    import torch

    secs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        outs = []
        start.record()
        for a in range(0, queries.shape[0], batch):
            outs.append(search(queries[a:a + batch]))
        end.record()
        torch.cuda.synchronize()
        secs.append(start.elapsed_time(end) / 1e3)
    return (secs, torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def _latency_ms(search, q, reps: int = 20) -> float:
    """Median ms of one search of ``q`` (CUDA events around each call,
    after one warm-up)."""
    import torch

    search(q)
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        search(q)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return sorted(ms)[reps // 2]


def _cagra_graph_checks(index, knn, n):
    """The graph's invariants: [n, 64] int32, every id in [0, n) or −1, no
    row holding its own id, every row's first 32 edges among its 128
    intermediate edges. Returns the count of −1 entries."""
    import torch

    g = index.graph
    if g.dtype != torch.int32 or tuple(g.shape) != (n, CAGRA_DEGREE):
        raise SmokeFailure(f"cagra graph is {g.dtype} {tuple(g.shape)}, "
                           f"not int32 [{n}, {CAGRA_DEGREE}]")
    if not bool(((g >= -1) & (g < n)).all()):
        raise SmokeFailure("cagra graph holds ids outside [0, n) and -1")
    self_hits, not_inter = 0, 0
    half = CAGRA_DEGREE // 2
    for a in range(0, n, 100_000):
        ga, ka = g[a:a + 100_000], knn[a:a + 100_000]
        own = torch.arange(a, a + ga.shape[0], device=g.device)[:, None]
        self_hits += int((ga == own).sum())
        inside = (ga[:, :half, None] == ka[:, None, :]).any(2)
        not_inter += int((~inside).sum())
    if self_hits:
        raise SmokeFailure(f"cagra graph: {self_hits} rows hold their own id")
    if not_inter:
        raise SmokeFailure(f"cagra graph: {not_inter} of the rows' first "
                           f"{half} edges are not among their "
                           f"{knn.shape[1]} intermediate edges")
    return int((g < 0).sum())


def _edge_recall(base, graph, sample, k):
    """Recall of ``graph``'s rows ``sample`` (their first k edges) against
    the exact k nearest rows of ``base`` (self excluded)."""
    import torch

    from raft_tpu_torch.neighbors import brute_force

    _, ex = brute_force.knn_arrays(base, base[sample], k + 1,
                                   metric="sqeuclidean")
    own = sample[:, None].to(ex.dtype)
    ex = torch.stack([r[r != o][:k] for r, o in zip(ex, own)])
    got = graph[sample][:, :k]
    hit = (got[:, :, None] == ex[:, None, :]).any(2).sum()
    return float(hit) / (sample.shape[0] * k)


def _traced_cagra_search(index, q, k, sp, bits, device):
    """``cagra.search`` with every selection of its traversal recorded:
    the keys and the picked positions of each ``_ties.top_k_low`` call
    (entry clusters, seeds, the buffer's order, each iteration's parents
    and merge, the int8 re-rank), copied to the host. Returns (distances,
    ids, [(keys, picks), ...])."""
    from raft_tpu_torch.neighbors import _ties, cagra

    calls = []
    low = _ties.top_k_low

    def recorded(keys, kk):
        pos = low(keys, kk)
        calls.append((keys.cpu(), pos.cpu()))
        return pos

    _ties.top_k_low = recorded
    try:
        d, i = cagra.search(index, q, k, sp, filter_bitset=bits,
                            device=device)
    finally:
        _ties.top_k_low = low
    return d, i, calls


def _selection_name(j, n_calls, centers, use_q):
    """What the ``j``-th of a traversal's ``n_calls`` selections picks."""
    head = (["entry clusters"] if centers else []) + ["seeds",
                                                      "buffer order"]
    if j < len(head):
        return head[j]
    if use_q and j == n_calls - 1:
        return "int8 re-rank"
    it, step = divmod(j - len(head), 2)
    return f"iteration {it} {('parents', 'merge')[step]}"


def split_at_tie(calls_a, calls_b, r, rtol=1e-5):
    """Where two traversals of query row ``r`` (``_traced_cagra_search``'s
    records on the card and on the CPU) first pick differently, shown to be
    a rounding tie: every earlier selection picked the same positions on
    both sides, so the two sides rank the same candidates; at the split
    their keys hold +inf in the same slots and agree within ``rtol`` of the
    row's largest finite key; and each side's picks are its own keys'
    smallest, the lower position first at equal keys (checked on the host).
    The two sides then swap a pair only because their f32 keys round
    differently. Returns the split (selection index, slot, the swapped
    pair's keys on both sides); raises ValueError otherwise."""
    import torch

    from raft_tpu_torch.neighbors import _ties

    for j, ((ka, pa), (kb, pb)) in enumerate(zip(calls_a, calls_b)):
        if ka.shape != kb.shape or pa.shape != pb.shape:
            raise ValueError(f"selection {j}: shapes {tuple(ka.shape)} and "
                             f"{tuple(kb.shape)}")
        if torch.equal(pa[r], pb[r]):
            continue
        a, b = ka[r].double(), kb[r].double()
        fin = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), fin):
            raise ValueError(f"selection {j}: +inf in other slots")
        scale = float(b[fin].abs().max()) if bool(fin.any()) else 1.0
        diff = float((a - b)[fin].abs().max()) if bool(fin.any()) else 0.0
        if not diff <= rtol * scale:
            raise ValueError(f"selection {j}: keys differ by {diff:.6g}, "
                             f"more than {rtol} of {scale:.6g}")
        for keys, picks in ((ka, pa), (kb, pb)):
            if not torch.equal(_ties.top_k_low(keys[r:r + 1],
                                               picks.shape[1])[0], picks[r]):
                raise ValueError(f"selection {j}: picks that are not the "
                                 f"keys' smallest")
        slot = int(torch.nonzero(pa[r] != pb[r])[0])
        x, y = int(pa[r, slot]), int(pb[r, slot])
        return {"selection": j, "slot": slot, "positions": [x, y],
                "keys_card": [float(a[x]), float(a[y])],
                "keys_cpu": [float(b[x]), float(b[y])],
                "max_key_diff": diff, "scale": scale}
    raise ValueError(f"the traversals pick alike in all "
                     f"{min(len(calls_a), len(calls_b))} selections")


def _dump_cagra_case(what, r, q, index, out_c, out_p, calls_c, calls_p):
    """The failing query's record, written to ``chiprun_out/``: the query,
    both searches' output rows, both traversals' selections (keys and
    picks of row ``r``) and the graph's sha256. Returns the path."""
    import hashlib

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    path = os.path.join(here, "chiprun_out", f"cagra_{what}_q{r}.json")
    sha = hashlib.sha256(index.graph.cpu().numpy().tobytes()).hexdigest()
    rec = {"mode": what, "query_row": r, "graph_sha256": sha,
           "query": q[r].cpu().tolist(),
           "card": {"d": out_c[0][r].cpu().tolist(),
                    "ids": out_c[1][r].cpu().tolist()},
           "cpu": {"d": out_p[0][r].tolist(), "ids": out_p[1][r].tolist()},
           "selections": [{"keys_card": kc[r].tolist(),
                           "picks_card": pc[r].tolist(),
                           "keys_cpu": kp[r].tolist(),
                           "picks_cpu": pp[r].tolist()}
                          for (kc, pc), (kp, pp) in zip(calls_c, calls_p)]}
    with open(path, "w") as f:
        json.dump(rec, f)
    return path


def cagra_card_vs_cpu(index, index_q, base, q, k, sp, sp8, bits):
    """The queries ``q`` searched on the card against the same index
    searched on the CPU, f32, int8 (``index_q``, ``sp8``) and filtered
    (``bits``). Each query's ten results must agree but at f64 ties
    (``bench.dataset.tie_swaps``); a query that differs away from them
    must have traversals that split at a rounding tie (``split_at_tie``):
    CAGRA's search is plain torch on both devices, and a greedy traversal
    that picks one of two candidates whose keys the card and the CPU round
    to opposite orders walks on along other edges. A query that fails both
    is dumped (``_dump_cagra_case``) and raises SmokeFailure. Returns, per
    mode, the slots swapped at f64 ties and the queries split at a tie
    (named by their selection)."""
    from raft_tpu_torch.bench.dataset import tie_swaps
    from raft_tpu_torch.neighbors import cagra

    base_cpu = base.cpu()
    cpu_index = cagra.CagraIndex(
        dataset=base_cpu, graph=index.graph.cpu(), metric=index.metric,
        centers=index.centers.cpu(), entry_ids=index.entry_ids.cpu(),
        dataset_q=index_q.dataset_q.cpu(), q_scale=index_q.q_scale.cpu(),
        q_zero=index_q.q_zero.cpu())
    out = {}
    for what, idx_c, spc, fb in (("f32", index, sp, None),
                                 ("int8", index_q, sp8, None),
                                 ("filtered", index, sp, bits)):
        d_c, i_c, calls_c = _traced_cagra_search(idx_c, q, k, spc, fb,
                                                 idx_c.device)
        d_p, i_p, calls_p = _traced_cagra_search(
            cpu_index, q.cpu(), k, spc, None if fb is None else fb.cpu(),
            "cpu")
        swapped, splits = 0, []
        for r in range(q.shape[0]):
            try:
                swapped += tie_swaps(q[r:r + 1], base_cpu, i_c[r:r + 1],
                                     d_c[r:r + 1], i_p[r:r + 1],
                                     d_p[r:r + 1])
                continue
            except ValueError as e:
                outputs = str(e)
            try:
                split = split_at_tie(calls_c, calls_p, r)
            except ValueError as e:
                path = _dump_cagra_case(what, r, q, index, (d_c, i_c),
                                        (d_p, i_p), calls_c, calls_p)
                raise SmokeFailure(
                    f"cagra {what} card vs CPU, query {r}: {outputs}; its "
                    f"traversals split at no tie: {e} (record: {path})"
                ) from e
            split["selection"] = _selection_name(
                split["selection"], len(calls_c), index.centers is not None,
                spc.traverse == "int8")
            splits.append({"query": r, "outputs": outputs, **split})
        out[what] = {"swapped": swapped, "splits": splits}
    return out


def cagra_leg(args, rows):
    """``[cagra]`` (ROADMAP A16, BASELINE.md target 4, ``bench.py:274-279``
    ``gist.cagra.d64``): ``CAGRA_N`` x ``CAGRA_DIM`` ``DeviceSynthetic`` rows
    and ``CAGRA_QUERIES`` queries (GIST-1M's shape), k 10, exact ground
    truth by ``brute_force.knn``. Counts zeroed before ``cagra.build``
    (``IndexParams(graph_degree=64)``: the cluster algorithm over the auto
    128-d projection) and read after the f32 search passes (itopk 64,
    width 8, 6 iterations; batch 1,000: a cold then two warm passes, CUDA
    events; the latency at batch 10): fused_l2_argmin must have launched.
    Prints the build's seconds by stage and the card's peak, the
    intermediate graph's edge recall on 1,000 sampled rows, QPS, latency and
    recall@10 of the f32 search, of ``traverse="int8"`` on the index with
    its quantized rows added, and of a filtered search at selectivity 0.1
    (``bench_keep``; against the filtered ground truth, no cleared id);
    then the ``ivf_pq`` algorithm on the first ``CAGRA_PQ_N`` rows: graph
    edge recall, recall@10 and the tier counters ``ivf_pq.search`` and
    ``refine`` recorded, counts zeroed before its build and read after it
    (``CAGRA_PQ_KERNELS`` must have launched), fused_l2_argmin at its label
    pass's shape and select_k at its coarse select's against their plain
    versions (rows ``cagra_ivf_pq``). Checks: the graph's invariants
    (``_cagra_graph_checks``), the first 100 queries searched on the card
    equal to the same index searched on the CPU (f32, int8, filtered:
    ``bench.dataset.tie_swaps``), and fused_l2_argmin against its plain
    version at the build's predict shape (row ``cagra_build``); then the
    ``nn_descent`` algorithm on the same rows (``cagra_nn_descent_leg``).
    Frees its rows at the end. The build is a user's (its atomic sums
    change the graph from run to run), so the card-vs-CPU check meets a
    new graph in every run (``cagra_card_vs_cpu``; ROADMAP C7)."""
    import dataclasses

    import numpy as np
    import torch

    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.core import bitset
    from raft_tpu_torch.neighbors import brute_force, cagra
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K

    t_leg = time.perf_counter()
    n, dim, m, k = CAGRA_N, CAGRA_DIM, CAGRA_QUERIES, 10
    ds = DeviceSynthetic(n, dim, n_centers=10_000, seed=args.seed + 3)
    base = ds.base()
    queries = ds.queries(m)
    _, gt = brute_force.knn_arrays(base, queries, k, metric="sqeuclidean")
    gt = gt.cpu()
    params = cagra.IndexParams(graph_degree=CAGRA_DEGREE, seed=args.seed)
    sp = cagra.SearchParams(itopk_size=64, search_width=8, max_iterations=6,
                            traverse="f32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    stages, inter = {}, {}
    K.reset_launch_counts()
    t0 = time.perf_counter()
    index = cagra.build(base, params, stage_seconds=stages,
                        intermediates=inter)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    secs, d_f32, i_f32 = _cagra_passes(
        lambda qb: cagra.search(index, qb, k, sp), queries, m)
    launches = K.launch_counts()
    missing = [name for name in CAGRA_KERNELS if launches[name] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the cagra path: "
                           f"{missing}")
    lat = _latency_ms(lambda qb: cagra.search(index, qb, k, sp),
                      queries[:10])
    rec = _recall(i_f32.cpu(), gt)
    n_neg = _cagra_graph_checks(index, inter["knn_graph"], n)
    sample = torch.from_numpy(np.random.default_rng(args.seed).choice(
        n, 1000, replace=False)).to(base.device)
    edge_rec = _edge_recall(base, inter["knn_graph"], sample,
                            inter["knn_graph"].shape[1])
    _log(f"[cagra] {n} x {dim} ({base_gb:.2f} GB allocated before the "
         f"build), IndexParams(graph_degree={CAGRA_DEGREE}): build "
         f"{build_s:.1f} s ("
         + ", ".join(f"{s} {v:.2f}s" for s, v in stages.items())
         + f"); card peak {peak_gb:.2f} GB; n_lists "
         f"{index.centers.shape[0]}; graph {tuple(index.graph.shape)}, "
         f"{n_neg} ids -1; intermediate graph edge recall "
         f"{edge_rec:.4f} on 1,000 rows (k {inter['knn_graph'].shape[1]})")
    _log(f"[cagra] launches {json.dumps(launches)}")
    _log(f"[cagra search] f32 itopk 64 width 8 iters 6: {m} queries at "
         f"batch {m}, cold then warm (CUDA events): "
         + ", ".join(f"{m / s:.0f}" for s in secs)
         + f" QPS; batch 10 latency {lat:.3f} ms (median of 20); "
         f"recall@10 {rec:.4f}")
    if i_f32.shape != (m, k) or bool((i_f32 < 0).any()):
        raise SmokeFailure("cagra search returned a malformed id table")

    # B4 at the build's predict shape: the scanned rows against the centers
    _argmin_row(rows, "cagra_build", launches, inter["build_rows"],
                inter["build_centers"].contiguous(), "predict ")
    del inter

    # int8 traversal: the quantized rows added to the same index
    codes, scale, zero = cagra._quantize_rows(base)
    index_q = dataclasses.replace(index, dataset_q=codes, q_scale=scale,
                                  q_zero=zero)
    sp8 = dataclasses.replace(sp, traverse="int8")
    secs8, _, i_8 = _cagra_passes(
        lambda qb: cagra.search(index_q, qb, k, sp8), queries, m)
    lat8 = _latency_ms(lambda qb: cagra.search(index_q, qb, k, sp8),
                       queries[:10])
    rec8 = _recall(i_8.cpu(), gt)
    _log(f"[cagra search] int8 traversal (+{codes.numel() / 1e9:.2f} GB "
         f"of codes): " + ", ".join(f"{m / s:.0f}" for s in secs8)
         + f" QPS; batch 10 latency {lat8:.3f} ms; recall@10 {rec8:.4f}")

    # filtered at selectivity 0.1
    keep = bench_keep(n, 0.1, k)
    bits = bitset.from_mask(keep)
    _, gt_f = brute_force.knn(brute_force.build(base, "sqeuclidean"), queries,
                              k, filter_bitset=bits)
    secs_f, _, i_f = _cagra_passes(
        lambda qb: cagra.search(index, qb, k, sp, filter_bitset=bits),
        queries, m)
    lat_f = _latency_ms(lambda qb: cagra.search(index, qb, k, sp,
                                                 filter_bitset=bits),
                        queries[:10])
    n_unfilled = _check_kept(i_f.cpu(), keep, "cagra filtered search")
    rec_f = _recall(i_f.cpu(), gt_f.cpu())
    _log(f"[cagra search] filtered, selectivity 0.1 ({int(keep.sum())} rows "
         f"kept): " + ", ".join(f"{m / s:.0f}" for s in secs_f)
         + f" QPS; batch 10 latency {lat_f:.3f} ms; recall@10 {rec_f:.4f} "
         f"against the filtered ground truth; {n_unfilled} slots -1")

    # the card's search against the same index searched on the CPU
    t0 = time.perf_counter()
    n_cmp = 100
    checks = cagra_card_vs_cpu(index, index_q, base, queries[:n_cmp], k, sp,
                               sp8, bits)
    _log(f"[cagra check] {n_cmp} queries, the card's search = the CPU's "
         f"but at f64 ties or at a traversal's rounding tie (swapped slots "
         + json.dumps({w: c["swapped"] for w, c in checks.items()})
         + "; queries split at a tie "
         + json.dumps({w: [(s_["query"], s_["selection"])
                           for s_ in c["splits"]]
                       for w, c in checks.items()})
         + f"; {time.perf_counter() - t0:.1f} s)")
    del index_q, codes, index
    torch.cuda.empty_cache()

    # the nn_descent build algorithm on the same rows
    nnd = cagra_nn_descent_leg(args, base, queries, gt, params, sp)
    # IVF-Flat's chunked pack on the same rows
    gist = gist_flat_leg(args, rows, base, queries, gt)

    # the ivf_pq build algorithm at GIST's width on CAGRA_PQ_N rows
    t0 = time.perf_counter()
    x_pq = base[:CAGRA_PQ_N].contiguous()
    del base
    torch.cuda.empty_cache()
    _, gt_pq = brute_force.knn_arrays(x_pq, queries, k, metric="sqeuclidean")
    spans.reset()
    K.reset_launch_counts()
    inter_pq, stages_pq = {}, {}
    t1 = time.perf_counter()
    index_pq = cagra.build(x_pq, dataclasses.replace(
        params, build_algo="ivf_pq"), stage_seconds=stages_pq,
        intermediates=inter_pq)
    torch.cuda.synchronize()
    build_pq_s = time.perf_counter() - t1
    tiers = {name: v for name, v in spans.counts().items()
             if name.endswith(".dispatch") or name.endswith(".fallback")}
    launches_pq = K.launch_counts()
    missing = [name for name in CAGRA_PQ_KERNELS if launches_pq[name] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the cagra ivf_pq "
                           f"build: {missing}")
    _, i_pq = cagra.search(index_pq, queries, k, sp)
    rec_pq = _recall(i_pq.cpu(), gt_pq.cpu())
    sample_pq = torch.from_numpy(np.random.default_rng(args.seed).choice(
        CAGRA_PQ_N, 1000, replace=False)).to(x_pq.device)
    edge_pq = _edge_recall(x_pq, inter_pq["knn_graph"], sample_pq,
                           inter_pq["knn_graph"].shape[1])
    pq_s = time.perf_counter() - t0
    _log(f"[cagra ivf_pq] {CAGRA_PQ_N} x {dim}, build_algo='ivf_pq': build "
         f"{build_pq_s:.1f} s (" + ", ".join(
             f"{s} {v:.2f}s" for s, v in stages_pq.items())
         + f"); intermediate graph edge recall {edge_pq:.4f} on "
         f"{sample_pq.numel()} rows; recall@10 {rec_pq:.4f}; tiers "
         f"{json.dumps(tiers)}; launches {json.dumps(launches_pq)} "
         f"(sub-leg {pq_s:.1f} s)")
    # its kernels against their plain versions at its shapes: B4 at the
    # IVF-PQ label pass's (all rows against the coarse centers), B3 at the
    # self-search's coarse select of one 16,384-row chunk
    centers_pq = inter_pq["build_centers"].contiguous()
    _argmin_row(rows, "cagra_ivf_pq", launches_pq, x_pq, centers_pq,
                "label pass ")
    n_probes = max(2, centers_pq.shape[0] // 8)
    scores = (x_pq[:16384] @ centers_pq.T).contiguous()
    _select_k_row(rows, "cagra_ivf_pq", launches_pq, scores, n_probes,
                  " (the self-search's coarse select of one chunk)",
                  bias=(centers_pq * centers_pq).sum(1))
    del x_pq, index_pq, inter_pq, centers_pq, scores
    torch.cuda.empty_cache()
    out = {"n": n, "dim": dim, "build_s": build_s, "build_stages_s": stages,
           "peak_gb": peak_gb, "edge_recall": edge_rec, "neg_ids": n_neg,
           "qps_f32": [m / s for s in secs], "latency10_ms_f32": lat,
           "recall_f32": rec, "qps_int8": [m / s for s in secs8],
           "latency10_ms_int8": lat8, "recall_int8": rec8,
           "qps_filtered": [m / s for s in secs_f],
           "latency10_ms_filtered": lat_f, "recall_filtered": rec_f,
           "card_cpu_swaps": {w: c["swapped"] for w, c in checks.items()},
           "card_cpu_splits": {w: c["splits"] for w, c in checks.items()},
           "nn_descent": nnd, "gist_flat": gist,
           "ivf_pq": {
               "n": CAGRA_PQ_N, "build_s": build_pq_s,
               "stages_s": stages_pq, "edge_recall": edge_pq,
               "recall": rec_pq, "tiers": tiers, "sub_leg_s": pq_s},
           "seconds": time.perf_counter() - t_leg}
    _log(f"[cagra] leg in {out['seconds']:.1f} s")
    return out


def gist_flat_leg(args, rows, base, queries, gt):
    """``[gist flat]`` (ROADMAP A10): ``gist.ivf_flat.n1024`` (bench.py:
    264-272: 1024 lists, spill, cap factor 1.25) on the ``[cagra]`` leg's
    1M x 960 rows. Its pack, (n + n_lists·L)·d·4 bytes, passes
    ``ivf_flat.PACK_CHUNKED_BYTES`` (8 GiB), so the build must take
    ``ivf_common.pack_rows_chunked`` (its dispatch counter must count one;
    the call is wrapped here to keep its labels and time its peak).
    Checks: the one-shot ``pack_lists`` of the same labels on the card
    equal to the build's chunked pack bit for bit (rows, ids, sizes, drop
    count), every row in the lists once or dropped (by the pack or as a
    spill marker), and both scans launched. Prints each pack's peak above
    what was allocated before it, QPS and recall@10 of approx search at
    n_probes 32 and 64 and exact at 32 (the queries of ``[cagra]``, batch
    1,000), and B5 and B6 against their plain versions at d 960 (rows
    ``gist_flat``). Raises SmokeFailure; returns the summary."""
    import torch

    from raft_tpu_torch.core import ids as ids_
    from raft_tpu_torch.neighbors import ivf_common, ivf_flat
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K

    t_leg = time.perf_counter()
    N, dim = base.shape
    nq, k = queries.shape[0], 10
    n_lists = 1024
    packer = ivf_common.pack_rows_chunked
    seen = {}

    def watched(x, labels, n_lists_, L, chunk_rows=1 << 17):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = packer(x, labels, n_lists_, L, chunk_rows=chunk_rows)
        torch.cuda.synchronize()
        seen.update(labels=labels.clone(), L=L, chunk_rows=chunk_rows,
                    s=time.perf_counter() - t0,
                    peak=torch.cuda.max_memory_allocated() - before)
        return out

    spans.reset()
    K.reset_launch_counts()
    stages = {}
    ivf_common.pack_rows_chunked = watched
    try:
        t0 = time.perf_counter()
        index = ivf_flat.build(base, ivf_flat.IndexParams(
            n_lists=n_lists, spill=True, list_size_cap_factor=1.25,
            seed=args.seed), stage_seconds=stages)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        ivf_common.pack_rows_chunked = packer
    L = index.max_list_size
    pack_bytes = (N + n_lists * L) * dim * 4
    chunked = spans.total("ivf_flat.pack.dispatch", impl="pack_rows_chunked")
    if chunked != 1 or "labels" not in seen:
        raise SmokeFailure(f"[gist flat]: the pack of {pack_bytes} bytes did "
                           f"not take pack_rows_chunked (counter {chunked})")
    labels = seen.pop("labels")
    n_marker = int((labels >= n_lists).sum())
    # the one-shot pack of the same labels, its peak above what it found
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (one,), one_ids, one_sizes, one_drop, _ = ivf_common.pack_lists(
        [base], labels, ids_.make_ids(N, device=base.device),
        n_lists=n_lists, L=L, fill_values=[0])
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated() - before
    n_drop = N - index.size - n_marker
    same = (torch.equal(one, index.packed_data)
            and torch.equal(one_ids, index.packed_ids)
            and torch.equal(one_sizes, index.list_sizes)
            and one_drop == n_drop)
    del one, one_ids, one_sizes
    torch.cuda.empty_cache()
    got = index.packed_ids[index.packed_ids >= 0]
    once = int(torch.unique(got).numel()) == got.numel() == index.size
    _log(f"[gist flat] gist.ivf_flat.n1024 on {N} x {dim}: build "
         f"{build_s:.2f} s (" + ", ".join(
             f"{s_} {v:.2f}s" for s_, v in stages.items())
         + f"); L = {L}; pack {pack_bytes / 1e9:.2f} GB > 8 GiB: "
         f"pack_rows_chunked ({seen['chunk_rows']}-row chunks) "
         f"{seen['s']:.2f} s, peak +{seen['peak'] / 1e9:.2f} GB; one-shot "
         f"pack_lists {one_s:.2f} s, peak +{one_peak / 1e9:.2f} GB; equal bit "
         f"for bit: {same}; rows dropped by the pack {n_drop}, spill markers "
         f"{n_marker}, every other row once: {once}")
    if not same:
        raise SmokeFailure("[gist flat]: the chunked pack differs from the "
                           "one-shot pack_lists")
    if not once:
        raise SmokeFailure("[gist flat]: a row is in the lists twice, or a "
                           "row is missing uncounted")

    def timed(params):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ivf_flat.search(index, queries, k, params)
        end.record()
        torch.cuda.synchronize()
        return out[1].cpu(), start.elapsed_time(end) / 1e3

    legs = {}
    for name, n_probes, select in (("approx_32", 32, "approx"),
                                   ("approx_64", 64, "approx"),
                                   ("exact_32", 32, "exact")):
        secs = []
        for _ in range(3):
            ids, t = timed(ivf_flat.SearchParams(
                n_probes=n_probes, scan_mode="grouped", scan_select=select))
            secs.append(t)
        legs[name] = {"qps": [nq / t for t in secs],
                      "recall_at_10": _recall(ids, gt)}
        _log(f"[gist flat] {name}: QPS " + ", ".join(
            f"{nq / t:.0f}" for t in secs) + f" (batch {nq}, CUDA events); "
            f"recall@10 {legs[name]['recall_at_10']:.4f}")
    launches = K.launch_counts()
    tier = ("the segmented scan (B5)" if launches["segmented_scan_topk"]
            else "the plain grouped tier")
    _log(f"[gist flat] approx at d {dim} ran {tier}; launches "
         f"{json.dumps(launches)}")
    missing = [n for n in FLAT_KERNELS if launches[n] == 0]
    if missing:
        raise SmokeFailure(f"[gist flat]: kernels never launched: {missing}")

    # B5 and B6 at d 960 on the n_probes 32 segment table
    mt = ivf_flat.resolve_metric(index.metric)
    seg = ivf_common.SEGMENT_SIZE
    probes = ivf_flat._probes(index, queries, 32, mt)
    n_seg = ivf_common.n_segments(nq * 32, n_lists, seg)
    seg_list, seg_q, _, _ = ivf_common.segment_probes(probes, n_lists, seg,
                                                      n_seg)
    qrow = seg_q.clamp_min(0).long()
    lst_of = seg_list.long()

    def key_of(si, sj, picks5, picks6):
        qv = queries[qrow[si, sj]].double()
        x = (base[picks5.long()] if picks5 is not None
             else index.packed_data[lst_of[si], picks6.long()]).double()
        return ((qv - x) ** 2).sum(1)

    _scan_rows(rows, "gist_flat", launches, seg_list, seg_q, queries,
               index.packed_data, index.packed_ids, index.list_sizes.long(),
               k, key_of, "")
    del index, labels
    torch.cuda.empty_cache()
    return {"build_s": build_s, "build_stages_s": stages, "L": L,
            "pack_bytes": pack_bytes, "chunked_pack_s": seen["s"],
            "chunked_pack_peak": seen["peak"], "one_shot_pack_s": one_s,
            "one_shot_pack_peak": one_peak, "dropped": n_drop,
            "spill_markers": n_marker, "legs": legs, "tier": tier,
            "launches": launches, "seconds": time.perf_counter() - t_leg}


def cagra_nn_descent_leg(args, base, queries, gt, params, sp):
    """``[cagra nn_descent]``: ``cagra.build`` with ``build_algo=
    "nn_descent"`` on the leg's rows (the auto 128-d projection,
    intermediate degree 128, ``nn_descent_niter`` 20 sweeps of 8 samples),
    its seconds by stage and the card's peak, the graph's invariants
    (``_cagra_graph_checks``), the intermediate graph's edge recall on
    1,000 sampled rows, the f32 search's QPS (a cold then two warm passes
    at batch 1,000) and recall@10 with the leg's ``SearchParams``; then
    ``nn_descent.build_knn_graph_with_distances`` on ``CAGRA_NND_EXACT_N`` x
    16 small-integer rows on the card and on the CPU, equal bit for bit in
    ids and distances (every f32 sum there is exact in any order)."""
    import dataclasses

    import numpy as np
    import torch

    from raft_tpu_torch.neighbors import cagra, nn_descent

    t_leg = time.perf_counter()
    n, m, k = base.shape[0], queries.shape[0], 10
    pn = dataclasses.replace(params, build_algo="nn_descent")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stages, inter = {}, {}
    t0 = time.perf_counter()
    index = cagra.build(base, pn, stage_seconds=stages, intermediates=inter)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    knn = inter.pop("knn_graph")
    del inter
    n_neg = _cagra_graph_checks(index, knn, n)
    sample = torch.from_numpy(np.random.default_rng(args.seed + 1).choice(
        n, 1000, replace=False)).to(base.device)
    edge_rec = _edge_recall(base, knn, sample, knn.shape[1])
    del knn
    secs, _, ids = _cagra_passes(lambda qb: cagra.search(index, qb, k, sp),
                                 queries, m)
    rec = _recall(ids.cpu(), gt)
    _log(f"[cagra nn_descent] {n} x {base.shape[1]}, IndexParams("
         f"build_algo='nn_descent', intermediate_graph_degree="
         f"{pn.intermediate_graph_degree}, graph_degree={pn.graph_degree}, "
         f"nn_descent_niter={pn.nn_descent_niter}): build {build_s:.1f} s ("
         + ", ".join(f"{s} {v:.2f}s" for s, v in stages.items())
         + f"); card peak {peak_gb:.2f} GB; {n_neg} ids -1; intermediate "
         f"graph edge recall {edge_rec:.4f} on 1,000 rows; f32 search "
         + ", ".join(f"{m / s:.0f}" for s in secs)
         + f" QPS (cold, warm, warm); recall@10 {rec:.4f}")
    if ids.shape != (m, k) or bool((ids < 0).any()):
        raise SmokeFailure("cagra nn_descent search returned a malformed id "
                           "table")
    del index, ids

    # card = CPU bit for bit on small-integer rows
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(args.seed)
    xi = torch.randint(-8, 9, (CAGRA_NND_EXACT_N, 16), generator=g).float()
    kw = dict(n_iters=6, seed=args.seed)
    ic_, dc = nn_descent.build_knn_graph_with_distances(xi.cuda(), 32, **kw)
    ip_, dp = nn_descent.build_knn_graph_with_distances(xi, 32, device="cpu",
                                                        **kw)
    if not (torch.equal(ic_.cpu(), ip_) and torch.equal(
            dc.cpu().view(torch.int32), dp.view(torch.int32))):
        raise SmokeFailure(
            f"nn_descent on {CAGRA_NND_EXACT_N} x 16 integer rows: the card "
            f"differs from the CPU ({int((ic_.cpu() != ip_).sum())} ids)")
    _log(f"[cagra nn_descent] {CAGRA_NND_EXACT_N} x 16 small-integer rows, "
         f"k 32, 6 sweeps: the card's graph and distances = the CPU's bit "
         f"for bit ({time.perf_counter() - t0:.1f} s)")
    return {"build_s": build_s, "build_stages_s": stages,
            "peak_gb": peak_gb, "neg_ids": n_neg, "edge_recall": edge_rec,
            "qps_f32": [m / s for s in secs], "recall_f32": rec,
            "seconds": time.perf_counter() - t_leg}


def _on_sphere(v):
    """Rows of 3-d points → (lat, lon) radians of their directions from
    the cube's centre (``DeviceSynthetic`` draws centers in [0, 10)³)."""
    import torch

    c = (v - 5.0).double()
    r = c.norm(dim=1)
    return torch.stack([torch.asin(c[:, 2] / r),
                        torch.atan2(c[:, 1], c[:, 0])], 1).float()


def _f64_dists(q, rows, metric):
    """f64 distances of q [r, d] to rows [r, d] (pairwise by row) or, with
    rows [n, d] and q [m, d] broadcast as [m, 1, d] / [1, n, d], [m, n]."""
    import torch

    q, rows = q.double(), rows.double()
    if metric == "haversine":
        lat1, lon1, lat2, lon2 = q[..., 0], q[..., 1], rows[..., 0], \
            rows[..., 1]
        h = (torch.sin(0.5 * (lat2 - lat1)) ** 2 + torch.cos(lat1)
             * torch.cos(lat2) * torch.sin(0.5 * (lon2 - lon1)) ** 2)
        return 2.0 * torch.asin(torch.sqrt(h.clamp(0.0, 1.0)))
    return ((q - rows) ** 2).sum(-1).sqrt()


def _metric_tie_swaps(q, x, ids_a, d_a, ids_b, d_b, metric, what,
                      rtol: float = 1e-5, atol: float = 1e-7):
    """Two [m, k] kNN results over rows ``x`` in ``metric`` (euclidean or
    haversine distances, not squared): the same +inf slots, distances
    within ``rtol`` relative + ``atol``, and where the ids differ the two
    picks' f64 distances to the query within the same tolerance. Returns
    the count of such slots."""
    import torch

    ia, ib = ids_a.cpu(), ids_b.cpu()
    da, db = d_a.cpu().double(), d_b.cpu().double()
    fin = torch.isfinite(db)
    if not torch.equal(torch.isfinite(da), fin):
        raise SmokeFailure(f"{what}: the +inf slots differ")
    tol = atol + rtol * db[fin].abs()
    if bool(((da[fin] - db[fin]).abs() > tol).any()):
        raise SmokeFailure(f"{what}: distances differ by "
                           f"{float((da[fin] - db[fin]).abs().max()):.3g}")
    r, c = torch.nonzero(ia != ib, as_tuple=True)
    if r.numel():
        qr = q[r.to(q.device)]
        fa = _f64_dists(qr, x[ia[r, c].long().to(x.device)], metric)
        fb = _f64_dists(qr, x[ib[r, c].long().to(x.device)], metric)
        bad = (fa - fb).abs() > atol + rtol * fb.abs()
        if bool(bad.any()):
            i = int(torch.nonzero(bad)[0])
            raise SmokeFailure(
                f"{what}: ids differ away from an f64 tie (query {int(r[i])}"
                f", slot {int(c[i])}: {float(fa[i]):.9f} against "
                f"{float(fb[i]):.9f})")
    return int(r.numel())


def _ball_cover_round_scores(index, q, k, round_lists, metric):
    """The first probe round's merge input: [m, k + round_lists ·
    max_list], the carried +inf best then the round's candidate
    distances (+inf on pad slots), as ``ball_cover.knn`` builds it."""
    import torch

    from raft_tpu_torch.distance import pairwise_distance
    from raft_tpu_torch.neighbors import ball_cover

    mt = ball_cover._true_metric(metric)
    order = torch.sort(pairwise_distance(q, index.landmarks, metric=mt),
                       dim=1, stable=True)[1][:, :round_lists]
    cand = index.packed_data[order].reshape(q.shape[0], -1, index.dim)
    cid = index.packed_ids[order].reshape(q.shape[0], -1)
    d = ball_cover._cand_dists(q, cand, mt)
    d = torch.where(cid >= 0, d, torch.full_like(d, float("inf")))
    return torch.cat([torch.full((q.shape[0], k), float("inf"),
                                 device=q.device), d], 1).contiguous()


def _ball_cover_metric(args, rows, x, q, metric, k):
    """One metric of ``[ball_cover]``: build, three passes of knn, the
    checks and (euclidean) the B3 row; returns its summary."""
    import torch

    from raft_tpu_torch.neighbors import ball_cover, brute_force
    from raft_tpu_torch.ops import kernels as K

    n, m = x.shape[0], q.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    K.reset_launch_counts()
    t0 = time.perf_counter()
    index = ball_cover.build(x, metric, n_landmarks=BALL_LANDMARKS,
                             seed=args.seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    max_list = index.packed_data.shape[1]
    secs, stats = [], {}
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        d, ids = ball_cover.knn(index, q, k, round_lists=BALL_ROUND_LISTS,
                                stats=stats)
        end.record()
        torch.cuda.synchronize()
        secs.append(start.elapsed_time(end) / 1e3)
    launches = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    missing = [name for name in BALL_KERNELS if launches[name] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the ball cover path "
                           f"({metric}): {missing}")
    if ids.shape != (m, k) or bool((ids < 0).any()):
        raise SmokeFailure(f"ball cover {metric}: malformed id table")
    _log(f"[ball_cover] {metric}: {n} rows, L {index.n_landmarks}, largest "
         f"list {max_list}: build {build_s:.2f} s; knn of {m} queries, k "
         f"{k}, round_lists {BALL_ROUND_LISTS}: "
         + ", ".join(f"{m / s:.0f}" for s in secs)
         + f" QPS (cold, warm, warm; CUDA events); probe rounds "
         f"{stats['rounds']} (query tile {stats['tile']}); card peak "
         f"{peak_gb:.2f} GB ({before_gb:.2f} GB before the build); "
         f"launches {json.dumps(launches)}")

    # the same metric by brute force (the general path)
    t0 = time.perf_counter()
    gd, gi = brute_force.knn_arrays(x, q, k, metric="l2_sqrt_unexpanded"
                                    if metric == "euclidean" else "haversine")
    swaps_bf = _metric_tie_swaps(q, x, ids, d, gi, gd, metric,
                                 f"ball cover {metric} vs brute force")
    # the first 100 queries on the same index on the CPU
    n_cmp = min(100, m)
    cpu_index = ball_cover.from_numpy(*ball_cover.to_numpy(index),
                                      device="cpu")
    dc, ic_ = ball_cover.knn(cpu_index, q[:n_cmp].cpu(), k,
                             round_lists=BALL_ROUND_LISTS, device="cpu")
    swaps_cpu = _metric_tie_swaps(q[:n_cmp], x, ids[:n_cmp], d[:n_cmp], ic_,
                                  dc, metric, f"ball cover {metric} card "
                                  f"vs CPU")
    del cpu_index
    # eps_nn at the median 10th-neighbour distance against f64 thresholding
    eps = float(d[:n_cmp, -1].median())
    keep, kid = ball_cover.eps_nn(index, q[:n_cmp], eps)
    got = torch.zeros((n_cmp, n), dtype=torch.bool, device=x.device)
    r, c = torch.nonzero(keep, as_tuple=True)
    got[r, kid[c].long()] = True
    d64 = torch.cat([_f64_dists(q[a:a + 10, None, :], x[None], metric)
                     for a in range(0, n_cmp, 10)])
    want = d64 <= eps
    diff = got ^ want
    bad = diff & ((d64 - eps).abs() > 1e-5 * eps + 1e-7)
    if bool(bad.any()):
        raise SmokeFailure(f"ball cover {metric} eps_nn: {int(bad.sum())} "
                           f"pairs differ from thresholding away from eps")
    _log(f"[ball_cover check] {metric}: ids = brute_force.knn's but at f64 "
         f"ties ({swaps_bf} slots), the first {n_cmp} queries on the card = "
         f"on the CPU but at f64 ties ({swaps_cpu} slots); eps_nn at eps "
         f"{eps:.6g} on {n_cmp} queries: {int(got.sum())} pairs, "
         f"{int(diff.sum())} within f32 rounding of eps "
         f"({time.perf_counter() - t0:.1f} s)")
    del got, d64, want, diff, bad, keep
    if metric == "euclidean":
        scores = _ball_cover_round_scores(index, q, k, BALL_ROUND_LISTS,
                                          metric)
        _select_k_row(rows, "ball_cover", launches, scores, k,
                      " (one probe round's merge)")
        del scores
    return {"build_s": build_s, "n_landmarks": index.n_landmarks,
            "max_list": max_list, "qps": [m / s for s in secs],
            "rounds": stats["rounds"], "tile": stats["tile"],
            "peak_gb": peak_gb, "launches": launches,
            "swaps_brute_force": swaps_bf, "swaps_cpu": swaps_cpu,
            "eps": eps}


def eps_leg(base):
    """``[eps]``: ``eps_neighbors_l2sq`` of the first ``EPS_ROWS`` rows
    against all of them, ``eps_sq`` the median squared distance to a row's
    30th nearest row (a DBSCAN-style neighbourhood; the mean degree must be
    20–50); its seconds and the card's peak. Checks: ``vd ==
    adj.sum(1)``, and the first 100 rows equal the CPU's except pairs
    within the expanded form's f32 rounding of ``eps_sq``."""
    import torch

    from raft_tpu_torch.neighbors import brute_force, epsilon_neighborhood

    xq = base[:EPS_ROWS]
    dk, _ = brute_force.knn_arrays(base, xq, 30, metric="sqeuclidean")
    eps_sq = float(dk[:, -1].median())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    adj, vd = epsilon_neighborhood.eps_neighbors_l2sq(xq, base, eps_sq)
    end.record()
    torch.cuda.synchronize()
    secs = start.elapsed_time(end) / 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mean_deg = float(vd.float().mean())
    if not torch.equal(vd, adj.sum(1, dtype=torch.int32)):
        raise SmokeFailure("eps_neighbors_l2sq: vd != adj.sum(1)")
    if not 20.0 <= mean_deg <= 50.0:
        raise SmokeFailure(f"eps: mean degree {mean_deg} outside 20-50")
    n_cmp = 100
    adj_c, _ = epsilon_neighborhood.eps_neighbors_l2sq(
        xq[:n_cmp].cpu(), base.cpu(), eps_sq, device="cpu")
    r, c = torch.nonzero(adj[:n_cmp].cpu() ^ adj_c, as_tuple=True)
    if r.numel():
        qa = xq[:n_cmp].cpu().double()[r]
        ya = base.cpu().double()[c]
        d64 = ((qa - ya) ** 2).sum(1)
        tol = 1e-5 * ((qa * qa).sum(1) + (ya * ya).sum(1)) + 1e-6
        if bool(((d64 - eps_sq).abs() > tol).any()):
            raise SmokeFailure("eps_neighbors_l2sq: the card differs from "
                               "the CPU away from eps_sq")
    _log(f"[eps] eps_neighbors_l2sq of {EPS_ROWS} rows against "
         f"{base.shape[0]} x {base.shape[1]}: eps_sq {eps_sq:.6g} (median "
         f"30th-neighbour squared distance), mean degree {mean_deg:.2f}, "
         f"{secs * 1e3:.2f} ms (CUDA events); card peak {peak_gb:.2f} GB "
         f"({before_gb:.2f} GB before); the first {n_cmp} rows = the CPU's "
         f"but {int(r.numel())} pairs within f32 rounding of eps_sq")
    return {"eps_sq": eps_sq, "mean_degree": mean_deg, "seconds": secs,
            "peak_gb": peak_gb, "cpu_edge_pairs": int(r.numel())}


def ball_cover_leg(args, rows):
    """``[ball_cover]`` (ROADMAP A16): ``BALL_N`` x 3 ``DeviceSynthetic``
    rows (users: exact kNN over point clouds) and the same rows on the
    unit sphere as (lat, lon) radians (users: exact kNN over geographic
    points) with ``BALL_QUERIES`` queries, k 10: ``ball_cover.build`` with
    ``BALL_LANDMARKS`` landmarks, counts zeroed before it and read after
    three passes of ``knn`` at ``BALL_ROUND_LISTS`` lists a round (select_k
    must have launched); prints build seconds, L, the largest list, the
    rounds taken, QPS (CUDA events: a cold then two warm passes) and the
    card's peak. Checks per metric: ids equal ``brute_force.knn`` with the
    same metric (``l2_sqrt_unexpanded`` or ``haversine``: the general path)
    but at f64 ties; the first 100 queries on the card equal the same index
    searched on the CPU but at f64 ties; ``eps_nn`` on 100 queries at the
    median 10th-neighbour distance equal to f64 thresholding but within f32
    rounding of eps; and select_k at one probe round's merge shape against
    its plain version (row ``ball_cover``). Then ``[eps]`` on the
    euclidean rows (``eps_leg``)."""
    import torch

    from raft_tpu_torch.bench.dataset import DeviceSynthetic

    t_leg = time.perf_counter()
    ds = DeviceSynthetic(BALL_N, 3, n_centers=10_000, seed=args.seed + 5)
    base = ds.base()
    queries = ds.queries(BALL_QUERIES)
    out = {"euclidean": _ball_cover_metric(args, rows, base, queries,
                                           "euclidean", 10)}
    torch.cuda.empty_cache()
    out["haversine"] = _ball_cover_metric(args, rows, _on_sphere(base),
                                          _on_sphere(queries), "haversine",
                                          10)
    torch.cuda.empty_cache()
    out["eps"] = eps_leg(base)
    out["seconds"] = time.perf_counter() - t_leg
    _log(f"[ball_cover] leg in {out['seconds']:.1f} s")
    return out


def dist_build_phase(args, rows):
    """``[dist build]``: the SIFT-1B-shaped distributed build (BASELINE.md
    target 5 as ``__graft_entry__.py:615-754`` rehearses it: 128-d, 8192
    lists, pq_dim 64, 8-bit, the sharded phase's k-means iterations, list
    cap 4; ``chunk_rows = 1 << 20``, ``tools/build_deep100m.py:50``'s) over
    ``DeviceSyntheticChunks``, ``DIST_RANK_CHUNKS`` chunks a rank on 4
    ranks sharing the card, ``spill=False``. Under
    ``torch.use_deterministic_algorithms(True)``: ``ivf_pq.
    build_distributed`` then ``ivf_pq.build_chunked`` of the same provider
    and parameters; their quantizers equal and ``index_sha16(
    assemble_ivf_pq(sharded)) == index_sha16(chunked)`` (on a mismatch the
    fields that differ, in how many rows); every row in the shards once
    or counted as dropped; the build's comms ``allgatherv`` only; then the
    per-shard output searched directly: refined (n_probes 64,
    refine_ratio 40, bf16 LUT, ``scan_select="pallas"``, batch 500,
    re-ranked against each rank's rows on the card) with recall@10 ≥ 0.95
    on 1,000 queries against ``compute_groundtruth``'s streamed truth, and
    the fused tier (B8) at batch 32 with an f32 LUT. Counts zeroed before
    the distributed build and read after the fused tier: B1–B4, B7, B8
    must have launched. Logs stage seconds, prefetch hits and stalls, the
    card's peak memory and QPS; then B4 at the label pass's chunk against
    its plain version, and the resume check. Returns the summary."""
    import numpy as np
    import torch

    from raft_tpu_torch.bench.dataset import (Dataset, DeviceSyntheticChunks,
                                              compute_groundtruth)
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.parallel import (assemble_ivf_pq, comms,
                                         index_sha16, make_mesh, shard_ranges)
    from raft_tpu_torch.parallel import ivf as pivf

    chunk = 1 << 20
    n_chunks = DIST_RANK_CHUNKS
    N, dim, B, k = SHARD_RANKS * n_chunks * chunk, SHARD_DIM, 500, 10
    nq, n_gt = 10_000, 1000
    dev = torch.device("cuda", 0)
    mesh = make_mesh(SHARD_RANKS, device="cuda:0")
    ds = DeviceSyntheticChunks(N, dim, n_centers=10_000, seed=args.seed,
                               chunk_rows=chunk, device=dev)
    params = ivf_pq.IndexParams(n_lists=8192, pq_dim=64, pq_bits=8,
                                spill=False, cache_reconstruction="never",
                                seed=args.seed)
    _log(f"[dist data] DeviceSyntheticChunks {N} x {dim} f32 "
         f"({N * dim * 4 / 1e9:.1f} GB, never whole), {n_chunks} "
         f"chunks of {chunk} rows a rank on {SHARD_RANKS} ranks sharing "
         f"cuda:0")

    # the path: both builds, the searches; counts zeroed just before
    K.reset_launch_counts()
    spans.reset()
    comms.reset_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    st_d, st_c = {}, {}
    with deterministic():
        t0 = time.perf_counter()
        sharded = ivf_pq.build_distributed(ds, params, mesh=mesh,
                                           chunk_rows=chunk,
                                           stage_seconds=st_d)
        torch.cuda.synchronize()
        dist_s = time.perf_counter() - t0
        peak_d = torch.cuda.max_memory_allocated(dev) / 1e9
        build_comms = comms.counters()
        pf = {kind: spans.total(f"build.prefetch.{kind}",
                                site="ivf_pq.build_distributed")
              for kind in ("hit", "stall")}
        dropped = int(spans.total("ivf_pq.build.dropped",
                                  site="ivf_pq.build_distributed"))
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        chunked = ivf_pq.build_chunked(ds, params, chunk_rows=chunk,
                                       device=dev, stage_seconds=st_c)
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - t0
        peak_c = torch.cuda.max_memory_allocated(dev) / 1e9
    _log(f"[dist build] build_distributed {dist_s:.1f} s ("
         + ", ".join(f"{s} {v:.1f}s" for s, v in st_d.items())
         + f"), card peak {peak_d:.2f} GB, prefetch {json.dumps(pf)}, "
         f"global L {sharded.global_list_cap}, L_shard "
         f"{sharded.max_list_size}, rows dropped {dropped}; build_chunked "
         f"{chunked_s:.1f} s ("
         + ", ".join(f"{s} {v:.1f}s" for s, v in st_c.items())
         + f"), card peak {peak_c:.2f} GB, L {chunked.max_list_size}")
    ops = {f"{op}/{a}": n for (op, a), n in build_comms["ops"].items()}
    if set(build_comms["ops"]) != {("allgatherv", "shard")}:
        raise SmokeFailure(f"the distributed build's comms are not "
                           f"allgatherv only: {ops}")
    t0 = time.perf_counter()
    sha_c = index_sha16(chunked)
    asm = assemble_ivf_pq(sharded, device="cpu")
    sha_d = index_sha16(asm)
    sha_s = time.perf_counter() - t0
    q_equal = all(torch.equal(getattr(asm, f).cpu(), getattr(chunked, f).cpu())
                  for f in ("centers", "rotation", "centers_rot", "codebooks"))
    if sha_d != sha_c or not q_equal:
        raise SmokeFailure(f"[dist build] assemble_ivf_pq(build_distributed)"
                           f" sha {sha_d} != build_chunked's {sha_c}; "
                           f"quantizers equal: {q_equal}; rows differing by "
                           f"field: {json.dumps(_sha_mismatch(asm, chunked))}")
    del asm, chunked
    torch.cuda.empty_cache()
    # every row once or dropped
    ids = torch.cat([t[t >= 0] for t in sharded.packed_ids]).long()
    srt = torch.sort(ids)[0]
    if (srt.numel() + dropped != N or int(srt[0]) < 0 or int(srt[-1]) >= N
            or bool((srt[1:] == srt[:-1]).any())
            or srt.numel() != sharded.size):
        raise SmokeFailure(f"[dist build] {srt.numel()} ids in the shards, "
                           f"{dropped} dropped, of {N}, or an id twice")
    del ids, srt
    _log(f"[dist build] index_sha16(assemble_ivf_pq(sharded)) = "
         f"index_sha16(build_chunked) = {sha_d}, quantizers equal "
         f"({sha_s:.1f} s to assemble and hash); every row in the shards "
         f"once or dropped ({dropped}); comms ops {json.dumps(ops)}, bytes "
         + json.dumps({f"{op}/{a}": n
                       for (op, a), n in build_comms["bytes"].items()}))

    # the per-shard output, searched directly
    queries = ds.queries(nq)
    ranges, _ = shard_ranges(N, SHARD_RANKS)
    t0 = time.perf_counter()
    shards = [ds[lo:hi] for lo, hi in ranges]
    torch.cuda.synchronize()
    _log(f"[dist search] re-rank base: each rank's {ranges[0][1]} rows on "
         f"the card ({sum(s.numel() for s in shards) * 4 / 1e9:.1f} GB) in "
         f"{time.perf_counter() - t0:.1f} s")
    sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                             refine="f32_regen", refine_ratio=40,
                             lut_dtype="bfloat16")

    def search_pass():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        start.record()
        for a in range(0, nq, B):
            out.append(pivf.search_ivf_pq(sp, sharded, queries[a:a + B], k,
                                          mesh, dataset=shards)[1])
        end.record()
        torch.cuda.synchronize()
        return torch.cat(out), start.elapsed_time(end) / 1e3

    spans.reset()
    ids_r, t_cold = search_pass()
    disp = spans.counts().get("parallel.merge.dispatch", {})
    qps = [nq / t_cold] + [nq / search_pass()[1] for _ in range(2)]
    spf = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                              lut_dtype="float32")
    lat = []
    spans.reset()
    for c in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fv, fi = pivf.search_ivf_pq(spf, sharded, queries[c * 32:(c + 1) * 32],
                                    k, mesh)
        end.record()
        torch.cuda.synchronize()
        lat.append(start.elapsed_time(end))
        if fi.shape != (32, k) or bool((fi < 0).any()) or not bool(
                torch.isfinite(fv).all()):
            raise SmokeFailure("[dist search] the fused tier returned a "
                               "malformed result")
    fdisp = spans.counts().get("parallel.merge.dispatch", {})
    if fdisp.get("ring_fused_scan", 0) != 20:
        raise SmokeFailure(f"[dist search] the fused tier was not taken: "
                           f"{fdisp}")
    launches = K.launch_counts()
    _log(f"[dist] launches {json.dumps(launches)}")
    missing = [n for n in SHARD_KERNELS if launches[n] == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the distributed "
                           f"build's path: {missing}")
    t0 = time.perf_counter()
    gtds = compute_groundtruth(Dataset("sift1b-synth", ds, queries), k=k,
                               chunk_rows=chunk, max_queries=n_gt,
                               device=dev)
    gt_s = time.perf_counter() - t0
    rec = _recall(ids_r[:n_gt].cpu(), gtds.groundtruth)
    _log(f"[dist search] refined, batch {B}, n_probes 64, refine_ratio 40, "
         f"bf16 LUT, merge auto -> {json.dumps(disp)}: "
         + ", ".join(f"{x:.0f}" for x in qps) + " QPS (CUDA events; cold "
         f"pass first); recall@10 {rec:.4f} on {n_gt} queries against the "
         f"streamed ground truth ({gt_s:.1f} s); fused tier, batch 32, f32 "
         f"LUT: per call ms median {float(np.median(lat)):.3f} (min "
         f"{min(lat):.3f}) over 20 calls, {json.dumps(fdisp)}")
    if not rec >= 0.95:
        raise SmokeFailure(f"[dist search] refined recall@10 {rec} < 0.95")
    del shards
    torch.cuda.empty_cache()

    xa = ds[0:chunk].contiguous()
    _argmin_row(rows, "dist_build", launches, xa,
                sharded.centers[0].contiguous(), "the label pass's chunk, ")
    del xa, sharded
    torch.cuda.empty_cache()
    with deterministic():
        resume = dist_resume_check(args, params, chunk, mesh)
    return {"n": N, "dim": dim, "ranks": SHARD_RANKS,
            "rank_chunks": n_chunks, "dist_build_s": dist_s,
            "dist_stages_s": st_d, "chunked_build_s": chunked_s,
            "chunked_stages_s": st_c, "card_peak_gb": [peak_d, peak_c],
            "prefetch": pf, "rows_dropped": dropped, "sha": sha_d,
            "comms_ops": ops, "qps": qps, "recall_at_10": rec,
            "fused_ms_median": float(np.median(lat)), "launches": launches,
            "resume": resume}


# ---------------------------------------------------------------------------
# k-means whole, brute force's index API, one axis of a 2-D mesh,
# the kernel tri-states
# ---------------------------------------------------------------------------

KMEANS_N = 1_000_000
KMEANS_DIM = 128
KMEANS_K = 1_000
KMEANS_ITERS = 25
KMEANS_MB_BATCH = 65_536
KMEANS_MB_ITERS = 100
# a row lies ~11.3 from its center, centers ~46 apart: at std 0.5 the
# clusters part so far that k-means++'s missed clusters, not the
# optimizer, decide every cost comparison; at 2.0 they merge so far that
# any init ends near the same cost (CPU runs at 100-300 clusters)
KMEANS_STD = 1.0
FIND_K_N = 200_000
FIND_K_CENTERS = 12
FIND_K_MAX = 16
BF_QUERIES = 10_000
BF_PARTS = 8
AXIS_N = 2_000_000
AXIS_DIM = 96
AXIS_QUERIES = 1_000


def kmeans_leg(args, rows):
    """``[kmeans]`` (ROADMAP A5): SIFT-1M's shape, ``KMEANS_N`` x
    ``KMEANS_DIM`` ``DeviceSynthetic`` rows around 1,000 centers. With the
    counts zeroed just before and read just after: ``kmeans.fit`` (1,000
    clusters, k-means++, 25 sweeps, tol 1e-4) with its init and Lloyd
    timed by their sync-mode spans, the same fit with ``init="random"``,
    and ``fit_minibatch`` (batch 65,536, 100 steps) from the ++ fit's own
    seeds; B4 must have launched. Checks: ``cluster_cost`` of the final centers equals the
    inertia of one more sweep from them (``fit(init="array",
    max_iter=1)``: ``fit``'s inertia is the cost of its last sweep's
    assignment, as in the JAX package, so it is at least the final
    centers' cost, which is checked too); ``predict`` equals
    ``fused_l2_argmin_plain`` but at f32 ties (B4's row at [1,000,000,
    128] x [1,000, 128], ``torch.matmul``'s time beside it); the ++ fit's
    inertia at most the random init's; the mini-batch cost within 10 % of
    full Lloyd's. Then ``find_k`` up to ``FIND_K_MAX`` on ``FIND_K_N``
    rows of 12 well-separated centers returns 12 (the elbow rule picks
    from 3 … k_max − 1, so k_max 12 could not). Returns the data for the
    ``[bf index]`` leg and the summary."""
    import torch

    from raft_tpu_torch import obs
    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.random import threefry
    from raft_tpu_torch.random.rng import RngState

    ds = DeviceSynthetic(KMEANS_N, KMEANS_DIM, n_centers=KMEANS_K,
                         seed=args.seed, std=KMEANS_STD, scale=10.0)
    x = ds.base()
    torch.cuda.synchronize()
    p = kmeans.KMeansParams(n_clusters=KMEANS_K, max_iter=KMEANS_ITERS,
                            tol=1e-4, seed=args.seed)
    K.reset_launch_counts()
    reg = obs.MetricsRegistry()
    obs.enable(sync=True, registry=reg)
    try:
        t0 = time.perf_counter()
        c, inertia, n_iter = kmeans.fit(p, x)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        obs.disable()
    hists = reg.snapshot()["histograms"]
    init_s = hists["span.kmeans.fit.init"]["sum"]
    lloyd_s = hists["span.kmeans.fit.lloyd"]["sum"]
    t0 = time.perf_counter()
    c_r, inertia_r, n_iter_r = kmeans.fit(
        kmeans.KMeansParams(**{**p.__dict__, "init": "random"}), x)
    torch.cuda.synchronize()
    fit_r_s = time.perf_counter() - t0
    # the mini-batch fit from the full fit's own seeds (its trial-0 key),
    # so the comparison is of the two optimizers
    seeds = kmeans.init_plus_plus(
        threefry.fold_in(RngState(args.seed).key(), 0), x, KMEANS_K)
    t0 = time.perf_counter()
    c_mb, cost_mb, n_mb = kmeans.fit_minibatch(
        kmeans.KMeansParams(**{**p.__dict__, "init": "array"}), x,
        batch_size=KMEANS_MB_BATCH, n_iters=KMEANS_MB_ITERS,
        init_centroids=seeds)
    torch.cuda.synchronize()
    mb_s = time.perf_counter() - t0
    labels = kmeans.predict(c, x)
    cost = float(kmeans.cluster_cost(c, x))
    launches = K.launch_counts()
    if launches["fused_l2_argmin"] == 0:
        raise SmokeFailure("[kmeans]: fused_l2_argmin never launched")
    _, again, _ = kmeans.fit(kmeans.KMeansParams(
        **{**p.__dict__, "init": "array", "max_iter": 1}), x,
        init_centroids=c)
    inertia, inertia_r, cost_mb = float(inertia), float(inertia_r), \
        float(cost_mb)
    if abs(cost - float(again)) > 1e-5 * abs(cost):
        raise SmokeFailure(f"[kmeans]: cluster_cost {cost} is not the "
                           f"inertia {float(again)} of a sweep from the "
                           f"final centers")
    if not cost <= inertia * (1 + 1e-5):
        raise SmokeFailure(f"[kmeans]: the final centers' cost {cost} is "
                           f"above the last sweep's inertia {inertia}")
    if not inertia <= inertia_r:
        raise SmokeFailure(f"[kmeans]: k-means++ inertia {inertia} above "
                           f"the random init's {inertia_r}")
    if not cost_mb <= 1.10 * cost:
        raise SmokeFailure(f"[kmeans]: mini-batch cost {cost_mb} is not "
                           f"within 10 % of full Lloyd's {cost}")
    if labels.shape != (KMEANS_N,) or not bool(
            ((labels >= 0) & (labels < KMEANS_K)).all()):
        raise SmokeFailure("[kmeans]: predict returned malformed labels")
    _argmin_row(rows, "kmeans", launches, x, c.contiguous(),
                "predict/sweep ")
    _log(f"[kmeans] fit {KMEANS_N} x {KMEANS_DIM} into {KMEANS_K}: "
         f"k-means++ init {init_s:.3f} s + Lloyd {lloyd_s:.3f} s "
         f"({int(n_iter)} sweeps, {lloyd_s / max(1, int(n_iter)) * 1e3:.3f} "
         f"ms a sweep; sync-mode spans), fit {fit_s:.3f} s in all; inertia "
         f"{inertia:.6g} (final centers' cost {cost:.6g}); random init: "
         f"{fit_r_s:.3f} s, {int(n_iter_r)} sweeps, inertia "
         f"{inertia_r:.6g}; fit_minibatch batch {KMEANS_MB_BATCH} x "
         f"{n_mb} steps from the ++ seeds {mb_s:.3f} s, cost {cost_mb:.6g} "
         f"({cost_mb / cost:.4f} of full Lloyd's); launches "
         f"{json.dumps(launches)}")
    del labels
    fk = DeviceSynthetic(FIND_K_N, KMEANS_DIM, n_centers=FIND_K_CENTERS,
                         seed=args.seed + 1, std=0.2, scale=10.0)
    t0 = time.perf_counter()
    best_k, curve = kmeans.find_k(fk.base(), k_max=FIND_K_MAX)
    find_s = time.perf_counter() - t0
    _log(f"[kmeans find_k] {FIND_K_N} rows of {FIND_K_CENTERS} centers, "
         f"k_max {FIND_K_MAX}: k {best_k} in {find_s:.2f} s; inertias "
         + ", ".join(f"{v:.4g}" for v in curve.tolist()))
    if best_k != FIND_K_CENTERS:
        raise SmokeFailure(f"[kmeans]: find_k returned {best_k}, not "
                           f"{FIND_K_CENTERS}")
    return ds, x, {"init_s": init_s, "lloyd_s": lloyd_s, "fit_s": fit_s,
                   "n_iter": int(n_iter), "inertia": inertia, "cost": cost,
                   "random_init": {"s": fit_r_s, "n_iter": int(n_iter_r),
                                   "inertia": inertia_r},
                   "minibatch": {"s": mb_s, "steps": n_mb, "cost": cost_mb},
                   "find_k": {"k": best_k, "s": find_s},
                   "launches": launches}


def bf_index_leg(args, rows, ds, x):
    """``[bf index]`` (ROADMAP A3, A4) on the ``[kmeans]`` rows: with the
    counts zeroed just before and read just after, ``brute_force.build``
    (its cached norms) and ``knn(index, …)`` of ``BF_QUERIES`` queries at
    k 10 with ``impl`` "auto" and "sort", three passes each, and the same
    search at selectivity 0.1 (``bench_keep``); select_k (B3) must have
    launched. Checks: both impls equal ``knn_arrays`` bit for bit; the
    filtered search returns no id with its bit clear and the ids of an
    exact search over the kept rows alone, but at f32 ties (f64);
    ``merge_parts`` of ``BF_PARTS`` row blocks' top-10s equal to one
    ``select_k`` over their concatenation bit for bit, and the full
    search's ids but at ties. Then B3 at the search's tile shape against
    its plain version (row ``bf_index``). Returns the summary."""
    import numpy as np
    import torch

    from raft_tpu_torch.core import bitset
    from raft_tpu_torch.matrix.select_k import merge_parts, select_k_impl
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops import kernels as K

    n, k = x.shape[0], 10
    q = ds.queries(BF_QUERIES)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    index = brute_force.build(x, "sqeuclidean")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def passes(fn):
        out, qps = None, []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            qps.append(BF_QUERIES / (start.elapsed_time(end) / 1e3))
        return out, qps

    (v_a, i_a), qps_auto = passes(lambda: brute_force.knn(index, q, k))
    (v_s, i_s), qps_sort = passes(
        lambda: brute_force.knn(index, q, k, impl="sort"))
    keep = bench_keep(n, 0.1, k)
    bits = bitset.from_mask(torch.from_numpy(keep).to(x.device))
    (v_f, i_f), qps_filt = passes(
        lambda: brute_force.knn(index, q, k, filter_bitset=bits))
    launches = K.launch_counts()
    if launches["select_k"] == 0:
        raise SmokeFailure("[bf index]: select_k never launched")
    v_r, i_r = brute_force.knn_arrays(x, q, k, metric="sqeuclidean")
    for what, (v, i) in (("auto", (v_a, i_a)), ("sort", (v_s, i_s))):
        if not (torch.equal(v, v_r) and torch.equal(i, i_r)):
            raise SmokeFailure(f"[bf index]: knn(index, impl={what!r}) "
                               f"differs from knn_arrays")
    _check_kept(i_f.cpu(), keep, "[bf index] filtered")
    kept_rows = torch.from_numpy(np.flatnonzero(keep)).to(x.device)
    _, i_k = brute_force.knn_arrays(x[kept_rows], q, k,
                                    metric="sqeuclidean")
    swaps_f = _swaps_are_ties(q, x, i_f.long(), kept_rows[i_k.long()],
                              "[bf index] filtered against the kept rows")
    # merge_parts: the top-10 of each of BF_PARTS row blocks, global ids
    step = -(-n // BF_PARTS)
    pv, pi = [], []
    for a in range(0, n, step):
        v, i = brute_force.knn_arrays(x[a:a + step], q, k,
                                      metric="sqeuclidean")
        pv.append(v)
        pi.append(i + a)
    pv, pi = torch.stack(pv), torch.stack(pi)
    mv, mi = merge_parts(pv, pi, k)
    cv, ci = select_k_impl(pv.permute(1, 0, 2).reshape(BF_QUERIES, -1), k,
                           input_indices=pi.permute(1, 0, 2).reshape(
                               BF_QUERIES, -1))
    if not (torch.equal(mv, cv) and torch.equal(mi, ci)):
        raise SmokeFailure("[bf index]: merge_parts differs from one "
                           "select_k over the concatenated parts")
    swaps_m = _swaps_are_ties(q, x, mi.long(), i_r.long(),
                              "[bf index] merge_parts against the full "
                              "search")
    merge_ms = _timed(lambda: merge_parts(pv, pi, k), 20)
    _log(f"[bf index] build {n} x {x.shape[1]} ({build_s:.3f} s, norms "
         f"cached); knn of {BF_QUERIES} queries, k {k}, three passes (CUDA "
         f"events): impl auto "
         + ", ".join(f"{v:.0f}" for v in qps_auto) + " QPS, sort "
         + ", ".join(f"{v:.0f}" for v in qps_sort) + " QPS, both equal to "
         f"knn_arrays bit for bit; selectivity 0.1: "
         + ", ".join(f"{v:.0f}" for v in qps_filt)
         + f" QPS, the kept rows' exact search but {swaps_f} f32-tie swaps; "
         f"merge_parts of {BF_PARTS} x [{BF_QUERIES}, {k}] {merge_ms:.3f} "
         f"ms, equal to select_k over the concatenation, the full search's "
         f"ids but {swaps_m} tie swaps; launches {json.dumps(launches)}")
    # B3 at the search's tile shape: the first tile's distance block
    it = min(n, max(1 << 14, brute_force._TILE_BUDGET_ELEMS // BF_QUERIES))
    blk = x[:it]
    tile = brute_force._expanded_block(q, blk, (q * q).sum(1),
                                       index.norms[:it], index.metric)
    _select_k_row(rows, "bf_index", launches, tile.contiguous(), k,
                  " (one tile of the search)")
    del tile, index, v_r, i_r, pv, pi
    torch.cuda.empty_cache()
    return {"build_s": build_s, "qps_auto": qps_auto, "qps_sort": qps_sort,
            "qps_filtered_0.1": qps_filt, "merge_parts_ms": merge_ms,
            "tie_swaps": {"filtered": swaps_f, "merge_parts": swaps_m},
            "launches": launches}


def _groups_agree(spec, vals, ids, mesh, axis, what):
    """Every group of ranks along ``axis`` holds the same merged answer:
    each rank's table (allgather), or each group's chunks in position
    order (ring)."""
    import torch

    from raft_tpu_torch.parallel import merge as pmerge

    if spec == pmerge.REPLICATED:
        answers = [(vals[r], ids[r]) for r in range(mesh.size)]
    else:
        answers = [(torch.cat([vals[r] for r in g]),
                    torch.cat([ids[r] for r in g]))
                   for g in mesh.groups((axis,))]
    for v, i in answers[1:]:
        if not (torch.equal(v, answers[0][0]) and
                torch.equal(i, answers[0][1])):
            raise SmokeFailure(f"{what}: the groups along {axis!r} hold "
                               f"different answers")
    return len(answers)


def shard_axis_leg(args, rows):
    """``[shard axis]`` (ROADMAP A15 on one card): a (dcn, ici) = (2, 2)
    mesh of 4 ranks on cuda:0, IVF-PQ over DEEP's d 96 (``AXIS_N`` rows,
    1,024 lists, pq_dim 48) sharded over "ici" and replicated over "dcn".
    With the counts zeroed just before the build and read after the
    searches: refined search (k 10, ``AXIS_QUERIES`` queries, n_probes 64,
    the LUT scan and 40× re-rank) under ``merge`` allgather and ring, and
    ``sharded_knn`` over "ici" under both. Checks: B4, B3, B1 and B2
    launched and B7 and B8 not (a sub-axis takes ``ring_ppermute``);
    ``parallel.merge.dispatch`` ring_ppermute and allgather only; the comms
    counted under "ici" alone; each result equal bit for bit to the same
    shards (``to_numpy`` → ``from_numpy``) searched over a 1-D 2-rank mesh;
    every replica group's merged answer equal; recall@10 against the exact
    search. Returns the summary."""
    import torch

    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import brute_force, ivf_pq
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K
    from raft_tpu_torch.parallel import comms, hier_mesh, make_mesh
    from raft_tpu_torch.parallel import ivf as pivf
    from raft_tpu_torch.parallel import knn as pknn
    from raft_tpu_torch.parallel import merge as pmerge

    axis, k = "ici", 10
    ds = DeviceSynthetic(AXIS_N, AXIS_DIM, n_centers=2_000,
                         seed=args.seed + 19, std=0.5, scale=10.0)
    base = ds.base()
    q = ds.queries(AXIS_QUERIES)
    mesh2 = hier_mesh(2, 2, devices="cuda:0")
    mesh1 = make_mesh(2, device="cuda:0", axis_name=axis)
    sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                             refine="f32_regen", refine_ratio=40,
                             lut_dtype="float32")
    K.reset_launch_counts()
    spans.reset()
    t0 = time.perf_counter()
    index2 = pivf.build_ivf_pq(ivf_pq.IndexParams(
        n_lists=1024, pq_dim=48, pq_bits=8, seed=args.seed), base, mesh2,
        axis=axis)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    out, ms = {}, {}
    comms.reset_counters()
    for merge in ("allgather", "ring"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[("ivf_pq", merge)] = pivf.search_ivf_pq(
            sp, index2, q, k, mesh2, axis=axis, dataset=base, merge=merge)
        torch.cuda.synchronize()
        ms[f"ivf_pq/{merge}"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out[("knn", merge)] = pknn.sharded_knn(base, q, k, mesh2, axis=axis,
                                               merge=merge)
        torch.cuda.synchronize()
        ms[f"knn/{merge}"] = (time.perf_counter() - t0) * 1e3
    launches = K.launch_counts()
    disp = spans.counts().get("parallel.merge.dispatch", {})
    c = comms.counters()
    need = ("fused_l2_argmin", "select_k", "ivfpq_lut_scan_topk",
            "gather_refine_topk")
    missing = [n_ for n_ in need if launches[n_] == 0]
    if missing:
        raise SmokeFailure(f"[shard axis]: never launched: {missing}")
    if launches["ring_topk_merge"] or launches["ring_lut_scan_merge"]:
        raise SmokeFailure(f"[shard axis]: a ring kernel launched on a "
                           f"sub-axis: {launches}")
    if disp != {"allgather": 2.0, "ring_ppermute": 2.0}:
        raise SmokeFailure(f"[shard axis]: merge dispatch {disp}")
    if {a for _, a in c["ops"]} != {axis}:
        raise SmokeFailure(f"[shard axis]: comms counted off the axis: {c}")
    # the same shards over a 1-D mesh of the axis's two ranks
    arrays, meta = pivf.to_numpy(index2)
    index1 = pivf.from_numpy(arrays, meta, mesh1, axis=axis)
    del arrays
    for merge in ("allgather", "ring"):
        for what, run in (
                ("ivf_pq", lambda: pivf.search_ivf_pq(
                    sp, index1, q, k, mesh1, axis=axis, dataset=base,
                    merge=merge)),
                ("knn", lambda: pknn.sharded_knn(
                    base, q, k, mesh1, axis=axis, merge=merge))):
            v1, i1 = run()
            v2, i2 = out[(what, merge)]
            if not (torch.equal(v1, v2) and torch.equal(i1, i2)):
                raise SmokeFailure(f"[shard axis] {what} {merge}: the 2-D "
                                   f"mesh's answer differs from the 1-D "
                                   f"mesh's")
    # every replica group's merged answer, from the per-rank tables
    n_dev = index2.n_shards
    vals, gids = pivf._per_rank_topk(sp, index2, q, k, sp.n_probes, mesh2,
                                     base)
    groups = {}
    for merge in ("allgather", "ring"):
        tier, impl = pmerge.merge_tier(n_dev, q.shape[0], k, explicit=merge,
                                       whole_mesh=False,
                                       n_cards=mesh2.n_cards)
        rv, ri = pmerge.merge_topk(vals, gids, mesh2, q.shape[0], k, n_dev,
                                   True, tier=tier, impl=impl, axis=axis)
        groups[merge] = _groups_agree(pmerge.merge_out_spec(tier, axis), rv,
                                      ri, mesh2, axis, f"[shard axis] {merge}")
    _, gt = brute_force.knn_arrays(base, q, k, metric="sqeuclidean")
    rec = {merge: _recall(out[("ivf_pq", merge)][1].cpu(), gt.cpu())
           for merge in ("allgather", "ring")}
    knn_exact = all(torch.equal(out[("knn", m_)][1], gt)
                    for m_ in ("allgather", "ring"))
    _log(f"[shard axis] hier_mesh(2, 2) on cuda:0, IVF-PQ {AXIS_N} x "
         f"{AXIS_DIM} (1024 lists, pq_dim 48) sharded over {axis!r}, "
         f"replicated over 'dcn': build {build_s:.2f} s; refined search of "
         f"{AXIS_QUERIES} queries and sharded_knn, ms {json.dumps(ms)}; "
         f"recall@10 {json.dumps(rec)}; sharded_knn exact {knn_exact}; "
         f"equal bit for bit to the same shards on a 1-D 2-rank mesh; "
         f"replica groups equal {json.dumps(groups)}; dispatch "
         f"{json.dumps(disp)}; launches {json.dumps(launches)}; comms "
         f"(the JAX package's model) "
         + json.dumps({f"{op}/{a}": n_ for (op, a), n_ in c["bytes"].items()}))
    if min(rec.values()) < 0.9:
        raise SmokeFailure(f"[shard axis]: recall {rec}")
    del index2, index1, base, vals, gids
    torch.cuda.empty_cache()
    return {"build_s": build_s, "ms": ms, "recall_at_10": rec,
            "knn_exact": knn_exact, "launches": launches, "dispatch": disp,
            "groups": groups}


def _tristate_off(env, kernels, search, truth, want, what):
    """``env`` set to "off" around ``search()`` (restored after): the
    launch counters of ``kernels`` must not move and recall@10 must not
    fall more than 0.005 below ``want``. Returns (recall, dispatch and
    fallback counts of the call)."""
    from raft_tpu_torch.obs import spans
    from raft_tpu_torch.ops import kernels as K

    saved = os.environ.get(env)
    os.environ[env] = "off"
    before = spans.counts()
    try:
        K.reset_launch_counts()
        ids = search()
        launches = K.launch_counts()
    finally:
        if saved is None:
            del os.environ[env]
        else:
            os.environ[env] = saved
    after = spans.counts()
    moved = {f"{s}{{{lk}}}": v - before.get(s, {}).get(lk, 0.0)
             for s, d in after.items() for lk, v in d.items()
             if s.startswith(("ivf_pq.scan.", "refine."))
             and v != before.get(s, {}).get(lk, 0.0)}
    ran = {n_: launches[n_] for n_ in kernels if launches[n_]}
    if ran:
        raise SmokeFailure(f"[tristates] {env}=off: {ran} launched ({what})")
    rec = _recall(ids.cpu(), truth)
    # one-sided: the other tier may rank more exactly than the kernel's
    # (B1 keeps two candidates a strided bin; the plain grouped tier the
    # exact top k_cand), which is no fault
    if rec < want - 0.005:
        raise SmokeFailure(f"[tristates] {env}=off ({what}): recall@10 "
                           f"{rec} more than 0.005 below the default's "
                           f"{want}")
    _log(f"[tristates] {env}=off, {what}: launches of {list(kernels)} 0; "
         f"recall@10 {rec:.4f} against the default's {want:.4f}; "
         f"dispatch {json.dumps(moved)}")
    return rec, moved


def tristates_leg(index, base, queries, sp, B, k, gt, rec_default,
                  rec_f32):
    """``[tristates]`` (ROADMAP A1) on the main index: the refined search
    of the first ``len(gt)`` queries in batches of ``B`` with
    ``RAFT_TPU_PALLAS_LUTSCAN`` off (B1 must not launch: the approx tier
    answers, the plain grouped tier on this cacheless index, no more than
    0.005 below the default tier's recall@10 at the f32 LUT, ``rec_f32``:
    the off tier ranks exact f32 ADC distances and keeps the exact top
    k_cand, where B1 keeps two candidates a strided bin, so it may read
    higher) and with ``RAFT_TPU_PALLAS_REFINE`` off (B2 must not launch:
    the gather tier re-ranks the same candidates, no more than 0.005 below
    ``rec_default``); then ``RAFT_TPU_FP8_LUT``: unset,
    "auto" at n_probes 64 resolves fp8 on the card, "off" resolves
    float32. ``RAFT_TPU_PALLAS_GROUPED`` is read in ``flat_phase``, whose
    IVF-Flat index B5 and B6 scan. Returns the summary."""
    import torch

    from raft_tpu_torch.neighbors import ivf_pq

    n_gt = gt.shape[0]

    def search():
        return torch.cat([ivf_pq.search(index, queries[a:a + B], k, sp,
                                        dataset=base)[1]
                          for a in range(0, n_gt, B)])

    out = {}
    t0 = time.perf_counter()
    # off, the plain grouped tier ranks exact f32 ADC distances: it is held
    # to the default tier at the f32 LUT, the precision it computes at
    out["lutscan_off"] = _tristate_off(
        "RAFT_TPU_PALLAS_LUTSCAN", ("ivfpq_lut_scan_topk",), search, gt,
        rec_f32, f"refined search of {n_gt}")
    out["refine_off"] = _tristate_off(
        "RAFT_TPU_PALLAS_REFINE", ("gather_refine_topk",), search, gt,
        rec_default, f"refined search of {n_gt}")
    saved = os.environ.pop("RAFT_TPU_FP8_LUT", None)
    try:
        auto = ivf_pq.resolve_lut_dtype("auto", 64, k)
        os.environ["RAFT_TPU_FP8_LUT"] = "off"
        off = ivf_pq.resolve_lut_dtype("auto", 64, k)
    finally:
        os.environ.pop("RAFT_TPU_FP8_LUT", None)
        if saved is not None:
            os.environ["RAFT_TPU_FP8_LUT"] = saved
    if auto != "float8_e4m3" or off != "float32":
        raise SmokeFailure(f"[tristates] RAFT_TPU_FP8_LUT: auto -> {auto}, "
                           f"off -> {off} at n_probes 64")
    _log(f"[tristates] RAFT_TPU_FP8_LUT at n_probes 64, k {k}: auto -> "
         f"{auto}, off -> {off}; leg {time.perf_counter() - t0:.1f} s")
    return {"lutscan_off": out["lutscan_off"][0],
            "refine_off": out["refine_off"][0], "fp8_auto": auto,
            "fp8_off": off}


# ---------------------------------------------------------------------------
# A17's first half: a clustering job and an embedding evaluated as cuML
# does, on SIFT-1M's shape
# ---------------------------------------------------------------------------

PRIMS_N = 1_000_000
PRIMS_DIM = 128
PRIMS_K = 1_000
PRIMS_CPU_N = 100_000
PRIMS_SWEEPS = 10
PRIMS_SIL_N = 20_000
PRIMS_TRUST_N = 10_000
PRIMS_EMBED_DIM = 16
PRIMS_GRAPH_N = 200_000
PRIMS_GRAPH_K = 10
PRIMS_GRAPH_BATCH = 25_000
PRIMS_RMAT_EDGES = 1 << 20
PRIMS_RMAT_SCALE = 18
PRIMS_SCORES = ("adjusted_rand_index", "rand_index", "mutual_info_score",
                "homogeneity_score", "completeness_score", "v_measure")


def _scores_f64(c):
    """The contingency scores in float64 numpy from the counts ``c``
    (rows the truth, columns the prediction)."""
    import numpy as np

    c = c.astype(np.float64)
    n = c.sum()

    def comb2(v):
        return v * (v - 1.0) / 2.0

    s_c, s_a, s_b = comb2(c).sum(), comb2(c.sum(1)).sum(), \
        comb2(c.sum(0)).sum()
    tot = comb2(n)
    exp = s_a * s_b / tot
    p = c / n
    pi, pj = p.sum(1, keepdims=True), p.sum(0, keepdims=True)
    nz = p > 0
    mi = float((p[nz] * np.log(p[nz] / (pi * pj)[nz])).sum())

    def ent(q):
        q = q[q > 0]
        return float(-(q * np.log(q)).sum())

    h = mi / ent(pi.ravel())
    comp = mi / ent(pj.ravel())
    return {"adjusted_rand_index": (s_c - exp) / (0.5 * (s_a + s_b) - exp),
            "rand_index": (tot + 2 * s_c - s_a - s_b) / tot,
            "mutual_info_score": mi, "homogeneity_score": h,
            "completeness_score": comp,
            "v_measure": 2 * h * comp / (h + comp)}


def _silhouette_f64(x, labels, k):
    """The mean silhouette in float64 from exact distances (self 0)."""
    import torch

    xd = x.double()
    d = torch.cdist(xd, xd)
    lab = labels.long()
    onehot = torch.nn.functional.one_hot(lab, k).double()
    sums = d @ onehot
    counts = onehot.sum(0)
    own = counts[lab]
    rows = torch.arange(x.shape[0], device=x.device)
    a = torch.where(own > 1, sums[rows, lab] / (own - 1).clamp_min(1), 0.0)
    mean_to = sums / counts.clamp_min(1)
    mean_to[rows, lab] = float("inf")
    mean_to = torch.where(counts[None] > 0, mean_to, float("inf"))
    b = mean_to.amin(1)
    s = torch.where(own > 1, (b - a) / torch.maximum(a, b), 0.0)
    return float(s.mean())


def _same_partition(labels, ref) -> bool:
    """Two labelings split the vertices alike: relabelled by first
    occurrence, they are equal."""
    import numpy as np

    def first_seen(v):
        _, first, inv = np.unique(v, return_index=True, return_inverse=True)
        order = np.empty(len(first), np.int64)
        order[np.argsort(first)] = np.arange(len(first))
        return order[inv]

    return np.array_equal(first_seen(np.asarray(labels)),
                          first_seen(np.asarray(ref)))


def _root_ids(mono, k):
    """Monotonic component labels → each vertex's component's least vertex
    id (the vertex-id labels ``merge_labels`` takes)."""
    import torch

    n = mono.shape[0]
    roots = torch.full((k,), n, dtype=torch.int32, device=mono.device)
    roots.scatter_reduce_(0, mono.long(), torch.arange(
        n, dtype=torch.int32, device=mono.device), "amin")
    return roots[mono.long()]


def prims_leg(args, rows):
    """``[prims …]`` (ROADMAP A17's first half): a clustering job and an
    embedding evaluated as cuML does, at SIFT-1M's shape, each part timed
    by the host's clock around synchronized calls.

    (a) ``[prims blobs]``: ``random.make_blobs(PRIMS_N, PRIMS_DIM, 1000
    clusters, std 1.0)`` on the card; on ``PRIMS_CPU_N`` rows the card's
    labels and ``permute``'s permutation equal the CPU's bit for bit and
    every row within 1e-5 of the CPU's (row norms). (b) ``[prims
    cluster]``: with the counts zeroed just before and read just after,
    ``kmeans.fit`` (random init, 10 sweeps; B4 must launch) and
    ``predict``, then the contingency scores against the blob labels at
    n_classes 1000: card = CPU within 1e-4 relative, = float64 numpy from
    the counts within 1e-3, the counts exact (= ``numpy.bincount``).
    (c) ``[prims linalg]``: ``stats.cov`` then ``eig_dc``; ``rsvd`` of the
    centred rows at k 32: with p 96 the sketch spans all 128 columns and
    s²/(n − 1) must be within 1e-3 of the top 32 eigenvalues; at its
    defaults (p 10, 2 power iterations: a sketch of 42 columns) the card's
    s within 1e-4 relative of the same call's on the CPU (the same Ω), its
    error from the eigenvalues logged; ``qr`` of the
    rows (QᵀQ in float64 within 1e-4 of I); ``lstsq`` on
    ``make_regression(PRIMS_N, 128, noise=0.1)`` (coefficients within
    1e-2 of the truth, norm-relative); ``cholesky_r1_update`` of the
    covariance's factor within 1e-3 of the float64 factor of LLᵀ + vvᵀ;
    ``multi_variable_gaussian`` of 1M samples by both methods (the sample
    covariance within 2e-2 of the covariance, Frobenius-relative);
    ``reduce_rows_by_key`` by the 1,000 labels within 1e-4 of float64
    (scale-relative); ``histogram`` equal to ``numpy.histogram`` on the
    values away from bin edges. (d) ``[prims embed]``: ``silhouette_score``
    of ``PRIMS_SIL_N`` rows drawn by ``subsample`` within 1e-3 of float64;
    ``trustworthiness_score`` of the 16-dim ``rsvd`` projection of
    ``PRIMS_TRUST_N`` rows, k 10, within 1e-4 of the CPU's; the card's peak
    memory. (e) ``[prims labels]``: with the counts zeroed just before and
    read just after, the symmetrised kNN graph (k 10) of ``PRIMS_GRAPH_N``
    rows through ``brute_force.knn_arrays`` (B3 must launch) and a
    symmetrised ``rmat_rectangular`` graph (2^20 edges, scale 18): each
    ``connected_components`` partition equal to
    ``scipy.sparse.csgraph``'s, its rounds printed; ``merge_labels`` of the
    kNN graph's two halves' root labelings gives the whole graph's
    partition. Then B3 at the kNN tile's shape against its plain version
    (row ``prims``). Returns the summary."""
    import numpy as np
    import torch
    from scipy.sparse import csgraph

    from raft_tpu_torch import label, linalg, random as trandom, sparse, \
        stats
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops import kernels as K

    st = trandom.RngState(args.seed)
    out = {}
    t_leg = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # (a) blobs
    (x, lab), blobs_s = timed(lambda: trandom.make_blobs(
        PRIMS_N, PRIMS_DIM, n_clusters=PRIMS_K, cluster_std=1.0, state=st))
    dev = x.device
    (xs, ls), small_s = timed(lambda: trandom.make_blobs(
        PRIMS_CPU_N, PRIMS_DIM, n_clusters=PRIMS_K, cluster_std=1.0,
        state=st))
    t0 = time.perf_counter()
    xc, lc = trandom.make_blobs(PRIMS_CPU_N, PRIMS_DIM, n_clusters=PRIMS_K,
                                cluster_std=1.0, state=st, device="cpu")
    cpu_s = time.perf_counter() - t0
    if lab.dtype != torch.int32 or x.shape != (PRIMS_N, PRIMS_DIM):
        raise SmokeFailure("[prims blobs]: malformed rows or labels")
    if not torch.equal(ls.cpu(), lc):
        raise SmokeFailure("[prims blobs]: the card's labels differ from "
                           "the CPU's")
    ar = torch.arange(PRIMS_CPU_N, dtype=torch.int32)
    if not torch.equal(trandom.permute(ar.to(dev), st).cpu(),
                       trandom.permute(ar, st)):
        raise SmokeFailure("[prims blobs]: the card's permutation differs "
                           "from the CPU's")
    row_err = float(((xs.cpu() - xc).norm(dim=1)
                     / xc.norm(dim=1).clamp_min(1e-30)).max())
    if not row_err <= 1e-5:
        raise SmokeFailure(f"[prims blobs]: rows differ from the CPU's by "
                           f"{row_err:.3g} (relative)")
    del xs, ls, xc, lc
    _log(f"[prims blobs] make_blobs {PRIMS_N} x {PRIMS_DIM}, {PRIMS_K} "
         f"clusters: {blobs_s:.3f} s on the card; {PRIMS_CPU_N} rows "
         f"{small_s:.3f} s on the card, {cpu_s:.2f} s on the CPU: labels "
         f"and permutation equal, rows within {row_err:.3g} (relative)")
    out["blobs"] = {"s": blobs_s, "cpu_rows_s": cpu_s, "row_err": row_err}

    # (b) clustering and its scores
    K.reset_launch_counts()
    p = kmeans.KMeansParams(n_clusters=PRIMS_K, max_iter=PRIMS_SWEEPS,
                            tol=0.0, init="random", seed=args.seed)
    (fit, fit_s) = timed(lambda: kmeans.fit(p, x))
    centers, inertia, n_iter = fit
    pred, pred_s = timed(lambda: kmeans.predict(centers, x))
    launches = K.launch_counts()
    if launches["fused_l2_argmin"] == 0:
        raise SmokeFailure("[prims cluster]: fused_l2_argmin never launched")
    cont, cont_s = timed(lambda: stats.contingency_matrix(
        lab, pred, PRIMS_K, PRIMS_K))
    counts = cont.cpu().numpy()
    lab_c, pred_c = lab.cpu(), pred.cpu()
    want = np.bincount(lab_c.numpy().astype(np.int64) * PRIMS_K
                       + pred_c.numpy(), minlength=PRIMS_K * PRIMS_K)
    if not (np.array_equal(counts.reshape(-1), want) and np.array_equal(
            stats.contingency_matrix(lab_c, pred_c, PRIMS_K,
                                     PRIMS_K).numpy(), counts)):
        raise SmokeFailure("[prims cluster]: contingency counts are not "
                           "exact")
    ref = _scores_f64(counts)
    scores, score_ms = {}, {}
    for name in PRIMS_SCORES:
        fn = getattr(stats, name)
        v, s_ = timed(lambda: fn(lab, pred, PRIMS_K))
        v, v_cpu = float(v), float(fn(lab_c, pred_c, PRIMS_K))
        scores[name], score_ms[name] = v, s_ * 1e3
        if not abs(v - v_cpu) <= 1e-4 * max(abs(v_cpu), 1e-30):
            raise SmokeFailure(f"[prims cluster]: {name} {v} on the card, "
                               f"{v_cpu} on the CPU")
        if not abs(v - ref[name]) <= 1e-3 * max(abs(ref[name]), 1.0):
            raise SmokeFailure(f"[prims cluster]: {name} {v}, float64 "
                               f"{ref[name]}")
    _log(f"[prims cluster] kmeans.fit random init, {int(n_iter)} sweeps "
         f"{fit_s:.3f} s, predict {pred_s * 1e3:.2f} ms, contingency "
         f"[{PRIMS_K}, {PRIMS_K}] {cont_s * 1e3:.2f} ms (counts exact); "
         + ", ".join(f"{n} {scores[n]:.6f} ({score_ms[n]:.2f} ms)"
                     for n in PRIMS_SCORES)
         + "; card = CPU within 1e-4, = float64 within 1e-3; launches "
         f"{json.dumps(launches)}")
    out["cluster"] = {"fit_s": fit_s, "n_iter": int(n_iter),
                      "inertia": float(inertia), "scores": scores,
                      "score_ms": score_ms, "launches": launches}
    del pred, pred_c, centers

    # (c) linear algebra
    la = {}
    cov, la["cov_s"] = timed(lambda: stats.cov(x))
    (w, _), la["eig_s"] = timed(lambda: linalg.eig_dc(cov))
    top = w.flip(0)[:32].double()
    xcent = stats.mean_center(x)
    n = PRIMS_N
    (_, s_full, _), la["rsvd_s"] = timed(lambda: linalg.rsvd(xcent, 32,
                                                             p=96))
    (_, s_def, _), la["rsvd_default_s"] = timed(lambda: linalg.rsvd(xcent,
                                                                    32))
    rsvd_err = float(((s_full.double() ** 2 / (n - 1) - top).abs()
                      / top).max())
    rsvd_def_err = float(((s_def.double() ** 2 / (n - 1) - top).abs()
                          / top).max())
    if not rsvd_err <= 1e-3:
        raise SmokeFailure(f"[prims linalg]: rsvd's s^2/(n-1) {rsvd_err:.3g}"
                           f" from the top eigenvalues")
    # at its defaults (k + p = 42 of 128 columns) rsvd is a sketch: the
    # card's range finder and power iterations against the CPU's on the
    # same Ω (PRNGKey(0))
    s_def_cpu = linalg.rsvd(xcent.cpu(), 32)[1].double()
    rsvd_cpu_err = float(((s_def.cpu().double() - s_def_cpu).abs()
                          / s_def_cpu).max())
    if not rsvd_cpu_err <= 1e-4:
        raise SmokeFailure(f"[prims linalg]: rsvd(k=32) at its defaults: "
                           f"s {rsvd_cpu_err:.3g} from the CPU's")
    (q, _), la["qr_s"] = timed(lambda: linalg.qr(x))
    qd = q.double()
    orth = float((qd.T @ qd - torch.eye(PRIMS_DIM, dtype=torch.float64,
                                        device=dev)).abs().max())
    del q, qd
    if not orth <= 1e-4:
        raise SmokeFailure(f"[prims linalg]: QᵀQ is {orth:.3g} from I")
    rx, ry, rw = trandom.make_regression(PRIMS_N, PRIMS_DIM, noise=0.1,
                                         state=st.advance(1))
    coef, la["lstsq_s"] = timed(lambda: linalg.lstsq(rx, ry))
    coef_err = float((coef - rw).norm() / rw.norm())
    del rx, ry
    if not coef_err <= 1e-2:
        raise SmokeFailure(f"[prims linalg]: lstsq coefficients "
                           f"{coef_err:.3g} from the truth")
    fac = torch.linalg.cholesky(cov)
    v = trandom.normal(st.advance(2), (PRIMS_DIM,))
    up, la["r1_update_s"] = timed(lambda: linalg.cholesky_r1_update(fac, v))
    fd = fac.double()
    want_up = torch.linalg.cholesky(fd @ fd.T + torch.outer(v.double(),
                                                            v.double()))
    r1_err = float((up.double() - want_up).abs().max())
    if not r1_err <= 1e-3:
        raise SmokeFailure(f"[prims linalg]: cholesky_r1_update "
                           f"{r1_err:.3g} from the fresh factor")
    mean = x.mean(0)
    mvg_err = {}
    for method in ("cholesky", "eig"):
        smp, la[f"mvg_{method}_s"] = timed(
            lambda: trandom.multi_variable_gaussian(st.advance(3), mean, cov,
                                                    PRIMS_N, method))
        mvg_err[method] = float((stats.cov(smp) - cov).norm() / cov.norm())
        del smp
        if not mvg_err[method] <= 2e-2:
            raise SmokeFailure(f"[prims linalg]: multi_variable_gaussian "
                               f"({method}) covariance {mvg_err[method]:.3g}"
                               f" from the target")
    sums, la["reduce_rows_by_key_s"] = timed(
        lambda: linalg.reduce_rows_by_key(x, lab, PRIMS_K))
    want_sums = torch.zeros((PRIMS_K, PRIMS_DIM), dtype=torch.float64,
                            device=dev).index_add_(0, lab.long(), x.double())
    red_err = float((sums.double() - want_sums).abs().max()
                    / want_sums.abs().max())
    if not red_err <= 1e-4:
        raise SmokeFailure(f"[prims linalg]: reduce_rows_by_key "
                           f"{red_err:.3g} from float64")
    col = x[:, 0].contiguous()
    n_bins, lo, hi = 64, -15.0, 15.0
    hist, la["histogram_s"] = timed(lambda: stats.histogram(col, n_bins, lo,
                                                            hi))
    col_h = col.cpu().numpy()
    edges = np.linspace(lo, hi, n_bins + 1)
    near = np.abs(col_h[:, None] - edges[None, :]).min(1) <= 1e-5 * (hi - lo)
    away = torch.from_numpy(col_h[~near]).to(dev)
    h_away = stats.histogram(away, n_bins, lo, hi).cpu().numpy()
    h_np, _ = np.histogram(col_h[~near], bins=n_bins, range=(lo, hi))
    if not np.array_equal(h_away, h_np) or int(hist.sum()) != int(
            ((col_h >= lo) & (col_h <= hi)).sum()):
        raise SmokeFailure("[prims linalg]: histogram differs from "
                           "numpy.histogram away from the bin edges")
    _log("[prims linalg] " + ", ".join(
        f"{k_[:-2]} {v_ * 1e3:.2f} ms" for k_, v_ in la.items())
        + f"; rsvd (p 96) {rsvd_err:.3g} from the eigenvalues; rsvd at "
        f"its defaults: s {rsvd_cpu_err:.3g} from the CPU's (limit 1e-4), "
        f"{rsvd_def_err:.3g} from the eigenvalues (a sketch: no limit); "
        f"QᵀQ {orth:.3g} from I, lstsq "
        f"{coef_err:.3g}, r1 update {r1_err:.3g}, multi_variable_gaussian "
        f"{mvg_err['cholesky']:.3g} / {mvg_err['eig']:.3g}, "
        f"reduce_rows_by_key {red_err:.3g}, histogram = numpy on "
        f"{int((~near).sum())} of {PRIMS_N} values")
    out["linalg"] = {"s": la, "rsvd_err": rsvd_err,
                     "rsvd_default_err": rsvd_def_err,
                     "rsvd_default_cpu_err": rsvd_cpu_err, "qtq_err": orth,
                     "lstsq_err": coef_err, "r1_err": r1_err,
                     "mvg_err": mvg_err, "reduce_err": red_err}
    del cov, fac, sums, want_sums, xcent

    # (d) the embedding's quality
    idx = trandom.subsample(st.advance(4), PRIMS_N, PRIMS_SIL_N).long()
    xs, ls = x[idx], lab[idx]
    sil, sil_s = timed(lambda: stats.silhouette_score(xs, ls, PRIMS_K))
    sil, sil_ref = float(sil), _silhouette_f64(xs, ls, PRIMS_K)
    if not abs(sil - sil_ref) <= 1e-3:
        raise SmokeFailure(f"[prims embed]: silhouette {sil}, float64 "
                           f"{sil_ref}")
    xt = xs[:PRIMS_TRUST_N].contiguous()
    xt_c = stats.mean_center(xt)
    _, _, vt = linalg.rsvd(xt_c, PRIMS_EMBED_DIM)
    emb = (xt_c @ vt.T).contiguous()
    tw, tw_s = timed(lambda: stats.trustworthiness_score(xt, emb, 10))
    t0 = time.perf_counter()
    tw_cpu = float(stats.trustworthiness_score(xt.cpu(), emb.cpu(), 10))
    tw_cpu_s = time.perf_counter() - t0
    tw = float(tw)
    if not abs(tw - tw_cpu) <= 1e-4:
        raise SmokeFailure(f"[prims embed]: trustworthiness {tw} on the "
                           f"card, {tw_cpu} on the CPU")
    peak = torch.cuda.max_memory_allocated() / 2**30
    _log(f"[prims embed] silhouette of {PRIMS_SIL_N} subsampled rows "
         f"{sil:.6f} ({sil_s * 1e3:.1f} ms; float64 {sil_ref:.6f}); "
         f"trustworthiness of the {PRIMS_EMBED_DIM}-dim rsvd projection of "
         f"{PRIMS_TRUST_N} rows, k 10: {tw:.6f} ({tw_s * 1e3:.1f} ms; CPU "
         f"{tw_cpu:.6f} in {tw_cpu_s:.2f} s); card peak {peak:.2f} GiB")
    out["embed"] = {"silhouette": sil, "silhouette_f64": sil_ref,
                    "silhouette_s": sil_s, "trust": tw, "trust_cpu": tw_cpu,
                    "trust_s": tw_s, "trust_cpu_s": tw_cpu_s,
                    "peak_gib": peak}
    del xs, ls, xt, xt_c, emb

    # (e) labels: connected components of two graphs
    K.reset_launch_counts()
    xg = x[:PRIMS_GRAPH_N].contiguous()

    def knn_graph():
        return torch.cat([brute_force.knn_arrays(
            xg, xg[a:a + PRIMS_GRAPH_BATCH], PRIMS_GRAPH_K,
            metric="sqeuclidean")[1]
            for a in range(0, PRIMS_GRAPH_N, PRIMS_GRAPH_BATCH)])

    nbr, knn_s = timed(knn_graph)
    launches_g = K.launch_counts()
    if launches_g["select_k"] == 0:
        raise SmokeFailure("[prims labels]: select_k never launched")

    def symmetrised(src, dst, n_):
        r = torch.cat([src, dst]).int()
        c = torch.cat([dst, src]).int()
        ones = torch.ones(r.shape[0], dtype=torch.float32, device=dev)
        return sparse.coo_to_csr(sparse.make_coo(r, c, ones, (n_, n_)))

    def check_cc(name, csr):
        stats_ = {}
        (mono, k_), cc_s = timed(lambda: label.connected_components(
            csr, stats=stats_))
        sc = sparse.to_scipy(csr)
        t0 = time.perf_counter()
        nc, ref_lab = csgraph.connected_components(sc, directed=False)
        sc_s = time.perf_counter() - t0
        if k_ != nc or not _same_partition(mono.cpu().numpy(), ref_lab):
            raise SmokeFailure(f"[prims labels]: {name} components differ "
                               f"from scipy's ({k_} against {nc})")
        return mono, k_, stats_["rounds"], cc_s, sc_s

    src = torch.arange(PRIMS_GRAPH_N, device=dev).repeat_interleave(
        PRIMS_GRAPH_K)
    dst = nbr.reshape(-1).long()
    csr_knn = symmetrised(src, dst, PRIMS_GRAPH_N)
    mono, k_knn, rounds_knn, cc_s, sc_s = check_cc("kNN graph", csr_knn)
    half = src.shape[0] // 2
    roots = []
    for sl in (slice(0, half), slice(half, None)):
        m_, k_h = label.connected_components(
            symmetrised(src[sl], dst[sl], PRIMS_GRAPH_N))
        roots.append(_root_ids(m_, k_h))
    merged = label.merge_labels(*roots)
    if not torch.equal(label.make_monotonic(merged)[0], mono):
        raise SmokeFailure("[prims labels]: merge_labels of the halves "
                           "differs from the whole kNN graph's components")
    edges, rmat_s = timed(lambda: trandom.rmat_rectangular(
        st.advance(5), PRIMS_RMAT_EDGES, PRIMS_RMAT_SCALE, PRIMS_RMAT_SCALE))
    n_r = 1 << PRIMS_RMAT_SCALE
    csr_r = symmetrised(edges[:, 0].long(), edges[:, 1].long(), n_r)
    _, k_r, rounds_r, cc_r_s, sc_r_s = check_cc("RMAT graph", csr_r)
    _log(f"[prims labels] kNN graph of {PRIMS_GRAPH_N} rows, k "
         f"{PRIMS_GRAPH_K} ({knn_s:.3f} s): {k_knn} components in "
         f"{rounds_knn} rounds ({cc_s * 1e3:.1f} ms; scipy "
         f"{sc_s * 1e3:.1f} ms), merge_labels of its halves = the whole; "
         f"RMAT {PRIMS_RMAT_EDGES} edges at scale {PRIMS_RMAT_SCALE} "
         f"({rmat_s * 1e3:.1f} ms): {k_r} components in {rounds_r} rounds "
         f"({cc_r_s * 1e3:.1f} ms; scipy {sc_r_s * 1e3:.1f} ms); both = "
         f"scipy's partition; launches {json.dumps(launches_g)}")
    out["labels"] = {"knn_s": knn_s, "knn_components": k_knn,
                     "knn_rounds": rounds_knn, "knn_cc_s": cc_s,
                     "rmat_components": k_r, "rmat_rounds": rounds_r,
                     "rmat_cc_s": cc_r_s, "launches": launches_g}
    del csr_knn, csr_r, edges, nbr, src, dst, merged, roots
    # B3 at the graph's search tile: the first query batch against the
    # first tile of rows
    q = xg[:PRIMS_GRAPH_BATCH]
    it = min(PRIMS_GRAPH_N, max(1 << 14, brute_force._TILE_BUDGET_ELEMS
                                // PRIMS_GRAPH_BATCH))
    index = brute_force.build(xg, "sqeuclidean")
    tile = brute_force._expanded_block(q, xg[:it], (q * q).sum(1),
                                       index.norms[:it], index.metric)
    _select_k_row(rows, "prims", launches_g, tile.contiguous(),
                  PRIMS_GRAPH_K, " (the kNN graph's search tile)")
    del tile, index, xg, x, lab
    torch.cuda.empty_cache()
    out["leg_s"] = time.perf_counter() - t_leg
    _log(f"[prims] leg {out['leg_s']:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=500)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--chunked-cap", type=float, default=4.0)
    ap.add_argument("--obs-dir", default=None,
                    help="keep the [obs] leg's timeline, flight dump and "
                         "profiles here (default: a temporary directory, "
                         "removed after the leg)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    # 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "raft_tpu_torch")):
        print("chip_smoke: raft_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, here)
    import numpy as np

    from raft_tpu_torch.bench.dataset import DeviceSynthetic
    from raft_tpu_torch.neighbors import brute_force, ivf_common, ivf_pq
    from raft_tpu_torch.neighbors import refine as trefine
    from raft_tpu_torch.ops import build as kbuild
    from raft_tpu_torch.ops import kernels as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    _log(f"[probe] torch {torch.__version__} cuda {torch.version.cuda}; "
         f"card: {kind}; host: {ram / 2**30:.1f} GiB RAM, "
         f"{os.cpu_count()} CPUs")

    # 2. build
    t0 = time.perf_counter()
    per_src = kbuild.build_all()
    _log(f"[build] {len(per_src)} kernels in "
         f"{time.perf_counter() - t0:.1f} s: "
         + ", ".join(f"{k} {v:.1f}s" for k, v in per_src.items()))
    for src, entries in kbuild.register_report().items():
        _log(f"[build] {src} (ptxas): " + "; ".join(
            f"{e} {r} registers, spills {st}/{ld} bytes stored/loaded"
            for e, r, st, ld in entries))

    # 3. the IVF-PQ path
    N, dim, B = args.n, 96, args.batch
    t0 = time.perf_counter()
    ds = DeviceSynthetic(N, dim, n_centers=10_000, seed=args.seed,
                         std=0.5, scale=10.0)
    base = ds.base()
    queries = ds.queries(args.queries)
    torch.cuda.synchronize()
    _log(f"[data] {N} x {dim} f32 base + {args.queries} queries in "
         f"{time.perf_counter() - t0:.1f} s")
    iparams = ivf_pq.IndexParams(n_lists=8192, pq_dim=64, pq_bits=8,
                                 cache_reconstruction="never",
                                 seed=args.seed)
    k = 10
    sp = ivf_pq.SearchParams(n_probes=64, scan_select="pallas",
                             refine="f32_regen", refine_ratio=40,
                             lut_dtype="bfloat16")
    stages = {}

    def search_pass(filter_bitset=None):
        """All queries in batches of B; seconds from CUDA events recorded
        before the first batch and after the last."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        start.record()
        for a in range(0, args.queries, B):
            out.append(ivf_pq.search(index, queries[a:a + B], k, sp,
                                     filter_bitset=filter_bitset,
                                     dataset=base)[1])
        end.record()
        torch.cuda.synchronize()
        return torch.cat(out), start.elapsed_time(end) / 1e3

    from raft_tpu_torch import obs

    K.reset_launch_counts()
    # the build records its spans and index gauges (obs on, no sync mode)
    # for the [obs] leg; every search pass below runs with obs off
    build_reg = obs.MetricsRegistry()
    obs.enable(registry=build_reg)
    t0 = time.perf_counter()
    try:
        index = ivf_pq.build(base, iparams, stage_seconds=stages)
        torch.cuda.synchronize()
    finally:
        obs.disable()
    build_s = time.perf_counter() - t0
    ids_k, search_s = search_pass()
    launches = K.launch_counts()
    ids_k = ids_k.cpu()
    # QPS of the first pass and of two more over the same queries: the
    # spread between passes is part of the result
    qps_runs = [args.queries / search_s] + [
        args.queries / search_pass()[1] for _ in range(2)]
    _log(f"[main] build {build_s:.1f} s ("
         + ", ".join(f"{s} {v:.1f}s" for s, v in stages.items())
         + f"); L = {index.max_list_size}; search {args.queries} queries, "
         f"three passes (CUDA events): "
         + ", ".join(f"{q:.0f}" for q in qps_runs) + " QPS")
    _log(f"[main] launches {json.dumps(launches)}")
    missing = [n for n in PQ_KERNELS if launches[n] == 0]
    if missing:
        return _fail(f"kernels never launched on the IVF-PQ path: {missing}")
    if ids_k.shape != (args.queries, k) or bool((ids_k < 0).any()):
        return _fail("search returned a malformed id table")

    # 4. checks
    n_gt = min(1000, args.queries)
    _, gt = brute_force.knn_arrays(base, queries[:n_gt], k,
                                   metric="sqeuclidean")
    gt = gt.cpu()
    rec_bf16 = _recall(ids_k[:n_gt], gt)
    sp32 = ivf_pq.SearchParams(**{**sp.__dict__, "lut_dtype": "float32"})
    ids32 = torch.cat([ivf_pq.search(index, queries[a:a + B], k, sp32,
                                     dataset=base)[1]
                       for a in range(0, n_gt, B)]).cpu()
    rec_f32 = _recall(ids32, gt)
    _log(f"[recall] recall@10 on {n_gt} queries: bf16 LUT {rec_bf16:.4f}, "
         f"f32 LUT {rec_f32:.4f}")
    n_pl = min(200, n_gt)
    t0 = time.perf_counter()
    arrays, meta = ivf_pq.to_numpy(index)
    index_cpu = ivf_pq.from_numpy(arrays, meta, device="cpu")
    base_cpu = base.cpu()
    _, ids_pl = ivf_pq.search(index_cpu, queries[:n_pl].cpu(), k, sp,
                              dataset=base_cpu, device="cpu")
    rec_plain = _recall(ids_pl, gt[:n_pl])
    rec_kern = _recall(ids_k[:n_pl], gt[:n_pl])
    del arrays
    _log(f"[recall] {n_pl} queries: kernel path {rec_kern:.4f}, plain path "
         f"(CPU) {rec_plain:.4f} ({time.perf_counter() - t0:.1f} s)")
    if not (rec_kern >= rec_plain - 0.01):
        return _fail(f"kernel-path recall {rec_kern} is more than 0.01 below "
                     f"the plain path's {rec_plain}")

    # 5. kernels against their plain versions, on main-path inputs
    rows = []
    q0 = queries[:B].contiguous()

    try:
        # fused_l2_argmin: the build's assignment, the whole base against
        # the 8192 centers
        _argmin_row(rows, "ivf_pq", launches, base,
                    index.centers.contiguous(), "")
        # select_k: the coarse probes of the first batch, ⟨q, c⟩ with the
        # ‖c‖² bias row the kernel folds in (c_sq − 2·qc)
        c_sq = ivf_pq._center_sq(index)
        scores = (q0 @ index.centers.T).contiguous()
        _select_k_row(rows, "ivf_pq", launches, scores, 64, "", bias=c_sq)
    except SmokeFailure as e:
        return _fail(str(e))

    # ivfpq_lut_scan_topk: the first batch's segments at k_cand = 400;
    # gather_refine_topk: the first batch's 400 scan candidates
    n_probes = sp.n_probes
    sp_scan = ivf_pq.SearchParams(**{**sp.__dict__, "refine": "none"})
    try:
        scan = _lut_scan_row(rows, "ivf_pq", launches, index, q0, n_probes,
                             "bfloat16")
        _, cand = ivf_pq.search(index, q0, 400, sp_scan)
        cand = cand.contiguous()
        _refine_row(rows, "ivf_pq", launches, base, q0, cand, k)
        bf16_summary = refine_bf16_leg(args, rows, index, base, queries, sp,
                                       B, k, gt, rec_bf16, q0, cand)
    except SmokeFailure as e:
        return _fail(str(e))
    kk, ki, probes = scan["kk"], scan["ki"], scan["probes"]
    seg, n_seg, q_rot = scan["seg"], scan["n_seg"], scan["q_rot"]
    C = cand.shape[1]

    # 6. where one batch's time goes: each stage of the refined search of
    # the first batch, timed alone on the card (CUDA events)
    dist = ivf_pq.resolve_metric(index.metric)
    q_sq0 = (q_rot * q_rot).sum(1)
    zeros = torch.zeros((B, n_probes * K.LUT_SCAN_BINS), device=q0.device)

    def finish():
        return ivf_pq._finish_candidates(-0.5 * kk.view(B, -1),
                                         ki.view(B, -1), zeros, q_sq0, dist,
                                         C)

    stages_ms = {
        "coarse_probes": _timed(lambda: ivf_pq._coarse_probes(
            index, q0, n_probes, False), 20),
        "segment_probes": _timed(lambda: ivf_common.segment_probes(
            probes, index.n_lists, seg, n_seg), 20),
        "rotate": _timed(lambda: q0 @ index.rotation.T, 20),
        "lut_scan": rows[2]["ms"],
        "finish": _timed(finish, 10),
        "refine": _timed(lambda: trefine.refine(base, q0, cand, k), 20),
        "search_total": _timed(lambda: ivf_pq.search(
            index, q0, k, sp, dataset=base), 5),
    }
    _log(f"[stages] one batch of {B} queries, ms: {json.dumps(stages_ms)}")

    # 7. [filter main]: the filtered main path at selectivity 0.1 and 0.01
    try:
        filt_summary = filter_main_leg(args, rows, index, base, queries,
                                       index_cpu, base_cpu, sp, B, k, n_gt,
                                       n_pl)
    except SmokeFailure as e:
        return _fail(str(e))
    del index_cpu, base_cpu

    # 8. [tiered] and [resilient]: the host-memory tier and the
    # degradation ladder on the same index (ROADMAP A11, A12)
    try:
        tiered_summary = tiered_leg(index, base, queries, sp, B, k, gt)
        resilient_summary = resilient_leg(index, base, queries, sp, B, k)
    except SmokeFailure as e:
        return _fail(str(e))

    # 9. [obs …]: the main path under observation (ROADMAP A13)
    try:
        t0 = time.perf_counter()
        obs_summary = obs_leg(args, index, base, queries, sp, B, k,
                              stages_ms, build_reg)
        obs_summary["leg_s"] = time.perf_counter() - t0
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[obs] leg in {obs_summary['leg_s']:.1f} s")

    # 10. [serve …]: single-query traffic through the serving plane
    # (ROADMAP A14)
    try:
        serve_summary = serve_leg(args, index, base, queries, sp, B, k)
    except SmokeFailure as e:
        return _fail(str(e))

    # 11. [tristates]: the kernel tri-states turned off on the main index
    # (ROADMAP A1)
    try:
        tristate_summary = tristates_leg(index, base, queries, sp, B, k, gt,
                                         rec_bf16, rec_f32)
    except SmokeFailure as e:
        return _fail(str(e))

    summary = {"n": N, "dim": dim, "n_lists": 8192, "pq_dim": 64,
               "max_list_size": index.max_list_size, "build_s": build_s,
               "build_stages_s": stages, "qps_runs": qps_runs,
               "recall_at_10_bf16": rec_bf16, "recall_at_10_f32": rec_f32,
               "recall_kernel_200": rec_kern, "recall_plain_200": rec_plain,
               "batch_stages_ms": stages_ms, "refine_bf16": bf16_summary,
               "filter": filt_summary,
               "tiered": tiered_summary, "resilient": resilient_summary,
               "obs": obs_summary, "serve": serve_summary,
               "tristates": tristate_summary}
    _log(f"[summary] {json.dumps(summary)}")
    del index, base, queries, cand, kk, ki, scores, scan
    torch.cuda.empty_cache()

    try:
        chunked_summary = chunked_phase(args, rows)
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[chunked summary] {json.dumps(chunked_summary)}")
    torch.cuda.empty_cache()

    try:
        data, flat_summary = flat_phase(args, rows)
        _log(f"[flat summary] {json.dumps(flat_summary)}")
        torch.cuda.empty_cache()
        pq_summary = pq_recon_phase(args, rows, **data)
        _log(f"[pq summary] {json.dumps(pq_summary)}")
        torch.cuda.empty_cache()
        flat_shard_summary = shard_flat_leg(args, rows, **data)
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[shard flat summary] {json.dumps(flat_shard_summary)}")
    del data
    torch.cuda.empty_cache()
    try:
        shard_summary = sharded_phase(args, rows)
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[shard summary] {json.dumps(shard_summary)}")
    torch.cuda.empty_cache()
    try:
        axis_summary = shard_axis_leg(args, rows)
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[shard axis summary] {json.dumps(axis_summary)}")
    torch.cuda.empty_cache()
    try:
        cagra_summary = cagra_leg(args, rows)
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[cagra summary] {json.dumps(cagra_summary)}")
    torch.cuda.empty_cache()
    try:
        ball_summary = ball_cover_leg(args, rows)
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[ball_cover summary] {json.dumps(ball_summary)}")
    torch.cuda.empty_cache()
    try:
        km_ds, km_x, kmeans_summary = kmeans_leg(args, rows)
        _log(f"[kmeans summary] {json.dumps(kmeans_summary)}")
        bf_summary = bf_index_leg(args, rows, km_ds, km_x)
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[bf index summary] {json.dumps(bf_summary)}")
    del km_ds, km_x
    torch.cuda.empty_cache()
    try:
        prims_summary = prims_leg(args, rows)
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[prims summary] {json.dumps(prims_summary)}")
    try:
        dist_summary = dist_build_phase(args, rows)
    except SmokeFailure as e:
        return _fail(str(e))
    _log(f"[dist summary] {json.dumps(dist_summary)}")
    _log(f"[wall] {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
