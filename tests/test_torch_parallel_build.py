"""The distributed chunked builds (``parallel.build``) of the port against
its own single-device builders and against the JAX package, on the CPU
(mirrors ``tests/test_build_distributed.py``).

The port's distributed build runs on a mesh of 8 CPU ranks, the JAX
package's on its 8-device CPU mesh (``tests/conftest.py``). The data are
1600 × 16 rows (200 a shard, chunks of 100 that line up with
``build_chunked``'s, as they must on the card).

Tolerances: a port build against the port's ``build_chunked`` /
``ivf_flat.build`` bit for bit (every field, and ``index_sha16``); a JAX
checkpoint finished by the port (and the reverse) gives the other
package's quantizers, ids, list sizes and codes exactly and its norms
within 3.2e-7 relative (ROADMAP's deliberate difference: XLA's f32 sum
order is not torch's); ``index_sha16`` of one index equal in both
packages; comms counters equal to the JAX package's.
"""

from __future__ import annotations

import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.obs.metrics import MetricsRegistry
from raft_tpu.parallel import build as jbuild
from raft_tpu.robust import faults as jfa
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.parallel import build as tbuild
from raft_tpu_torch.parallel import comms as tcomms
from raft_tpu_torch.parallel import ivf as tivf
from raft_tpu_torch.parallel import make_mesh
from raft_tpu_torch.robust import faults as tfa

from torch_parity import (jax_flat_arrays, jax_index_arrays, jax_mesh,
                          jax_sharded_pq_arrays)

CHUNK = 100
N_DEV = 8
SITE = "{site=ivf_pq.build_distributed}"


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfa, tfa):
        f.clear_plan()
    tspans.reset()
    yield
    for f in (jfa, tfa):
        f.clear_plan()
    jobs.disable()


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(11).random((1600, 16), dtype=np.float32)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_DEV, device="cpu")


def _kw(**kw):
    kw.setdefault("n_lists", 8)
    kw.setdefault("pq_dim", 8)
    kw.setdefault("kmeans_n_iters", 4)
    kw.setdefault("seed", 0)
    kw.setdefault("cache_reconstruction", "never")
    return kw


def _assert_identical(a, b):
    for name in ("centers", "centers_rot", "rotation", "codebooks",
                 "packed_data", "packed_codes", "packed_ids",
                 "packed_norms", "list_sizes"):
        if not hasattr(a, name):
            continue
        fa, fb = getattr(a, name), getattr(b, name)
        assert fa.dtype == fb.dtype, name
        assert torch.equal(fa, fb), name


# ---------------------------------------------------------------------------
# parity with the port's single-device builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["pq8", "pq4", "cosine"])
def test_distributed_build_is_build_chunked(mesh, data, variant):
    """Assembled, the 8-shard build equals ``build_chunked`` field for
    field and by ``index_sha16``; every stored id lies in its shard's
    slice (``rank · shard_rows + local``)."""
    kw = {"pq8": {}, "pq4": {"pq_bits": 4, "seed": 2},
          "cosine": {"metric": "cosine", "seed": 3}}[variant]
    params = tpq.IndexParams(**_kw(**kw))
    sharded = tpq.build_distributed(data, params, mesh=mesh,
                                    chunk_rows=CHUNK)
    single = tpq.build_chunked(data, params, chunk_rows=CHUNK, device="cpu")
    asm = tbuild.assemble_ivf_pq(sharded)
    _assert_identical(asm, single)
    assert tbuild.index_sha16(asm) == tbuild.index_sha16(single)
    sr = sharded.shard_rows
    for s in range(sharded.n_shards):
        own = sharded.packed_ids[s][sharded.packed_ids[s] >= 0]
        assert own.numel() and bool((own // sr == s).all())


def test_flat_distributed_build_is_ivf_flat_build(mesh, data):
    params = tflat.IndexParams(n_lists=8, kmeans_n_iters=4, seed=1)
    sharded = tflat.build_distributed(data, params, mesh=mesh,
                                      chunk_rows=CHUNK)
    single = tflat.build(data, params, device="cpu")
    asm = tbuild.assemble_ivf_flat(sharded)
    _assert_identical(asm, single)
    assert tbuild.index_sha16(asm) == tbuild.index_sha16(single)
    arrays, meta = sharded.to_numpy()
    back = tivf.ShardedIvfFlat.from_numpy(arrays, meta, mesh)
    assert tbuild.index_sha16(back) == tbuild.index_sha16(sharded)


def test_search_takes_the_per_shard_output(mesh, data):
    """The build's output searches as it is, through the parallel entry
    and through ``ivf_pq.search(mesh=)``: valid global ids, self-queries
    find themselves."""
    sharded = tpq.build_distributed(data, tpq.IndexParams(**_kw()),
                                    mesh=mesh, chunk_rows=CHUNK)
    q = data[:16]
    sp = tpq.SearchParams(n_probes=8)
    _, ids = tivf.search_ivf_pq(sp, sharded, q, 5, mesh)
    assert ids.shape == (16, 5) and int(ids.max()) < len(data)
    _, ids2 = tpq.search(sharded, q, 1, sp, mesh=mesh, device="cpu")
    assert (ids2[:, 0].numpy() == np.arange(16)).mean() >= 0.8


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

_JAX = {}


def _jax_clean(data):
    """The JAX package's uninterrupted distributed pq8 build (made once)."""
    if "clean" not in _JAX:
        _JAX["clean"] = jpq.build_distributed(
            data, jpq.IndexParams(**_kw()), mesh=jax_mesh(N_DEV),
            chunk_rows=CHUNK)
    return _JAX["clean"]


def _sharded_arrays(index):
    if isinstance(index, tivf.ShardedIvfPq):
        return tivf.to_numpy(index)[0]
    return jax_sharded_pq_arrays(index)[0]


def _assert_sharded_match(got, want):
    for name in ("centers", "centers_rot", "rotation", "codebooks",
                 "packed_codes", "packed_ids", "list_sizes"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(got["packed_norms"], want["packed_norms"],
                               rtol=3.2e-7, atol=0)


def _interrupt(pkg, data, d, after):
    faults = jfa if pkg == "jax" else tfa
    faults.install_plan({"faults": [
        {"site": "build.chunk_encode", "kind": "error", "after": after}]})
    with pytest.raises(faults.FaultInjected):
        if pkg == "jax":
            jpq.build_distributed(data, jpq.IndexParams(**_kw()),
                                  mesh=jax_mesh(N_DEV), chunk_rows=CHUNK,
                                  checkpoint_dir=str(d))
        else:
            tpq.build_distributed(data, tpq.IndexParams(**_kw()),
                                  mesh=make_mesh(N_DEV, device="cpu"),
                                  chunk_rows=CHUNK, checkpoint_dir=str(d))
    faults.clear_plan()
    return json.loads((d / "manifest.json").read_text())


def test_port_finishes_a_jax_checkpoint(mesh, data, tmp_path):
    """A JAX distributed build stopped in its encode pass, finished by the
    port: the JAX package's uninterrupted index (codes, ids, sizes exact,
    norms within 3.2e-7), its shards replayed and counted."""
    man = _interrupt("jax", data, tmp_path, after=6)
    done = man["shard_chunks_done"]
    assert man["n_shards"] == N_DEV and 0 < sum(done) < N_DEV * 2
    assert any(f.startswith("s000_shard_") for f in os.listdir(tmp_path))
    got = tpq.build_distributed(data, tpq.IndexParams(**_kw()), mesh=mesh,
                                chunk_rows=CHUNK,
                                checkpoint_dir=str(tmp_path), resume=True)
    _assert_sharded_match(_sharded_arrays(got),
                          _sharded_arrays(_jax_clean(data)))
    assert tspans.counts()["resume.attempts"][SITE[1:-1]] == 1
    assert tspans.counts()["resume.chunks_replayed"][SITE[1:-1]] == sum(done)
    assert json.loads((tmp_path / "manifest.json").read_text())[
        "phase"] == "done"


def test_jax_finishes_a_port_checkpoint(mesh, data, tmp_path):
    """The reverse: a port build stopped in its encode pass, finished by
    the JAX package, gives the port's uninterrupted index (its quantizers
    are the port's, loaded from the checkpoint)."""
    _interrupt("port", data, tmp_path, after=6)
    got = jpq.build_distributed(data, jpq.IndexParams(**_kw()),
                                mesh=jax_mesh(N_DEV), chunk_rows=CHUNK,
                                checkpoint_dir=str(tmp_path), resume=True)
    want = tpq.build_distributed(data, tpq.IndexParams(**_kw()), mesh=mesh,
                                 chunk_rows=CHUNK)
    _assert_sharded_match(_sharded_arrays(got), _sharded_arrays(want))


def test_index_sha16_is_the_jax_packages(mesh, data):
    """One index, one sha in both packages: the JAX package's sharded pq
    build, its assembly, and a JAX ``ivf_flat`` index, each crossed to the
    port as numpy."""
    jsh = _jax_clean(data)
    arrays, meta = jax_sharded_pq_arrays(jsh)
    tsh = tivf.from_numpy(arrays, meta, mesh)
    assert tbuild.index_sha16(tsh) == jbuild.index_sha16(jsh)
    jasm = jbuild.assemble_ivf_pq(jsh)
    a, m = jax_index_arrays(jasm)
    assert tbuild.index_sha16(tpq.from_numpy(a, m, device="cpu")) == \
        jbuild.index_sha16(jasm)
    jf = jflat.build(jnp.asarray(data), jflat.IndexParams(n_lists=8,
                                                          kmeans_n_iters=4))
    a, m = jax_flat_arrays(jf)
    assert tbuild.index_sha16(tflat.from_numpy(a, m, device="cpu")) == \
        jbuild.index_sha16(jf)


def test_comms_are_allgatherv_only_with_the_jax_byte_counts(mesh, data):
    reg = MetricsRegistry()
    jobs.enable(registry=reg, hbm=False)
    try:
        jpq.build_distributed(data, jpq.IndexParams(**_kw()),
                              mesh=jax_mesh(N_DEV), chunk_rows=CHUNK)
    finally:
        jobs.disable()
    jc = {k: v for k, v in reg.snapshot()["counters"].items()
          if k.startswith("comms.")}
    tcomms.reset_counters()
    tpq.build_distributed(data, tpq.IndexParams(**_kw()), mesh=mesh,
                          chunk_rows=CHUNK)
    tc = tcomms.counters()
    assert set(tc["ops"]) == {("allgatherv", "shard")}
    assert tc["ops"][("allgatherv", "shard")] == jc[
        "comms.ops{axis=shard,op=allgatherv}"] == 2
    assert tc["bytes"][("allgatherv", "shard")] == jc[
        "comms.bytes{axis=shard,op=allgatherv}"]
    c = tspans.counts()
    assert c["build.prefetch.hit"].get(SITE[1:-1], 0) + c[
        "build.prefetch.stall"].get(SITE[1:-1], 0) == 2 * 16


# ---------------------------------------------------------------------------
# resume, refusals, the distributed coarse mode
# ---------------------------------------------------------------------------

def test_resumed_build_is_the_uninterrupted_one(mesh, data, tmp_path):
    man = _interrupt("port", data, tmp_path, after=6)
    assert man["phase"] == "encode" and man["shard_rows"] == 200
    resumed = tpq.build_distributed(data, tpq.IndexParams(**_kw()),
                                    mesh=mesh, chunk_rows=CHUNK,
                                    checkpoint_dir=str(tmp_path),
                                    resume=True)
    clean = tpq.build_distributed(data, tpq.IndexParams(**_kw()), mesh=mesh,
                                  chunk_rows=CHUNK)
    assert tbuild.index_sha16(resumed) == tbuild.index_sha16(clean)
    assert tspans.counts()["resume.chunks_replayed"][SITE[1:-1]] == sum(
        man["shard_chunks_done"])


@pytest.mark.parametrize("case", ["wrong_dataset", "no_dir", "spill",
                                  "coarse", "assemble_cap"])
def test_refusals(mesh, data, tmp_path, case):
    params = tpq.IndexParams(**_kw())
    if case == "wrong_dataset":
        _interrupt("port", data, tmp_path, after=1)
        other = np.random.default_rng(99).random(data.shape,
                                                 dtype=np.float32)
        with pytest.raises(Exception, match="different dataset"):
            tpq.build_distributed(other, params, mesh=mesh,
                                  chunk_rows=CHUNK,
                                  checkpoint_dir=str(tmp_path), resume=True)
    elif case == "no_dir":
        with pytest.raises(Exception, match="checkpoint_dir"):
            tpq.build_distributed(data, params, mesh=mesh, resume=True)
    elif case == "spill":
        with pytest.raises(Exception, match="spill"):
            tpq.build_distributed(data, tpq.IndexParams(**_kw(spill=True)),
                                  mesh=mesh)
    elif case == "coarse":
        with pytest.raises(Exception, match="coarse"):
            tbuild.build_ivf_pq_distributed(data, params, mesh,
                                            coarse="nope")
    else:
        sh = tivf.build_ivf_pq(params, data[:512], mesh)
        with pytest.raises(Exception, match="global_list_cap"):
            tbuild.assemble_ivf_pq(sh)


def test_distributed_coarse_mode_searches(mesh, data):
    """``coarse="distributed"``: the coarse fit rides the distributed
    Lloyd (allreduce traffic), and the codebooks train against its
    centers (self-queries find themselves)."""
    tcomms.reset_counters()
    sharded = tpq.build_distributed(data, tpq.IndexParams(**_kw()),
                                    mesh=mesh, chunk_rows=CHUNK,
                                    coarse="distributed")
    assert tcomms.counters()["ops"].get(("allreduce", "shard"), 0) > 0
    _, ids = tivf.search_ivf_pq(tpq.SearchParams(n_probes=8), sharded,
                                data[:16], 3, mesh)
    assert int(ids.max()) < len(data)
    assert (ids[:, 0].numpy() == np.arange(16)).mean() >= 0.7


# ---------------------------------------------------------------------------
# the prefetcher's contracts
# ---------------------------------------------------------------------------

def test_prefetch_hit_and_stall_accounting():
    pf = tbuild.ChunkPrefetcher(lambda a, b: np.arange(a, b),
                                [(0, 4), (4, 8), (8, 12)], counter_site="t")
    try:
        first = pf.get()
        time.sleep(0.3)
        rest = [pf.get(), pf.get()]
    finally:
        pf.close()
    assert np.array_equal(first, np.arange(0, 4))
    assert np.array_equal(rest[1], np.arange(8, 12))
    hit = tspans.total("build.prefetch.hit", site="t")
    stall = tspans.total("build.prefetch.stall", site="t")
    assert hit >= 2 and hit + stall == 3


def test_prefetch_serial_mode_counts_stalls_only():
    pf = tbuild.ChunkPrefetcher(lambda a, b: np.arange(a, b),
                                [(0, 2), (2, 4)], prefetch=False,
                                counter_site="t")
    try:
        pf.get(), pf.get()
    finally:
        pf.close()
    assert tspans.total("build.prefetch.stall", site="t") == 2
    assert tspans.total("build.prefetch.hit", site="t") == 0


def test_prefetch_reader_exception_propagates():
    def boom(a, b):
        if a >= 2:
            raise IOError("disk gone")
        return np.arange(a, b)

    pf = tbuild.ChunkPrefetcher(boom, [(0, 2), (2, 4), (4, 6)])
    try:
        assert np.array_equal(pf.get(), np.arange(0, 2))
        with pytest.raises(IOError, match="disk gone"):
            pf.get()
            pf.get()
    finally:
        pf.close()


def test_prefetch_exhausted_raises():
    pf = tbuild.ChunkPrefetcher(lambda a, b: np.arange(a, b), [(0, 1)])
    try:
        pf.get()
        with pytest.raises(IndexError):
            pf.get()
    finally:
        pf.close()


def test_prefetch_clean_shutdown_mid_stream():
    n_before = threading.active_count()
    pf = tbuild.ChunkPrefetcher(lambda a, b: np.zeros(b - a),
                                [(i, i + 1) for i in range(64)], depth=2)
    pf.get()
    pf.close()
    pf.close()  # idempotent
    assert pf._thread is None
    assert threading.active_count() <= n_before + 1


def test_prefetch_faulted_read_retries_under_io_policy():
    tfa.install_plan({"faults": [
        {"site": "build.chunk_read", "kind": "error", "times": 1}]})
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    read = tbuild._make_read_chunk(x, False, torch.device("cpu"))
    pf = tbuild.ChunkPrefetcher(read, [(0, 5), (5, 10)])
    try:
        a, b = pf.get(), pf.get()
    finally:
        pf.close()
        tfa.clear_plan()
    assert np.array_equal(torch.cat([a, b]).numpy(), x)
    assert tspans.total("retry.recovered", site="build.chunk_read") == 1


def test_shard_ranges_match_jax():
    for n, n_dev in ((1600, 8), (1043, 8), (5, 8), (7, 1)):
        assert tbuild.shard_ranges(n, n_dev) == jbuild.shard_ranges(n, n_dev)
