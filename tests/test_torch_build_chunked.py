"""``ivf_pq.build_chunked`` (ROADMAP A9), its checkpoints, the provider's
``sample_rows``, the streamed ground truth, lane-folded index files and
``core.interruptible``: the port against the JAX package, on the CPU.

Checkpoints cross both ways: a build one package interrupted (an injected
error at ``build.chunk_encode``, as ``tests/test_build_resume.py`` does)
is finished by the other, and the result is held to the finishing side's
own uninterrupted build. The data are that file's fixtures (2200 × 24,
n_lists 8, pq_dim 8; 1600 × 16 with spill).

Tolerances: quantizers, ids and list sizes exact; codes exact but where a
row's encode argmin ties in f64 (each such code is checked and counted);
norms of rows replayed from the other package's shards exact, norms of
rows the other package encoded within rtol 1e-6 (‖c + d‖² is an f32 sum
whose order differs between XLA and torch: a few ulps); labels of a label
pass exact but at f64 argmin ties; a port build against itself, and
every build from the same rows, bit for bit; provider rows within 1e-6 of
the JAX provider's (``bench/dataset.py``: the generators' normals differ
in their last bits); the streamed ground truth equal to ``brute_force``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.robust import checkpoint as jck
from raft_tpu.robust import faults as jfa
from raft_tpu_torch.bench import dataset as tds
from raft_tpu_torch.core import interruptible as tint
from raft_tpu_torch.core.errors import LogicError
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.obs import spans as tspans
from raft_tpu_torch.robust import checkpoint as tck
from raft_tpu_torch.robust import degrade as tdg
from raft_tpu_torch.robust import faults as tfa

from torch_parity import INDEX_FIELDS

CHUNK = 400
SITE = "ivf_pq.build_chunked"


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfa, tfa):
        f.clear_plan()
    tdg.clear_recent()
    tspans.reset()
    yield
    for f in (jfa, tfa):
        f.clear_plan()


def _data(spill: bool) -> np.ndarray:
    rng = np.random.default_rng(3 if spill else 11)
    return rng.random((1600, 16) if spill else (2200, 24), dtype=np.float32)


def _kw(spill: bool, **more):
    kw = dict(n_lists=8, pq_dim=8, seed=0, kmeans_n_iters=8,
              cache_reconstruction="never", **more)
    if spill:
        kw.update(spill=True, list_size_cap_factor=1.5)
    return kw


def _arrays(index):
    """An index of either package as numpy arrays."""
    return {name: (getattr(index, name).numpy()
                   if isinstance(getattr(index, name), torch.Tensor)
                   else np.asarray(getattr(index, name)))
            for name in INDEX_FIELDS}


def _interrupt(pkg, x, d, params, after):
    """A checkpointed build of ``pkg`` ("jax" or "port") stopped by an
    injected error at the ``after``-th encode chunk; its manifest."""
    faults, build = ((jfa, jpq.build_chunked) if pkg == "jax"
                     else (tfa, lambda *a, **k: tpq.build_chunked(
                         *a, device="cpu", **k)))
    faults.install_plan({"faults": [
        {"site": "build.chunk_encode", "kind": "error", "after": after}]})
    with pytest.raises(faults.FaultInjected):
        build(x, params, chunk_rows=CHUNK, checkpoint_dir=str(d))
    faults.clear_plan()
    with open(os.path.join(str(d), "manifest.json")) as f:
        return json.load(f)


# (spill, after): the interruptions of tests/test_build_resume.py
RESUMES = [(False, 3), (True, 2)]
_JAX = {}


def _jax_reference(spill: bool, root):
    """The JAX package's uninterrupted checkpointed build (arrays and its
    label pass) and a checkpoint it left interrupted, made once."""
    if spill not in _JAX:
        x = _data(spill)
        after = dict(RESUMES)[spill]
        clean_dir, cut_dir = root / f"jax_clean_{spill}", root / f"jax_cut_{spill}"
        clean = jpq.build_chunked(x, jpq.IndexParams(**_kw(spill)),
                                  chunk_rows=CHUNK,
                                  checkpoint_dir=str(clean_dir))
        man = _interrupt("jax", x, cut_dir, jpq.IndexParams(**_kw(spill)),
                         after)
        _JAX[spill] = dict(
            arrays=_arrays(clean), cut_dir=cut_dir, manifest=man,
            labels=jck.BuildCheckpoint(str(clean_dir)).load_arrays(
                "labels")["labels"])
    return _JAX[spill]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("build_chunked")


def _code_ties(got, want, x, quant) -> int:
    """Codes equal but where the encode argmin ties in f64: for every
    differing code, the two codewords' f64 distances to the row's rotated
    residual sub-vector agree within the f32 rounding of the expanded
    form. Returns the count of differing codes."""
    rot = quant["rotation"].astype(np.float64)
    cb = quant["codebooks"].astype(np.float64)
    S, _, P = cb.shape
    n_tied = 0
    for lst, j in zip(*np.nonzero((got["packed_codes"]
                                   != want["packed_codes"]).any(-1))):
        row = int(want["packed_ids"][lst, j])
        res = (x[row].astype(np.float64) @ rot.T
               - quant["centers_rot"][lst].astype(np.float64))
        for s in np.nonzero(got["packed_codes"][lst, j]
                            != want["packed_codes"][lst, j])[0]:
            sub = res[s * P:(s + 1) * P]
            ca, cw = (cb[s, int(c[lst, j, s])] for c in
                      (got["packed_codes"], want["packed_codes"]))
            da, dw = ((sub - ca) ** 2).sum(), ((sub - cw) ** 2).sum()
            scale = (sub ** 2).sum() + max((ca ** 2).sum(), (cw ** 2).sum())
            assert abs(da - dw) <= 1e-6 * scale + 1e-9, (lst, j, s, da, dw)
            n_tied += 1
    return n_tied


def _assert_index_matches(got, want, x, replayed_rows: int):
    """``got`` (finished by one package) against ``want`` (the other's
    uninterrupted build): exact quantizers, ids and sizes; codes but at
    f64 ties; norms exact on rows replayed from a shard, rtol 1e-6 on the
    rest. Returns the count of tied codes."""
    for name in ("centers", "centers_rot", "rotation", "codebooks",
                 "packed_ids", "list_sizes"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    ties = _code_ties(got, want, x, want)
    assert ties <= 0.01 * x.shape[0]
    ids = want["packed_ids"]
    replayed = (ids >= 0) & (ids < replayed_rows)
    np.testing.assert_array_equal(got["packed_norms"][replayed],
                                  want["packed_norms"][replayed])
    np.testing.assert_allclose(got["packed_norms"], want["packed_norms"],
                               rtol=1e-6, atol=0)
    return ties


@pytest.mark.parametrize("spill,after", RESUMES)
def test_port_resumes_a_jax_checkpoint(spill, after, root, tmp_path):
    """A JAX build stopped in its encode pass, finished by the port: the
    JAX package's uninterrupted index, its shards replayed (counted under
    ``resume.*{site=ivf_pq.build_chunked}``)."""
    ref = _jax_reference(spill, root)
    d = tmp_path / "ckpt"
    shutil.copytree(ref["cut_dir"], d)
    x = _data(spill)
    got = tpq.build_chunked(x, tpq.IndexParams(**_kw(spill)),
                            chunk_rows=CHUNK, checkpoint_dir=str(d),
                            resume=True, device="cpu")
    done = ref["manifest"]["chunks_done"]
    assert 0 < done < ref["manifest"]["n_chunks"]
    _assert_index_matches(_arrays(got), ref["arrays"], x, done * CHUNK)
    assert tspans.total("resume.attempts", site=SITE) == 1
    assert tspans.total("resume.chunks_replayed", site=SITE) == done
    man = json.loads((d / "manifest.json").read_text())
    assert man["phase"] == "done" and man["chunks_done"] == man["n_chunks"]


def _label_ties(got, want, x, centers) -> int:
    """Labels equal but where the row's nearest center ties in f64."""
    c64 = centers.astype(np.float64)
    bad = np.nonzero(got != want)[0]
    for row in bad:
        d = ((x[row].astype(np.float64) - c64) ** 2).sum(1)
        pair = d[[got[row], want[row]]]
        assert abs(pair[0] - pair[1]) <= 1e-6 * d.min() + 1e-9, row
    return len(bad)


@pytest.mark.parametrize("spill", [False, True])
def test_port_finishes_a_jax_label_phase(spill, root, tmp_path):
    """A JAX build stopped at its first label read (manifest at phase
    ``label``: only the trained quantizers on disk), finished by the port:
    the port's label pass gives the JAX package's labels away from argmin
    ties, and then its index."""
    ref = _jax_reference(spill, root)
    x = _data(spill)
    d = tmp_path / "ckpt"
    jfa.install_plan({"faults": [
        {"site": "build.chunk_read", "kind": "oom", "times": 1}]})
    with pytest.raises(jfa.InjectedResourceExhausted):
        jpq.build_chunked(x, jpq.IndexParams(**_kw(spill)),
                          chunk_rows=CHUNK, checkpoint_dir=str(d))
    jfa.clear_plan()
    assert json.loads((d / "manifest.json").read_text())["phase"] == "label"
    got = tpq.build_chunked(x, tpq.IndexParams(**_kw(spill)),
                            chunk_rows=CHUNK, checkpoint_dir=str(d),
                            resume=True, device="cpu")
    labels = tck.BuildCheckpoint(str(d)).load_arrays("labels")["labels"]
    # the fixtures label with no f64 argmin tie, so the index is held too
    assert _label_ties(labels, ref["labels"], x,
                       ref["arrays"]["centers"]) == 0
    _assert_index_matches(_arrays(got), ref["arrays"], x, 0)
    assert tspans.total("resume.chunks_replayed", site=SITE) == 0


@pytest.mark.parametrize("spill,after", RESUMES)
def test_jax_resumes_a_port_checkpoint(spill, after, tmp_path):
    """The reverse direction: a port build stopped in its encode pass,
    finished by the JAX package, gives the port's uninterrupted index."""
    x = _data(spill)
    man = _interrupt("port", x, tmp_path, tpq.IndexParams(**_kw(spill)),
                     after)
    got = jpq.build_chunked(x, jpq.IndexParams(**_kw(spill)),
                            chunk_rows=CHUNK, checkpoint_dir=str(tmp_path),
                            resume=True)
    want = tpq.build_chunked(x, tpq.IndexParams(**_kw(spill)),
                             chunk_rows=CHUNK, device="cpu")
    _assert_index_matches(_arrays(got), _arrays(want), x,
                          man["chunks_done"] * CHUNK)


@pytest.mark.parametrize("spill,after", RESUMES)
def test_port_resumed_build_is_bit_identical(spill, after, tmp_path):
    """A killed-and-resumed port build equals its uninterrupted build (no
    checkpoint) bit for bit; a fresh checkpointed build writes every
    shard and a manifest at phase done."""
    x = _data(spill)
    p = tpq.IndexParams(**_kw(spill))
    _interrupt("port", x, tmp_path / "cut", p, after)
    resumed = tpq.build_chunked(x, p, chunk_rows=CHUNK,
                                checkpoint_dir=str(tmp_path / "cut"),
                                resume=True, device="cpu")
    fresh = tpq.build_chunked(x, p, chunk_rows=CHUNK,
                              checkpoint_dir=str(tmp_path / "fresh"),
                              device="cpu")
    clean = tpq.build_chunked(x, p, chunk_rows=CHUNK, device="cpu")
    for other in (resumed, fresh):
        for name, a in _arrays(other).items():
            np.testing.assert_array_equal(a, _arrays(clean)[name], name)
    man = json.loads((tmp_path / "fresh" / "manifest.json").read_text())
    shards = [f for f in os.listdir(tmp_path / "fresh")
              if f.startswith("shard_")]
    assert man["phase"] == "done" and len(shards) == man["n_chunks"]


@pytest.mark.parametrize("has_manifest", [False, True])
def test_resume_auto(has_manifest, tmp_path):
    """``resume="auto"`` resumes when a manifest exists and builds fresh
    otherwise; either way the uninterrupted build's index."""
    x = _data(False)
    p = tpq.IndexParams(**_kw(False))
    if has_manifest:
        _interrupt("port", x, tmp_path, p, 2)
    got = tpq.build_chunked(x, p, chunk_rows=CHUNK,
                            checkpoint_dir=str(tmp_path), resume="auto",
                            device="cpu")
    clean = tpq.build_chunked(x, p, chunk_rows=CHUNK, device="cpu")
    for name, a in _arrays(got).items():
        np.testing.assert_array_equal(a, _arrays(clean)[name], name)
    assert tspans.total("resume.attempts", site=SITE) == int(has_manifest)


def _break(kind, d):
    if kind == "truncated_manifest":
        raw = (d / "manifest.json").read_text()
        (d / "manifest.json").write_text(raw[:len(raw) // 2])
    elif kind == "missing_shard":
        os.unlink(d / "shard_000000.npz")
    elif kind == "missing_quantizers":
        os.unlink(d / "quantizers.npz")


# (case, what the resume passes, the refusal's words): the JAX package's
# refusals (tests/test_build_resume.py)
REFUSALS = [
    ("needs_dir", dict(resume=True, checkpoint_dir=None),
     "needs checkpoint_dir"),
    ("no_manifest", dict(resume=True, fresh_dir=True), "no build manifest"),
    ("wrong_dataset", dict(resume=True, other_data=True),
     "different dataset"),
    ("wrong_params", dict(resume=True, pq_bits=4),
     "different build parameters"),
    ("wrong_chunk_rows", dict(resume=True, chunk_rows=2 * CHUNK),
     "different build parameters"),
    ("truncated_manifest", dict(resume=True), "not valid JSON"),
    ("missing_shard", dict(resume=True), "shard_000000.npz is missing"),
    ("missing_quantizers", dict(resume=True), "missing quantizers.npz"),
    ("bad_resume", dict(resume="yes please"), "resume must be"),
]


@pytest.mark.parametrize("case,how,words", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_resume_refusals(case, how, words, tmp_path):
    """Each wrong resume is a clear refusal, never a partial index."""
    x = _data(False)
    d = tmp_path / "ckpt"
    _interrupt("port", x, d, tpq.IndexParams(**_kw(False)), 3)
    _break(case, d)
    how = dict(how)
    data = (np.random.default_rng(99).random(x.shape, dtype=np.float32)
            if how.pop("other_data", False) else x)
    ck_dir = tmp_path / "empty" if how.pop("fresh_dir", False) else d
    chunk_rows = how.pop("chunk_rows", CHUNK)
    resume = how.pop("resume")
    ck_dir = how.pop("checkpoint_dir", str(ck_dir))
    with pytest.raises(LogicError, match=words):
        tpq.build_chunked(data, tpq.IndexParams(**_kw(False, **how)),
                          chunk_rows=chunk_rows, checkpoint_dir=ck_dir,
                          resume=resume, device="cpu")


def test_params_fingerprint_is_the_jax_packages():
    """The manifest's params sha is the same bytes in both packages (the
    port's IndexParams has the JAX package's fields)."""
    import dataclasses

    extra = {"chunk_rows": CHUNK, "max_train_rows": 1 << 21}
    for spill in (False, True):
        pj = {**dataclasses.asdict(jpq.IndexParams(**_kw(spill))), **extra}
        pt = {**dataclasses.asdict(tpq.IndexParams(**_kw(spill))), **extra}
        assert tck.params_fingerprint(pt) == jck.params_fingerprint(pj)


class _Recording:
    """Rows of an array behind the provider interface, recording the
    train-sample indices a build asks ``sample_rows`` for."""

    def __init__(self, x):
        self.x, self.shape, self.dtype, self.asked = x, x.shape, x.dtype, []

    def __getitem__(self, sl):
        return self.x[sl]

    def sample_rows(self, idx):
        self.asked.append(np.asarray(idx).copy())
        return self.x[idx]


def test_inputs_memmap_provider_and_train_sample(tmp_path):
    """A memmap and a provider build as the array does, bit for bit; both
    packages draw the same sorted train sample (numpy's generator, shared)
    and ask a provider for it through ``sample_rows``."""
    x = _data(False)
    p = tpq.IndexParams(**_kw(False))
    mm = np.memmap(tmp_path / "base.f32", np.float32, "w+", shape=x.shape)
    mm[:] = x
    mm.flush()
    ro = np.memmap(tmp_path / "base.f32", np.float32, "r", shape=x.shape)
    rec_t, rec_j = _Recording(x), _Recording(x)
    clean = _arrays(tpq.build_chunked(x, p, chunk_rows=CHUNK,
                                      max_train_rows=512, device="cpu"))
    for src in (ro, rec_t):
        got = _arrays(tpq.build_chunked(src, p, chunk_rows=CHUNK,
                                        max_train_rows=512, device="cpu"))
        for name, a in got.items():
            np.testing.assert_array_equal(a, clean[name], name)
    jpq.build_chunked(rec_j, jpq.IndexParams(**_kw(False)), chunk_rows=CHUNK,
                      max_train_rows=512)
    assert len(rec_t.asked) == len(rec_j.asked) == 1
    np.testing.assert_array_equal(rec_t.asked[0], rec_j.asked[0])
    assert rec_t.asked[0].shape == (512,)
    assert (np.diff(rec_t.asked[0]) > 0).all()


def test_device_chunk_provider_builds_and_samples_rows():
    """``DeviceSyntheticChunks`` on the CPU: ``sample_rows`` gives the
    provider's own rows bit for bit and the JAX provider's within 1e-6;
    a build from the provider equals the build from its rows as an array."""
    from raft_tpu.bench.dataset import DeviceSyntheticChunks as JChunks

    n, d = 3000, 16
    prov = tds.DeviceSyntheticChunks(n, d, n_centers=40, seed=4,
                                     chunk_rows=1024, device="cpu")
    rows = prov[0:n]
    idx = np.sort(np.random.default_rng(0).choice(n, 700, replace=False))
    got = prov.sample_rows(idx)
    assert torch.equal(got, rows[torch.as_tensor(idx)])
    jrows = np.asarray(JChunks(n, d, n_centers=40, seed=4,
                               chunk_rows=1024).sample_rows(idx))
    np.testing.assert_allclose(got.numpy(), jrows, rtol=0, atol=1e-6)
    p = tpq.IndexParams(**_kw(False))
    a = _arrays(tpq.build_chunked(prov, p, chunk_rows=CHUNK, device="cpu"))
    b = _arrays(tpq.build_chunked(rows.numpy(), p, chunk_rows=CHUNK,
                                  device="cpu"))
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], name)


def test_chunk_read_fault_is_retried():
    """An injected ``build.chunk_read`` error is retried under IO_POLICY
    (counted ``retry.recovered{site=build.chunk_read}``) and the build
    is the clean one."""
    x = _data(False)
    p = tpq.IndexParams(**_kw(False))
    clean = _arrays(tpq.build_chunked(x, p, chunk_rows=CHUNK, device="cpu"))
    tfa.install_plan({"faults": [
        {"site": "build.chunk_read", "kind": "error", "times": 1}]})
    got = _arrays(tpq.build_chunked(x, p, chunk_rows=CHUNK, device="cpu"))
    assert tspans.total("retry.recovered", site="build.chunk_read") == 1
    assert tspans.total("retry.attempts", site="build.chunk_read") >= 2
    for name, a in got.items():
        np.testing.assert_array_equal(a, clean[name], name)


def test_oom_at_encode_halves_the_chunk():
    """An injected RESOURCE_EXHAUSTED on an encode chunk's read (the third
    read: two label reads come first) walks ``half_chunk`` once, and the
    index equals the unhalved build's."""
    x = _data(False)
    p = tpq.IndexParams(**_kw(False))
    clean = _arrays(tpq.build_chunked(x, p, chunk_rows=2048, device="cpu"))
    tfa.install_plan({"faults": [
        {"site": "build.chunk_read", "kind": "oom", "after": 3,
         "times": 1}]})
    got = _arrays(tpq.build_chunked(x, p, chunk_rows=2048, device="cpu"))
    assert tspans.total("degrade.steps", site=SITE, to="half_chunk",
                        reason="resource_exhausted") == 1
    assert [(s["site"], s["to"]) for s in tdg.recent_steps()] == [
        (SITE, "half_chunk")]
    for name, a in got.items():
        np.testing.assert_array_equal(a, clean[name], name)


@pytest.mark.parametrize("spill,cap", [(False, 0.5), (True, 0.5)])
def test_dropped_rows_are_counted(spill, cap):
    """A list cap below the largest list drops rows from the pack; the
    build counts them in ``ivf_pq.build.dropped{site=...}``, and they are
    the rows the lists do not hold."""
    x = _data(spill)
    kw = {**_kw(spill), "list_size_cap_factor": cap}
    got = tpq.build_chunked(x, tpq.IndexParams(**kw), chunk_rows=CHUNK,
                            device="cpu")
    dropped = tspans.total("ivf_pq.build.dropped", site=SITE)
    assert dropped > 0
    assert dropped == len(x) - int(got.list_sizes.sum())


def test_folded_jax_file_loads_and_searches(root, tmp_path):
    """A file the JAX package saved with lane-folded codes loads in the
    port as the [n_lists, L, nb] view and searches as the JAX index does;
    ``from_numpy`` takes the folded arrays too."""
    import dataclasses as dc

    from torch_parity import jax_index_arrays, jax_index_from_arrays

    arrays = _jax_reference(False, root)["arrays"]
    jidx = jax_index_from_arrays(arrays, {
        "metric": "sqeuclidean", "codebook_kind": "per_subspace",
        "pq_bits": 8, "pq_dim": 8})
    n_lists, L, nb = arrays["packed_codes"].shape
    assert (L * nb) % 128 == 0
    folded = dc.replace(jidx, packed_codes=jidx.packed_codes.reshape(
        n_lists, -1, 128), codes_folded=True)
    jpq.save(folded, str(tmp_path / "folded.idx"))
    q = np.random.default_rng(5).random((40, 24), dtype=np.float32)
    jd, ji = jpq.search(folded, jnp.asarray(q), 10, jpq.SearchParams(
        n_probes=4, scan_mode="per_query", lut_dtype="float32"))
    tsp = tpq.SearchParams(n_probes=4, scan_mode="per_query",
                           lut_dtype="float32")
    f_arrays, meta = jax_index_arrays(folded)
    assert f_arrays["packed_codes"].shape == (n_lists, L * nb // 128, 128)
    for tidx in (tpq.load(str(tmp_path / "folded.idx"), device="cpu"),
                 tpq.from_numpy(f_arrays, meta, device="cpu")):
        assert tuple(tidx.packed_codes.shape) == (n_lists, L, nb)
        np.testing.assert_array_equal(tidx.packed_codes.numpy(),
                                      arrays["packed_codes"])
        td, ti = tpq.search(tidx, q, 10, tsp, device="cpu")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("shape", [(16, 7, 128), (16, 64, 17), (16, 64)])
def test_unfold_refuses_other_shapes(shape):
    """Only [n_lists, L, nb] and its lane fold [n_lists, L·nb/128, 128]
    are code tables: any other shape raises."""
    with pytest.raises(LogicError, match="neither"):
        tpq._unfold_codes(np.zeros(shape, np.uint8), 64, 16, 8)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_streamed_groundtruth_equals_brute_force(metric):
    """``compute_groundtruth`` over a base past its device budget (an
    array, then a provider) streams in blocks and equals
    ``brute_force.knn`` over the whole base; ``max_queries`` cuts the
    queries; under the budget it is the one search. The JAX package's
    streamed ground truth names the same rows."""
    from raft_tpu.bench import dataset as jds

    prov = tds.DeviceSyntheticChunks(5000, 16, n_centers=50, seed=9,
                                     chunk_rows=700, device="cpu")
    base = prov[0:5000].numpy()
    q = prov.queries(60).numpy()
    _, want = tbf.knn_arrays(base, q[:50], 10, metric=metric, device="cpu")
    for src in (base, prov):
        ds = tds.Dataset("s", src, q, metric=metric)
        tds.compute_groundtruth(ds, k=10, device_budget=1 << 12,
                                chunk_rows=700, max_queries=50,
                                device="cpu")
        np.testing.assert_array_equal(ds.groundtruth, want.numpy())
    whole = tds.compute_groundtruth(tds.Dataset("s", base, q, metric=metric),
                                    k=10, max_queries=50, device="cpu")
    np.testing.assert_array_equal(whole.groundtruth, want.numpy())
    jg = jds.compute_groundtruth(jds.Dataset("s", base, q, metric=metric),
                                 k=10, device_budget=1 << 12, chunk_rows=700,
                                 max_queries=50).groundtruth
    np.testing.assert_array_equal(np.sort(jg, 1), np.sort(want.numpy(), 1))


def test_cancellation_tokens():
    """``cancel`` marks a thread (by object or ident; an exited thread is
    a no-op); its next ``cancellation_point`` or ``synchronize`` raises
    once and clears the token, as the JAX package's does."""
    from raft_tpu.core import interruptible as jint

    for mod in (tint, jint):
        mod.cancellation_point()
        mod.cancel()
        with pytest.raises(mod.interrupted_exception):
            mod.cancellation_point()
        mod.cancellation_point()  # the token was cleared
        seen = []

        def worker():
            ev.wait()
            try:
                mod.cancellation_point()
            except mod.interrupted_exception:
                seen.append("raised")

        ev = threading.Event()
        t = threading.Thread(target=worker)
        t.start()
        mod.cancel(t.ident)
        ev.set()
        t.join()
        assert seen == ["raised"]
        mod.cancel(t.ident)  # exited: nothing happens here
        mod.cancellation_point()
    tint.cancel()
    with pytest.raises(tint.interrupted_exception):
        tint.synchronize(torch.ones(3))
    tint.synchronize(torch.ones(3))


def test_cancel_stops_a_build_at_a_chunk_seam(tmp_path):
    """A cancelled thread's build stops at its next chunk seam with
    ``interrupted_exception``, its checkpoint resumable to the clean
    index."""
    x = _data(False)
    p = tpq.IndexParams(**_kw(False))
    tint.cancel()
    with pytest.raises(tint.interrupted_exception):
        tpq.build_chunked(x, p, chunk_rows=CHUNK,
                          checkpoint_dir=str(tmp_path), device="cpu")
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["phase"] == "label"
    got = tpq.build_chunked(x, p, chunk_rows=CHUNK,
                            checkpoint_dir=str(tmp_path), resume=True,
                            device="cpu")
    clean = tpq.build_chunked(x, p, chunk_rows=CHUNK, device="cpu")
    for name, a in _arrays(got).items():
        np.testing.assert_array_equal(a, _arrays(clean)[name], name)


def test_sharded_from_numpy_unfolds_lane_folded_shards():
    """The sharded index's ``from_numpy`` takes each rank's lane-folded
    codes as the same [n_lists, L, nb] view."""
    from raft_tpu_torch.parallel import ivf as tivf
    from raft_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(0)
    n_dev, n_lists, L, S = 2, 4, 64, 4
    codes = rng.integers(0, 16, (n_dev, n_lists, L, S * 2)).astype(np.uint8)
    packed = tpq.pack_bits(torch.tensor(codes), 4).numpy()      # nb = S
    arrays = dict(
        centers=rng.random((n_lists, 8), dtype=np.float32),
        centers_rot=rng.random((n_lists, 8), dtype=np.float32),
        rotation=np.eye(8, dtype=np.float32),
        codebooks=rng.random((8, 16, 1), dtype=np.float32),
        packed_ids=np.arange(n_dev * n_lists * L, dtype=np.int32).reshape(
            n_dev, n_lists, L),
        packed_norms=rng.random((n_dev, n_lists, L), dtype=np.float32),
        list_sizes=np.full((n_dev, n_lists), L, np.int32))
    meta = {"metric": "sqeuclidean", "pq_bits": 4, "pq_dim": 8}
    mesh = make_mesh(n_dev, device="cpu")
    folded = tivf.from_numpy(dict(arrays, packed_codes=packed.reshape(
        n_dev, n_lists, L * S // 128, 128)), meta, mesh)
    for r in range(n_dev):
        np.testing.assert_array_equal(folded.packed_codes[r].numpy(),
                                      packed[r])
