"""Durable build checkpoints — the resumable-build substrate (a numpy-only
counterpart of ``raft_tpu.robust.checkpoint``: the same manifest schema,
file names and fingerprints, so a checkpoint written by one package is
read by the other).

A chunked build without resume restarts from vector 0 on any preemption.
This module gives ``ivf_pq.build_chunked(checkpoint_dir=...)`` (ROADMAP
A9, next) the storage half of resumability:

- a **manifest** (``manifest.json``) recording the build's identity
  (dataset fingerprint + params fingerprint), its phase
  (``train → label → encode → done``), the fitted list capacity, and
  the count of completed encode chunks — rewritten atomically
  (tmp + fsync + rename, the flight-dump discipline) after every state
  change, so a SIGKILL between writes can never expose a torn manifest;
- **array checkpoints** (``.npz``: the kmeans/quantizer state, the
  label pass) and per-chunk **encoded-list shards**
  (``shard_%06d.npz``: packed codes + norms for that chunk's rows),
  written with the same tmp+fsync+rename discipline;
- **validation**: :meth:`BuildCheckpoint.validate_manifest` refuses to
  resume on a wrong dataset fingerprint, wrong build params, truncated
  manifest JSON, or a missing shard — each with a clear
  :func:`~raft_tpu.core.errors.expects` error instead of a silent
  partial index.

Resume correctness is deterministic replay: quantizers and labels are
*loaded* (not recomputed), completed chunks re-pack from their shards,
and remaining chunks re-encode with the loaded quantizers — so an
interrupted-then-resumed build is bit-identical to an uninterrupted
one.

The DISTRIBUTED build (``parallel.build``) reuses the same directory
with a **shard axis**: its manifest carries ``n_shards`` /
``shard_rows`` / ``L_shard`` and a per-shard ``shard_chunks_done``
list, encoded-chunk files carry the data-shard rank in their name
(:meth:`BuildCheckpoint.shard_name` with ``shard=``), per-shard label
passes land as ``labels_s%03d.npz``, and the dataset fingerprint is
computed ONCE per build with its elapsed seconds stamped into the
manifest (``fingerprint_s``) — a preempted pod build resumes each
shard from its own last complete chunk.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np

from raft_tpu_torch.core.errors import expects, fail

SCHEMA = "raft_tpu.build_ckpt/1"
MANIFEST = "manifest.json"

# Fingerprint byte budget: head+tail samples bound hashing cost on a
# 100M-row memmap while still catching "same shape, different file".
_FP_BYTES = 1 << 20


def _fsync_write(path: str, data: bytes) -> None:
    """tmp + write + flush + fsync + rename: the dump path never exposes
    a partial file, even across power loss (rename is atomic; fsync
    orders the data before it)."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt_tmp_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:  # persist the rename itself (directory entry)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # not all filesystems allow directory fsync


def _host(x) -> np.ndarray:
    """A slice of a dataset as numpy: tensors (on any device) come to the
    host; numpy arrays and memmaps pass through."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _np_dtype(dtype):
    """A torch dtype as the numpy dtype of the same name, so a tensor's
    fingerprint equals that of the same rows as an array."""
    name = str(dtype)
    if name.startswith("torch."):
        try:
            return np.dtype(name[len("torch."):])
        except TypeError:
            return dtype
    return dtype


def dataset_fingerprint(dataset) -> str:
    """sha256 identity of the build input: shape + dtype + head/tail
    CONTENT samples, uniformly for numpy arrays/memmaps, device arrays,
    and device-chunk providers — a provider's rows are a deterministic
    function of its seed/config, so sampling its first/last blocks
    (regenerated on demand, seconds at worst) catches a same-shape
    different-seed swap that attribute inspection cannot. Slice bounds
    stay non-negative (providers reject negative starts). Anything
    unsliceable falls back to type name + simple-typed attributes."""
    h = hashlib.sha256()
    shape = tuple(getattr(dataset, "shape", ()))
    h.update(repr(shape).encode())
    h.update(repr(_np_dtype(getattr(dataset, "dtype",
                                    type(dataset).__name__))).encode())
    sampled = False
    if len(shape) >= 1 and shape[0]:
        n = shape[0]
        try:
            head = _host(dataset[0:1])
            rows = max(1, min(n, _FP_BYTES // max(1, head.nbytes)))
            h.update(np.ascontiguousarray(
                _host(dataset[0:rows])).tobytes())
            if n > rows:
                h.update(np.ascontiguousarray(
                    _host(dataset[n - rows:n])).tobytes())
            sampled = True
        except Exception:
            sampled = False
    if not sampled:
        h.update(type(dataset).__name__.encode())
        for name in sorted(vars(dataset) if hasattr(dataset, "__dict__")
                           else ()):
            value = getattr(dataset, name)
            if isinstance(value, (bool, int, float, str, tuple)):
                h.update(f"{name}={value!r};".encode())
    return h.hexdigest()


def params_fingerprint(params_dict: Dict[str, Any]) -> str:
    """sha256 over the canonical-JSON build configuration (IndexParams
    fields + chunk_rows + max_train_rows — anything that changes the
    built index)."""
    blob = json.dumps(params_dict, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()


def fingerprints_once(dataset, params_dict: Dict[str, Any]):
    """``(dataset_sha, params_sha, elapsed_s)`` — the ONE fingerprint
    site per build. Both chunked builders call this exactly once and
    thread the pair through every manifest write and (distributed) every
    shard scope; the elapsed seconds land in the manifest as
    ``fingerprint_s``, so an hour-scale memmap build can see what the
    identity check cost instead of silently paying it."""
    import time

    t0 = time.perf_counter()
    ds_sha = dataset_fingerprint(dataset)
    p_sha = params_fingerprint(params_dict)
    return ds_sha, p_sha, time.perf_counter() - t0


class BuildCheckpoint:
    """One checkpoint directory: manifest + named array files + chunk
    shards, all written atomically."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    # -- manifest ----------------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dir, MANIFEST)

    def write_manifest(self, manifest: Dict[str, Any]) -> None:
        manifest = dict(manifest, schema=SCHEMA)
        _fsync_write(self.manifest_path,
                     json.dumps(manifest, sort_keys=True).encode())

    def load_manifest(self) -> Dict[str, Any]:
        expects(os.path.exists(self.manifest_path),
                "resume requested but no build manifest at %s — nothing "
                "to resume", self.manifest_path)
        with open(self.manifest_path, "rb") as f:
            raw = f.read()
        try:
            manifest = json.loads(raw)
        except ValueError:
            fail("resume manifest %s is not valid JSON (truncated or "
                 "corrupt, %d bytes) — refusing to resume; delete the "
                 "checkpoint dir to rebuild from scratch",
                 self.manifest_path, len(raw))
        expects(manifest.get("schema") == SCHEMA,
                "resume manifest %s has schema %r (this build writes %r)",
                self.manifest_path, manifest.get("schema"), SCHEMA)
        return manifest

    def validate_manifest(self, manifest: Dict[str, Any],
                          dataset_sha: str, params_sha: str) -> None:
        """Refuse wrong-input resumes with clear errors (a resumed index
        silently built from half of dataset A and half of dataset B is
        the worst possible outcome)."""
        expects(manifest.get("dataset_sha") == dataset_sha,
                "resume manifest dataset fingerprint %.12s… does not "
                "match this dataset (%.12s…) — the checkpoint under %s "
                "belongs to a different dataset; refusing to resume",
                str(manifest.get("dataset_sha")), dataset_sha, self.dir)
        expects(manifest.get("params_sha") == params_sha,
                "resume manifest build-params fingerprint %.12s… does "
                "not match these params (%.12s…) — the checkpoint under "
                "%s was started with different build parameters; "
                "refusing to resume", str(manifest.get("params_sha")),
                params_sha, self.dir)

    # -- arrays / shards ---------------------------------------------------
    def _npz_path(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.npz")

    def save_arrays(self, name: str, **arrays: np.ndarray) -> None:
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        _fsync_write(self._npz_path(name), buf.getvalue())

    def has_arrays(self, name: str) -> bool:
        return os.path.exists(self._npz_path(name))

    def load_arrays(self, name: str) -> Dict[str, np.ndarray]:
        path = self._npz_path(name)
        expects(os.path.exists(path),
                "resume checkpoint %s is missing %s — the manifest "
                "claims this state was written; refusing to resume a "
                "partial checkpoint", self.dir, os.path.basename(path))
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    def shard_name(self, chunk_idx: int,
                   shard: Optional[int] = None) -> str:
        """Encoded-chunk file stem. ``shard=None`` keeps the single-host
        layout (``shard_000003``); the DISTRIBUTED build passes its
        data-shard rank so the manifest's shard axis has a matching file
        axis (``s002_shard_000003`` = shard 2, chunk 3) and per-shard
        resume can replay one shard without touching the others'."""
        if shard is None:
            return f"shard_{chunk_idx:06d}"
        return f"s{shard:03d}_shard_{chunk_idx:06d}"

    def save_shard(self, chunk_idx: int, shard: Optional[int] = None,
                   **arrays: np.ndarray) -> None:
        self.save_arrays(self.shard_name(chunk_idx, shard), **arrays)

    def load_shard(self, chunk_idx: int,
                   shard: Optional[int] = None) -> Dict[str, np.ndarray]:
        name = self.shard_name(chunk_idx, shard)
        expects(self.has_arrays(name),
                "resume checkpoint %s: encoded-list shard %s.npz is "
                "missing but the manifest records chunk %d as complete "
                "— refusing to resume (no silent partial index)",
                self.dir, name, chunk_idx)
        return self.load_arrays(name)
