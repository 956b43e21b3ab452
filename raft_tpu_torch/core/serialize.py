"""Serialization — ``.npy`` array records and a typed header, the index
file format of ``raft_tpu.core.serialize`` (a jax-free copy: files
written by either package load in the other).

A file is ``MAGIC``, the kind, the version and JSON metadata as tagged
little-endian scalars, then a count and that many (name, ``.npy`` record)
pairs. bfloat16 arrays, which numpy has no dtype for, are records of
descr ``'<V2'`` (what ``np.save`` writes for the JAX package's bf16):
their 2-byte words are the bf16 bits, read back as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import struct
from typing import Any, BinaryIO, Dict

import numpy as np
import torch

MAGIC = b"RAFTTPU\x00"

# Row blocks of at most this many bytes go from the card to the file at a
# time, so a multi-GB index never needs a second host copy.
_BLOCK_BYTES = 256 << 20

_BF16_DESCR = "<V2"


def serialize_scalar(f: BinaryIO, value) -> None:
    """Write one little-endian scalar (bool/int64/float64/str) with a type
    tag."""
    if isinstance(value, (bool, np.bool_)):
        f.write(b"b" + struct.pack("<?", bool(value)))
    elif isinstance(value, (int, np.integer)):
        f.write(b"i" + struct.pack("<q", int(value)))
    elif isinstance(value, (float, np.floating)):
        f.write(b"f" + struct.pack("<d", float(value)))
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        f.write(b"s" + struct.pack("<q", len(raw)) + raw)
    else:
        raise TypeError(f"unsupported scalar type: {type(value)}")


def deserialize_scalar(f: BinaryIO):
    tag = f.read(1)
    if tag == b"b":
        return struct.unpack("<?", f.read(1))[0]
    if tag == b"i":
        return struct.unpack("<q", f.read(8))[0]
    if tag == b"f":
        return struct.unpack("<d", f.read(8))[0]
    if tag == b"s":
        (n,) = struct.unpack("<q", f.read(8))
        return f.read(n).decode("utf-8")
    raise ValueError(f"bad scalar tag: {tag!r}")


def _host_block(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def serialize_array(f: BinaryIO, arr) -> None:
    """Write one array (tensor or numpy) as a ``.npy`` record, tensors in
    row blocks of at most 256 MB."""
    if not isinstance(arr, torch.Tensor):
        np.save(f, np.asarray(arr), allow_pickle=False)
        return
    t = arr.contiguous()
    descr = (_BF16_DESCR if t.dtype == torch.bfloat16 else
             np.lib.format.dtype_to_descr(_host_block(t.reshape(-1)[:0]).dtype))
    np.lib.format.write_array_header_1_0(f, {
        "descr": descr, "fortran_order": False, "shape": tuple(t.shape)})
    if t.dim() == 0:
        f.write(_host_block(t).tobytes())
        return
    row = max(1, t[:1].numel() * t.element_size())
    rows = max(1, _BLOCK_BYTES // row)
    for a in range(0, t.shape[0], rows):
        f.write(np.ascontiguousarray(_host_block(t[a:a + rows])).tobytes())


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A loaded record → a contiguous tensor on ``device``; 2-byte void
    records are bfloat16."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device).contiguous()


def serialize_header(f: BinaryIO, kind: str, version: int,
                     meta: Dict[str, Any]) -> None:
    """Write the container header: magic, kind, version, JSON metadata."""
    f.write(MAGIC)
    serialize_scalar(f, kind)
    serialize_scalar(f, version)
    serialize_scalar(f, json.dumps(meta, sort_keys=True))


def deserialize_header(f: BinaryIO, expected_kind: str):
    magic = f.read(len(MAGIC))
    if magic != MAGIC:
        raise ValueError("not a raft_tpu serialized file (bad magic)")
    kind = deserialize_scalar(f)
    if kind != expected_kind:
        raise ValueError(f"expected {expected_kind!r} file, got {kind!r}")
    version = deserialize_scalar(f)
    meta = json.loads(deserialize_scalar(f))
    return version, meta


def save_arrays(path: str, kind: str, version: int, meta: Dict[str, Any],
                arrays: Dict[str, Any]) -> None:
    """Save a named-array container (one file per index)."""
    with open(path, "wb") as f:
        serialize_header(f, kind, version, meta)
        serialize_scalar(f, len(arrays))
        for name, arr in arrays.items():
            serialize_scalar(f, name)
            serialize_array(f, arr)


def load_arrays(path: str, kind: str):
    """Load a named-array container → (version, meta, {name: np.ndarray})."""
    with open(path, "rb") as f:
        version, meta = deserialize_header(f, kind)
        n = deserialize_scalar(f)
        arrays = {}
        for _ in range(n):
            name = deserialize_scalar(f)
            arrays[name] = np.load(f, allow_pickle=False)
    return version, meta, arrays
