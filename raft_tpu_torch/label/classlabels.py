"""Label utilities — unique labels, monotonic relabeling, label merging,
connected-component labeling (counterpart of
``raft_tpu.label.classlabels``; reference: label/classlabels.cuh
getUniquelabels/make_monotonic, label/merge_labels.cuh).

Propagation is min-label pointer jumping, as in the JAX package: rounds
of tensor code on the labels' device, driven by a host loop with an early
exit. Each round compares the new labels with the last on the device and
reads back one bool: one host sync a round, as the JAX package's
``device_get`` of each round. Labels are int32.

A host array (numpy, a list) stands for labels on the CPU; tensors stay
on their device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.sparse.types import CSR, csr_to_coo

_INT32_MAX = int(np.iinfo(np.int32).max)


def _tensor(labels, dtype=None) -> torch.Tensor:
    t = labels if isinstance(labels, torch.Tensor) \
        else torch.as_tensor(np.asarray(labels))
    if t.dtype == torch.int64:  # the JAX package's int32 (x64 off)
        t = t.to(torch.int32)
    return t if dtype is None else t.to(dtype)


def unique_labels(labels) -> torch.Tensor:
    """Sorted unique labels — reference: label/classlabels.cuh
    getUniquelabels."""
    return torch.unique(_tensor(labels), sorted=True)


def make_monotonic(labels, ignore: int | None = None
                   ) -> Tuple[torch.Tensor, int]:
    """Relabel arbitrary int labels to a dense 0..k-1 range
    (reference: label/classlabels.cuh make_monotonic). ``ignore`` (e.g.
    a noise marker) is preserved as-is and not counted. Returns
    (new_labels, n_classes); numpy's ``unique`` on the host, as in the
    JAX package."""
    t = _tensor(labels)
    lab = t.cpu().numpy()
    mask = np.ones(lab.shape, dtype=bool) if ignore is None \
        else lab != ignore
    uniq, inv = np.unique(lab[mask], return_inverse=True)
    out = lab.copy()
    out[mask] = inv
    return torch.from_numpy(out).to(t.device), int(uniq.size)


def _merge_round(labels: torch.Tensor, rows: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """One min-label propagation round over the edge list: each vertex
    takes the least label among itself and its neighbours
    (``segment_min``: rows outside [0, n) dropped, a vertex with no edge
    keeps its label), then one pointer jump through the label graph."""
    n = labels.shape[0]
    idx = torch.where((rows >= 0) & (rows < n), rows, n)
    neigh = torch.full((n + 1,), _INT32_MAX, dtype=labels.dtype,
                       device=labels.device)
    # jnp's gather wraps a negative id and clamps the rest
    neigh.scatter_reduce_(0, idx, labels[cols.clamp(-n, n - 1)], "amin")
    cand = torch.minimum(labels, neigh[:n])
    return torch.minimum(cand, cand[cand.long()])


def _propagate(lab: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
               max_rounds: int = 64, stats: Optional[dict] = None
               ) -> torch.Tensor:
    """Min-label propagation to a fixpoint, at most ``max_rounds`` rounds;
    ``stats["rounds"]`` gets the rounds run."""
    rows, cols = rows.long(), cols.long()
    prev = None
    rounds = 0
    for _ in range(max_rounds):
        lab = _merge_round(lab, rows, cols)
        rounds += 1
        if prev is not None and torch.equal(lab, prev):
            break
        prev = lab
    if stats is not None:
        stats["rounds"] = rounds
    return lab


def merge_labels(labels_a, labels_b) -> torch.Tensor:
    """Union two labelings: vertices sharing a label in either input end
    up in one merged class (reference: label/merge_labels.cuh, used when
    batched connected-components halves meet). Labels must be in
    0..n-1 vertex-id space (e.g. "root vertex id")."""
    a = _tensor(labels_a, torch.int32)
    b = _tensor(labels_b, torch.int32).to(a.device)
    n = a.shape[0]
    verts = torch.arange(n, dtype=torch.int32, device=a.device)
    # bipartite-ish union: edges vertex→its label representative in both
    rows = torch.cat([verts, a, verts, b])
    cols = torch.cat([a, verts, b, verts])
    return _propagate(torch.minimum(a, b), rows, cols)


def connected_components(adj: CSR, stats: Optional[dict] = None
                         ) -> Tuple[torch.Tensor, int]:
    """Weakly-connected components of a symmetric adjacency: labels are
    the min vertex id of each component, then made monotonic. Returns
    (labels [n] in 0..k-1, k); ``stats["rounds"]`` gets the propagation
    rounds."""
    coo = csr_to_coo(adj)
    n = adj.shape[0]
    rows = torch.cat([coo.rows, coo.cols])
    cols = torch.cat([coo.cols, coo.rows])
    lab = _propagate(torch.arange(n, dtype=torch.int32,
                                  device=adj.indptr.device), rows, cols,
                     stats=stats)
    return make_monotonic(lab)
