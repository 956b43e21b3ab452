"""Chunked, resumable distributed builds (counterpart of
``raft_tpu.parallel.build``): not ported yet (ROADMAP A15). Each entry
point raises ``NotImplementedError``; ``parallel.ivf.build_ivf_pq`` is
the ported distributed build."""

from __future__ import annotations

from raft_tpu_torch.core.errors import not_ported


def build_ivf_pq_distributed(*args, **kwargs):
    raise not_ported("parallel.build.build_ivf_pq_distributed", "A15")


def build_ivf_flat_distributed(*args, **kwargs):
    raise not_ported("parallel.build.build_ivf_flat_distributed", "A15")


def assemble_ivf_pq(*args, **kwargs):
    raise not_ported("parallel.build.assemble_ivf_pq", "A15")


def assemble_ivf_flat(*args, **kwargs):
    raise not_ported("parallel.build.assemble_ivf_flat", "A15")
