"""Serving: so far only :mod:`~raft_tpu_torch.serve.placement`, the record
of where an index's pieces live, which the degradation ladder's
``demote_raw`` rung moves through. The rest of ``raft_tpu.serve`` — the
server, registry, dispatch, SLO and load generator — is ROADMAP A14.
"""

from raft_tpu_torch.serve import placement  # noqa: F401
