"""Nearest-neighbour search: brute force, IVF-Flat, IVF-PQ, CAGRA, refine
and sample filtering (the JAX package's ``raft_tpu.neighbors`` names;
NN-Descent, ball cover and ε-neighbourhood are not ported yet, ROADMAP
A16)."""

from raft_tpu_torch.neighbors import (  # noqa: F401
    brute_force,
    cagra,
    ivf_flat,
    ivf_pq,
    refine,
    sample_filter,
)
