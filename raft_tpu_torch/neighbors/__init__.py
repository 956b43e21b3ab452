"""Nearest-neighbour search: brute force, IVF-Flat, IVF-PQ, CAGRA,
NN-Descent, refine, ball cover, ε-neighbourhood and sample filtering
(the JAX package's ``raft_tpu.neighbors`` names)."""

from raft_tpu_torch.neighbors import (  # noqa: F401
    ball_cover,
    brute_force,
    cagra,
    epsilon_neighborhood,
    ivf_flat,
    ivf_pq,
    nn_descent,
    refine,
    sample_filter,
)
