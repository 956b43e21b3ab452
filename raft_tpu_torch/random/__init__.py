"""raft_tpu_torch.random — ``jax.random``'s threefry generator, the RNG
state and its distributions, and the data generators (counterpart of
``raft_tpu.random``)."""

from raft_tpu_torch.random.rng import (  # noqa: F401
    RngState,
    bernoulli,
    cauchy,
    exponential,
    gumbel,
    laplace,
    lognormal,
    normal,
    rayleigh,
    uniform,
    uniform_int,
)
from raft_tpu_torch.random.generators import (  # noqa: F401
    make_blobs,
    make_regression,
    multi_variable_gaussian,
    permute,
    rmat_rectangular,
    sample_without_replacement,
    subsample,
)
