"""Hand-written Hopper kernels (``csrc/``), their build (:mod:`.build`)
and their wrappers with plain PyTorch versions (:mod:`.kernels`)."""
