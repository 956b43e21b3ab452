"""raft_tpu_torch — the PyTorch + CUDA port of raft_tpu for NVIDIA Hopper.

Mirrors ``raft_tpu``'s subpackage and function names so each counterpart
is found by name. Plain tensor code is PyTorch; every TPU kernel on the
ported path is a hand-written CUDA kernel for ``sm_90a``
(:mod:`raft_tpu_torch.ops`), built with ``nvcc`` at first use and loaded
with ``ctypes``. Entry points (``build``, ``search``, ``refine``,
``knn``) take ``device=`` and default to ``"cuda"``; they raise when no
card is present unless the caller asks for ``device="cpu"``, where each
kernel wrapper runs its plain PyTorch version.

This package imports ``torch`` and numpy only — never ``jax`` and never
``raft_tpu``.
"""

__version__ = "0.1.0"
