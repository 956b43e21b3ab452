"""Matmul precision policy (counterpart of ``raft_tpu.utils.precision``).

The JAX package computes every distance/Gram contraction at
``Precision.HIGHEST`` (fp32-accurate). The port's counterpart is plain
fp32 with TF32 off, for matrix products AND cuDNN:

- ``torch.backends.cuda.matmul.allow_tf32 = False``
- ``torch.backends.cudnn.allow_tf32 = False``

TF32 keeps ~10 mantissa bits; at IVF distance scales that flips argmins
(the reason the TPU kernels ask for HIGHEST, raft_tpu
``ops/pallas_kernels.py:86-91``). The entry points call
:func:`enforce` so the policy holds whatever the process set before.
"""

from __future__ import annotations

import torch


def enforce() -> None:
    """Set fp32 matmuls with TF32 off (both switches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
