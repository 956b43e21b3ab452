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

:func:`set_policy` maps the JAX package's precision strings (a handle's
``precision``, ``core.resources``) onto the two switches: "highest" is
:func:`enforce`; "high" and "default" let products use TF32, the card's
counterpart of the TPU's reduced-pass bf16 products.
"""

from __future__ import annotations

import torch


PRECISIONS = ("default", "high", "highest")


def set_policy(precision: str) -> None:
    """Set the switches for one of :data:`PRECISIONS`."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def enforce() -> None:
    """Set fp32 matmuls with TF32 off (both switches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
