"""Device resolution for the port's entry points.

Entry points take ``device=`` defaulting to ``"cuda"``. Without a card
that default raises: the port never carries on silently on the CPU. The
CPU runs only when the caller asks for it (``device="cpu"``), and then
every kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """numpy array or tensor → contiguous tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()
