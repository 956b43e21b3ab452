"""Device resolution for the port's entry points.

Entry points take ``device=`` defaulting to ``"cuda"``. Without a card
that default raises: the port never carries on silently on the CPU. The
CPU runs only when the caller asks for it (``device="cpu"``), and then
every kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

# Work-block bounds, bytes: the CPU keeps the JAX package's 192 MB blocks;
# on the card a block takes an eighth of the free memory, at most 4 GB (a
# block's temporaries are a few times its nominal size).
_CPU_BLOCK_BYTES = 192 << 20
_CUDA_BLOCK_BYTES_MAX = 4 << 30


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
        if (x.device == device and (dtype is None or x.dtype == dtype)
                and x.is_contiguous()):
            return x  # no dispatch for the common no-op
        t = x
    else:
        a = np.asarray(x)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def work_block_bytes(dev: torch.device) -> int:
    """Bytes of one work block (a chunk of rows, a tile of queries) of the
    graph and geometric indexes on ``dev``: see ``_CPU_BLOCK_BYTES``."""
    if dev.type != "cuda":
        return _CPU_BLOCK_BYTES
    free, _ = torch.cuda.mem_get_info(dev)
    return max(_CPU_BLOCK_BYTES, min(_CUDA_BLOCK_BYTES_MAX, free // 8))
