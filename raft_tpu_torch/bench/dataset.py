"""Synthetic clustered data made on the device (the shape of
``raft_tpu.bench.dataset.DeviceSyntheticChunks``): ``n_centers`` centers
uniform in [0, scale)^dim, each row a random center plus N(0, std²)
noise. Same distribution as the JAX package's generator, not the same
numbers (torch and JAX generators differ)."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.device import resolve_device


class DeviceSynthetic:
    """Base rows and queries from one seed, generated on ``device`` in
    row chunks; queries come from their own generator stream."""

    def __init__(self, n: int, dim: int, n_centers: int = 10_000,
                 seed: int = 7, std: float = 0.5, scale: float = 10.0,
                 device="cuda", chunk_rows: int = 1 << 22):
        self.shape = (n, dim)
        self.device = resolve_device(device)
        self.seed = seed
        self.std = std
        self.chunk_rows = chunk_rows
        g = self._gen(0)
        self.centers = torch.rand((n_centers, dim), generator=g,
                                  device=self.device) * scale

    def _gen(self, stream: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed * 1_000_003 + stream)
        return g

    def _sample(self, m: int, g: torch.Generator) -> torch.Tensor:
        n_c, dim = self.centers.shape
        assign = torch.randint(0, n_c, (m,), generator=g, device=self.device)
        noise = torch.randn((m, dim), generator=g, device=self.device)
        return self.centers[assign] + self.std * noise

    def base(self) -> torch.Tensor:
        """All n rows, [n, dim] f32 on the device."""
        n, dim = self.shape
        out = torch.empty((n, dim), dtype=torch.float32, device=self.device)
        g = self._gen(1)
        for a in range(0, n, self.chunk_rows):
            b = min(n, a + self.chunk_rows)
            out[a:b] = self._sample(b - a, g)
        return out

    def queries(self, m: int) -> torch.Tensor:
        return self._sample(m, self._gen(2))
