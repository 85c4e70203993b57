"""Corpora and queries made from the seed, on the device.

The latent generator is the one the port's smoke test uses
(`make_data` / `make_gist`): rows are a draw of `latent` standard normals
through a fixed random basis of shape [latent, dim] (scaled by
1/sqrt(latent)), plus `noise` times a standard normal in every
dimension. Each stream (basis, rows, queries) has a `torch.Generator` of
its own, seeded from the run's seed and the stream's number, so one seed
gives the same arrays on the same device. Rows are drawn in blocks of
ROW_BLOCK, so the first n rows of a longer draw are the n rows of a
shorter one: an ingest pool starts with the configuration's corpus, and
rows past it are fresh draws of the same generator.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

ROW_BLOCK = 1 << 18
BASIS, ROWS, QUERIES = 0, 1, 2
_SEED_MOD = 1 << 63


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(seed) * 1_000_003 + stream) % _SEED_MOD)
    return g


class LatentData:
    """One configuration's data under one seed."""

    def __init__(self, spec: dict, seed: int, device):
        self.dim = int(spec["dim"])
        self.latent = int(spec["latent"])
        self.noise = float(spec["noise"])
        self.seed = int(seed)
        self.device = torch.device(device)
        g = generator(seed, BASIS, self.device)
        self.basis = (torch.randn(self.latent, self.dim, generator=g,
                                  device=self.device)
                      / float(np.sqrt(self.latent)))

    def _draw(self, g: torch.Generator, n: int) -> torch.Tensor:
        z = torch.randn(n, self.latent, generator=g, device=self.device)
        e = torch.randn(n, self.dim, generator=g, device=self.device)
        return torch.addmm(e.mul_(self.noise), z, self.basis)

    def rows(self, n: int) -> np.ndarray:
        """The first `n` corpus rows, float32 [n, dim], on the host."""
        g = generator(self.seed, ROWS, self.device)
        out = np.empty((n, self.dim), np.float32)
        with _full_float32():
            for lo in range(0, n, ROW_BLOCK):
                block = self._draw(g, ROW_BLOCK)
                hi = min(n, lo + ROW_BLOCK)
                out[lo:hi] = block[: hi - lo].cpu().numpy()
        return out

    def queries(self, q: int) -> np.ndarray:
        """`q` queries, float32 [q, dim], on the host."""
        g = generator(self.seed, QUERIES, self.device)
        with _full_float32():
            return self._draw(g, q).cpu().numpy()


@contextlib.contextmanager
def _full_float32():
    """Float32 matrix products without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
