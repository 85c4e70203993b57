"""k-means++ / Lloyd clustering — the PQ codebook trainer.

Port of `opensearch_jvector_tpu/ops/kmeans.py` (plain k-means; the
anisotropic variant waits, ROADMAP queue 1, "Other quantizers"). Subspaces are a leading
batch dimension [M, n, dsub] instead of a `vmap`. Random numbers come from a
`torch.Generator`, so seeds do not reproduce the reference's `jax.random`
bits: trained codebooks are compared by reconstruction error, not equality.

UNWEIGHTED == plain arithmetic-mean centroid update (no point weights).
"""

from __future__ import annotations

import torch

from opensearch_jvector_tpu_torch.ops.distances import pairwise_sqdist

# Bounds the [m_chunk, n, k] distance slab of a Lloyd step (~1 GiB f32).
LLOYD_SLAB_BYTES = 1 << 30


def _kmeanspp_init(x: torch.Tensor, k: int,
                   gen: torch.Generator) -> torch.Tensor:
    """k-means++ seeding per subspace: [M, n, d] -> [M, k, d].

    Each new seed is drawn proportional to the squared distance to the
    nearest seed so far (Gumbel-max on log-distances)."""
    msub, n, d = x.shape
    rows = torch.arange(msub, device=x.device)
    first = torch.randint(0, n, (msub,), generator=gen, device=x.device)
    centroids = torch.zeros((msub, k, d), dtype=x.dtype, device=x.device)
    c = x[rows, first]  # [M, d]
    centroids[:, 0] = c
    mind = pairwise_sqdist(c.unsqueeze(1), x)[:, 0]  # [M, n]
    for i in range(1, k):
        u = torch.rand((msub, n), generator=gen, device=x.device)
        gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
        idx = torch.argmax(torch.log(mind.clamp(min=1e-30)) + gumbel, dim=1)
        c = x[rows, idx]
        centroids[:, i] = c
        mind = torch.minimum(mind, pairwise_sqdist(c.unsqueeze(1), x)[:, 0])
    return centroids


def _lloyd_iter(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """One Lloyd step per subspace: [M, n, d], [M, k, d] -> [M, k, d].

    Assign each point to its nearest centroid, recompute means; empty
    clusters keep their previous centroid."""
    msub, _, d = x.shape
    k = centroids.shape[1]
    assign = torch.argmin(pairwise_sqdist(x, centroids), dim=2)  # [M, n]
    sums = torch.zeros((msub, k, d), dtype=torch.float32, device=x.device)
    sums.scatter_add_(1, assign.unsqueeze(-1).expand(-1, -1, d),
                      x.float())
    counts = torch.zeros((msub, k), dtype=torch.float32, device=x.device)
    counts.scatter_add_(1, assign, torch.ones_like(assign, dtype=torch.float32))
    means = sums / counts.clamp(min=1.0).unsqueeze(-1)
    return torch.where((counts > 0).unsqueeze(-1), means,
                       centroids).to(x.dtype)


def lloyd_iters(x_sub: torch.Tensor, centroids: torch.Tensor,
                iters: int) -> torch.Tensor:
    """`iters` Lloyd steps over [M, n, dsub] from `centroids` [M, k, dsub],
    a few subspaces at a time so the distance slab stays bounded."""
    msub, n, _ = x_sub.shape
    step = max(1, LLOYD_SLAB_BYTES // max(1, n * centroids.shape[1] * 4))
    for _ in range(iters):
        centroids = torch.cat([
            _lloyd_iter(x_sub[s: s + step], centroids[s: s + step])
            for s in range(0, msub, step)
        ])
    return centroids


def train_kmeans_subspaces(
    x_sub: torch.Tensor, k: int, iters: int = 8,
    gen: torch.Generator | None = None,
) -> torch.Tensor:
    """Per-subspace codebook training: [M, n, dsub] -> [M, k, dsub]."""
    if gen is None:
        gen = torch.Generator(device=x_sub.device).manual_seed(0)
    return lloyd_iters(x_sub, _kmeanspp_init(x_sub, k, gen), iters)
