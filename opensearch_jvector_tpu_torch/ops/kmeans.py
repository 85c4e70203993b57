"""k-means++ / Lloyd clustering — the PQ codebook trainer.

Port of `opensearch_jvector_tpu/ops/kmeans.py`: plain k-means and the
anisotropic (score-aware) variant. Subspaces are a leading batch dimension
[M, n, dsub] instead of a `vmap`. Random numbers come from a
`torch.Generator`, so seeds do not reproduce the reference's `jax.random`
bits: trained codebooks are compared by reconstruction error, not equality.

UNWEIGHTED == plain arithmetic-mean centroid update (no point weights).

Anisotropic clustering is ScaNN's loss (Guo et al. 2020): quantization
error PARALLEL to the data point hurts inner-product ranking more than the
orthogonal error, so the loss weights it by eta > 1:
  loss(c; x) = ||c - x||^2 + (eta - 1) * ((c - x) . v)^2,   v = x/||x||
Assignment uses this loss; the centroid update solves the per-cluster
normal equations  [N I + (eta-1) S] c = sum x + (eta-1) sum v (v.x),
S = sum v v^T  (dsub x dsub, one batched solve).
"""

from __future__ import annotations

import numpy as np
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


def aniso_weight(eta: float) -> float:
    """eta - 1 rounded as the reference computes it, in float32."""
    return float(np.float32(eta) - np.float32(1.0))


def _unit_directions(x: torch.Tensor):
    """(||x|| [..., n], x / ||x|| [..., n, d]) with zero rows left zero."""
    nrm = torch.sqrt(torch.sum(x * x, -1))
    return nrm, x / nrm.clamp(min=1e-30).unsqueeze(-1)


def aniso_assign_scores(x: torch.Tensor, centroids: torch.Tensor,
                        eta: float) -> torch.Tensor:
    """Anisotropic assignment cost (lower = better): [n, d] x [k, d] ->
    [n, k], leading subspace dimensions batched."""
    d2 = pairwise_sqdist(x, centroids)
    nrm, v = _unit_directions(x)
    par = v @ centroids.transpose(-1, -2) - nrm.unsqueeze(-1)  # (c - x) . v
    return d2 + aniso_weight(eta) * par * par


def _lloyd_iter_aniso(x: torch.Tensor, centroids: torch.Tensor,
                      eta: float) -> torch.Tensor:
    """One anisotropic Lloyd step per subspace (weighted assignment, then
    the exact weighted-least-squares update): [M, n, d], [M, k, d] ->
    [M, k, d]. The per-cluster sums are scatter-adds over the assignment,
    the scatter matrices over the rows' [d, d] outer products. An empty
    cluster solves the identity system, which keeps its centroid."""
    msub, n, d = x.shape
    k = centroids.shape[1]
    w = aniso_weight(eta)
    x = x.float()
    assign = torch.argmin(aniso_assign_scores(x, centroids, eta), dim=2)
    nrm, v = _unit_directions(x)

    def cluster_sum(rows: torch.Tensor) -> torch.Tensor:  # [M, n, c]
        out = torch.zeros((msub, k, rows.shape[2]), dtype=torch.float32,
                          device=x.device)
        return out.scatter_add_(
            1, assign.unsqueeze(-1).expand(-1, -1, rows.shape[2]), rows)

    counts = cluster_sum(torch.ones((msub, n, 1), device=x.device))[..., 0]
    sum_x = cluster_sum(x)
    # sum_i v_i (v_i . x_i) = sum_i v_i ||x_i||
    sum_vn = cluster_sum(v * nrm.unsqueeze(-1))
    s = cluster_sum((v.unsqueeze(-1) * v.unsqueeze(-2)).reshape(
        msub, n, d * d)).reshape(msub, k, d, d)
    eye = torch.eye(d, dtype=torch.float32, device=x.device)
    filled = counts > 0
    lhs = torch.where(filled[..., None, None],
                      counts[..., None, None] * eye + w * s, eye)
    rhs = torch.where(filled[..., None], sum_x + w * sum_vn,
                      centroids.float())
    new = torch.linalg.solve(lhs, rhs.unsqueeze(-1))[..., 0]
    return new.to(centroids.dtype)


def lloyd_iters(x_sub: torch.Tensor, centroids: torch.Tensor,
                iters: int, eta: float | None = None) -> torch.Tensor:
    """`iters` Lloyd steps over [M, n, dsub] from `centroids` [M, k, dsub]
    (anisotropic steps with `eta`), a few subspaces at a time so the
    distance slab, and the anisotropic step's outer products, stay
    bounded."""
    msub, n, dsub = x_sub.shape
    per_sub = n * centroids.shape[1] * 4
    if eta is not None:
        per_sub = max(per_sub, n * dsub * dsub * 4)
    step = max(1, LLOYD_SLAB_BYTES // max(1, per_sub))
    for _ in range(iters):
        centroids = torch.cat([
            _lloyd_iter(x_sub[s: s + step], centroids[s: s + step])
            if eta is None else
            _lloyd_iter_aniso(x_sub[s: s + step], centroids[s: s + step], eta)
            for s in range(0, msub, step)
        ])
    return centroids


def train_kmeans(
    x: torch.Tensor, k: int, iters: int = 8,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Train k centroids over x [n, d] -> [k, d] (k-means++ seeding, then
    Lloyd): one subspace of `train_kmeans_subspaces`."""
    return train_kmeans_subspaces(x.unsqueeze(0), k, iters, generator)[0]


def train_kmeans_subspaces(
    x_sub: torch.Tensor, k: int, iters: int = 8,
    gen: torch.Generator | None = None,
) -> torch.Tensor:
    """Per-subspace codebook training: [M, n, dsub] -> [M, k, dsub]."""
    if gen is None:
        gen = torch.Generator(device=x_sub.device).manual_seed(0)
    return lloyd_iters(x_sub, _kmeanspp_init(x_sub, k, gen), iters)


def train_kmeans_subspaces_aniso(
    x_sub: torch.Tensor, k: int, eta: float, iters: int = 8,
    gen: torch.Generator | None = None,
) -> torch.Tensor:
    """Anisotropic per-subspace training: [M, n, dsub] -> [M, k, dsub].

    Seeds with plain k-means++ (the loss difference only matters once
    clusters form), then runs anisotropic Lloyd iterations."""
    if gen is None:
        gen = torch.Generator(device=x_sub.device).manual_seed(0)
    return lloyd_iters(x_sub, _kmeanspp_init(x_sub, k, gen), iters, eta)
