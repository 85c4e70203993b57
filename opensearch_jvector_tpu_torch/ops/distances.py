"""Batched distance / similarity functions on tensors.

Port of `opensearch_jvector_tpu/ops/distances.py`. Every function is a
batched matmul plus rank-1 terms, with the same formulas (and therefore the
same float32 rounding structure) as the reference.

Score conventions follow jVector (scores are "higher is better", bounded):
  EUCLIDEAN:    score = 1 / (1 + ||a-b||^2)
  DOT_PRODUCT:  score = (1 + dot(a, b)) / 2
  COSINE:       score = (1 + cos(a, b)) / 2
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class SimilarityFunction(enum.Enum):
    """Vector similarity functions supported by the graph engine.

    The enum values are stored in segment metadata, so they are the same
    as the reference's ordinals.
    """

    EUCLIDEAN = 0
    DOT_PRODUCT = 1
    COSINE = 2

    @property
    def is_euclidean(self) -> bool:
        return self is SimilarityFunction.EUCLIDEAN


SIMILARITY_ORDINALS = {
    SimilarityFunction.EUCLIDEAN: 0,
    SimilarityFunction.DOT_PRODUCT: 1,
    SimilarityFunction.COSINE: 2,
}
ORDINAL_TO_SIMILARITY = {v: k for k, v in SIMILARITY_ORDINALS.items()}


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + 1e-30)


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances, [m, d] x [n, d] -> [m, n] (clamped at 0).

    Leading batch dimensions broadcast: [B, m, d] x [B, n, d] -> [B, m, n].
    """
    a2 = torch.sum(a * a, -1, keepdim=True)
    b2 = torch.sum(b * b, -1).unsqueeze(-2)
    return torch.clamp(a2 + b2 - 2.0 * (a @ b.transpose(-1, -2)), min=0.0)


def pairwise_scores(
    a: torch.Tensor, b: torch.Tensor, simf: SimilarityFunction
) -> torch.Tensor:
    """Pairwise similarity scores, [m, d] x [n, d] -> [m, n] (higher=better)."""
    if simf is SimilarityFunction.EUCLIDEAN:
        return 1.0 / (1.0 + pairwise_sqdist(a, b))
    if simf is SimilarityFunction.DOT_PRODUCT:
        return (1.0 + a @ b.transpose(-1, -2)) / 2.0
    if simf is SimilarityFunction.COSINE:
        return (1.0 + _normalize(a) @ _normalize(b).transpose(-1, -2)) / 2.0
    raise ValueError(f"unsupported similarity {simf}")


def _qc_dot(queries: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[Q, d] x [Q, C, d] -> [Q, C] as one batched matvec."""
    return torch.bmm(cand, queries.unsqueeze(-1)).squeeze(-1)


def batched_candidate_scores(
    queries: torch.Tensor,  # [Q, d]
    cand_vecs: torch.Tensor,  # [Q, C, d]
    simf: SimilarityFunction,
) -> torch.Tensor:
    """Per-query candidate scoring: [Q, d] x [Q, C, d] -> [Q, C]."""
    if simf is SimilarityFunction.EUCLIDEAN:
        q2 = torch.sum(queries * queries, -1).unsqueeze(1)
        c2 = torch.linalg.vecdot(cand_vecs, cand_vecs)
        d2 = torch.clamp(q2 + c2 - 2.0 * _qc_dot(queries, cand_vecs), min=0.0)
        return 1.0 / (1.0 + d2)
    if simf is SimilarityFunction.DOT_PRODUCT:
        return (1.0 + _qc_dot(queries, cand_vecs)) / 2.0
    if simf is SimilarityFunction.COSINE:
        return (1.0 + _qc_dot(_normalize(queries), _normalize(cand_vecs))) / 2.0
    raise ValueError(f"unsupported similarity {simf}")


def exact_scores(query: torch.Tensor, vectors: torch.Tensor,
                 space: str) -> torch.Tensor:
    """Raw per-space values for exact (script-style) scoring, [n].

    `space` in {"l2", "l1", "linf", "innerproduct", "cosinesimil"}:
      l2 -> 1/(1+l2^2), l1 -> 1/(1+l1), linf -> 1/(1+linf),
      innerproduct -> d<=0 ? 1/(1-d) : d+1, cosinesimil -> 1 + cos.
    """
    q = query.unsqueeze(0)
    if space == "l2":
        return (1.0 / (1.0 + pairwise_sqdist(q, vectors)))[0]
    if space == "l1":
        return 1.0 / (1.0 + torch.sum(torch.abs(vectors - q), -1))
    if space == "linf":
        return 1.0 / (1.0 + torch.amax(torch.abs(vectors - q), -1))
    if space == "innerproduct":
        d = (q @ vectors.T)[0]
        return torch.where(d <= 0, 1.0 / (1.0 - d), d + 1.0)
    if space == "cosinesimil":
        return 1.0 + (_normalize(q) @ _normalize(vectors).T)[0]
    raise ValueError(f"unsupported space {space}")


def popcount_sum(x: torch.Tensor) -> torch.Tensor:
    """Set bits per row of packed uint8 codes: [..., B] -> [...] int32.

    PyTorch has no population-count operator, so the bytes are read four at
    a time as int32 words and counted with the usual masked shifts; a width
    that is not a multiple of 4 is zero-padded here, not in the stored
    codes. The arithmetic shifts' sign bits fall outside every mask."""
    pad = (-x.shape[-1]) % 4
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    w = x.contiguous().view(torch.int32)
    w = w - ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w + (w >> 4)) & 0x0F0F0F0F
    w = w + (w >> 8)
    w = (w + (w >> 16)) & 0x3F
    return w.sum(-1, dtype=torch.int32)


def hamming_scores(query_bits: torch.Tensor,
                   vector_bits: torch.Tensor) -> torch.Tensor:
    """Hamming score 1/(1+popcount(xor)) over packed uint8 codes.

    query_bits [b] against vector_bits [n, b] -> [n]; with leading batch
    dimensions the two broadcast ([Q, 1, b] against [Q, C, b] -> [Q, C])."""
    pop = popcount_sum(torch.bitwise_xor(vector_bits, query_bits))
    return 1.0 / (1.0 + pop.float())


def host_candidate_scores(
    queries: np.ndarray,  # [Q, d] f32 (host)
    cand_vecs: np.ndarray,  # [Q, C, d] f32 (host)
    simf: SimilarityFunction,
) -> np.ndarray:
    """NumPy mirror of `batched_candidate_scores` for host-side reranks."""
    q = np.asarray(queries, np.float32)
    c = np.asarray(cand_vecs, np.float32)
    if simf is SimilarityFunction.EUCLIDEAN:
        q2 = np.sum(q * q, -1)[:, None]
        c2 = np.sum(c * c, -1)
        dot = np.einsum("qd,qcd->qc", q, c, optimize=True)
        d2 = np.maximum(q2 + c2 - 2.0 * dot, 0.0)
        return 1.0 / (1.0 + d2)
    if simf is SimilarityFunction.DOT_PRODUCT:
        return (1.0 + np.einsum("qd,qcd->qc", q, c, optimize=True)) / 2.0
    if simf is SimilarityFunction.COSINE:
        qn = q / np.sqrt(np.sum(q * q, -1, keepdims=True) + 1e-30)
        cn = c / np.sqrt(np.sum(c * c, -1, keepdims=True) + 1e-30)
        return (1.0 + np.einsum("qd,qcd->qc", qn, cn, optimize=True)) / 2.0
    raise ValueError(f"unsupported similarity {simf}")
