"""Brute-force ground truth + recall (test/bench harness utility).

Port of `opensearch_jvector_tpu/utils/ground_truth.py`: exact top-k by a
full scan, blocked over queries and corpus so the [Q, N] score matrix never
materializes.
"""

from __future__ import annotations

import numpy as np
import torch

from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    pairwise_scores,
)


def ground_truth_topk(
    queries: torch.Tensor,  # [Q, d]
    vectors: torch.Tensor,  # [N, d], same device
    k: int,
    simf: SimilarityFunction,
) -> np.ndarray:
    """Exact top-k ids per query by full scan, [Q, k] int64."""
    block, query_block = 1 << 20, 1024  # [1024, 2^20] f32 slab = 4 GiB
    n = vectors.shape[0]
    kk = min(k, n)
    out = []
    for qs in range(0, queries.shape[0], query_block):
        qb = queries[qs: qs + query_block]
        best_s = best_i = None
        for s in range(0, n, block):
            scores = pairwise_scores(qb, vectors[s: s + block], simf)
            top_s, top_i = torch.topk(scores, min(kk, scores.shape[1]), dim=1)
            top_i = top_i + s
            if best_s is not None:
                top_s = torch.cat([best_s, top_s], 1)
                top_i = torch.cat([best_i, top_i], 1)
                top_s, sel = torch.topk(top_s, kk, dim=1)
                top_i = torch.gather(top_i, 1, sel)
            best_s, best_i = top_s, top_i
        out.append(best_i.cpu().numpy())
    return np.concatenate(out)


def recall_at_k(result_ids: np.ndarray, truth_ids: np.ndarray, k: int) -> float:
    """Mean |results ∩ truth| / k over the query batch."""
    hits = 0
    q = truth_ids.shape[0]
    for i in range(q):
        hits += len(set(result_ids[i, :k].tolist())
                    & set(truth_ids[i, :k].tolist()))
    return hits / (q * k)
