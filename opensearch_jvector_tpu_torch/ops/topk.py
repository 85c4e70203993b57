"""Top-k selection helpers.

Port of `opensearch_jvector_tpu/ops/topk.py`. `exact_topk_wide` is not
carried: it works around a sort-bound `lax.top_k` on the TPU, and
`torch.topk` selects without a full sort. Ties may come out in another
order than `jax.lax.top_k`; callers compare ids only up to equal scores.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def topk_scores(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k (score desc) pairs along the last axis -> (scores, ids)."""
    top_s, idx = torch.topk(scores, k, dim=-1)
    return top_s, torch.gather(ids, -1, idx)


def masked_topk(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k with invalid entries pushed to -inf. Returns (scores, indices)."""
    return torch.topk(torch.where(mask, scores, NEG_INF), k, dim=-1)


def merge_topk(scores_a, ids_a, scores_b, ids_b, k: int):
    """Merge two top-k lists into one."""
    return topk_scores(torch.cat([scores_a, scores_b], -1),
                       torch.cat([ids_a, ids_b], -1), k)
