"""Brute-force ground truth + recall (test/bench harness utility).

Port of `opensearch_jvector_tpu/utils/ground_truth.py`: exact top-k by a
full scan with a running top-k merge over corpus blocks, so the [Q, N]
score matrix never materializes. `ground_truth_topk_stream` takes the
corpus as a stream of host blocks that a producer may make lazily.
"""

from __future__ import annotations

import numpy as np
import torch

from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    pairwise_scores,
)

QUERY_BLOCK = 1024  # with the default block, a [1024, 2^20] f32 slab: 4 GiB


def _merge_topk(best, queries, blk, lo: int, k: int, simf):
    """Fold corpus rows `blk` (ordinals from `lo`) into the running top-k
    `best` = (scores, ids) or None."""
    scores = pairwise_scores(queries, blk, simf)
    top_s, top_i = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    top_i = top_i + lo
    if best is not None:
        top_s = torch.cat([best[0], top_s], 1)
        top_i = torch.cat([best[1], top_i], 1)
        top_s, sel = torch.topk(top_s, min(k, top_s.shape[1]), dim=1)
        top_i = torch.gather(top_i, 1, sel)
    return top_s, top_i


def ground_truth_topk(
    queries: torch.Tensor,  # [Q, d]
    vectors: torch.Tensor,  # [N, d], same device
    k: int,
    simf: SimilarityFunction,
    block: int = 1 << 20,
) -> np.ndarray:
    """Exact top-k ids per query by full scan, [Q, k] int64, over corpus
    blocks of `block` rows and query blocks of QUERY_BLOCK."""
    n = vectors.shape[0]
    out = []
    for qs in range(0, queries.shape[0], QUERY_BLOCK):
        qb = queries[qs: qs + QUERY_BLOCK]
        best = None
        for lo in range(0, n, block):
            best = _merge_topk(best, qb, vectors[lo: lo + block], lo, k, simf)
        out.append(best[1].cpu().numpy())
    return np.concatenate(out)


def ground_truth_topk_stream(
    queries: torch.Tensor,  # [Q, d]
    blocks,  # iterable of (offset, [b, d] np.float32), in corpus order
    k: int,
    simf: SimilarityFunction,
) -> np.ndarray:
    """Exact top-k ids over a corpus delivered as a stream of blocks,
    [Q, k] int64.

    Each block is uploaded to `queries.device` and merged into the running
    top-k. The producer is pulled one block at a time with one block in
    flight: before it is asked for the next block, the host waits for the
    merge of the block before this one, so the producer's work on block
    i + 1 overlaps the device pass over block i, and no more than two
    blocks' uploads and score slabs are ever queued."""
    dev = queries.device
    best = None
    prev_done = None
    for lo, blk_np in blocks:
        blk = torch.as_tensor(blk_np, device=dev)
        best = _merge_topk(best, queries, blk, int(lo), k, simf)
        if prev_done is not None:
            prev_done.synchronize()
        if dev.type == "cuda":
            prev_done = torch.cuda.Event()
            prev_done.record(torch.cuda.current_stream(dev))
    return best[1].cpu().numpy()


def recall_at_k(result_ids: np.ndarray, truth_ids: np.ndarray, k: int) -> float:
    """Mean |results ∩ truth| / k over the query batch."""
    hits = 0
    q = truth_ids.shape[0]
    for i in range(q):
        hits += len(set(result_ids[i, :k].tolist())
                    & set(truth_ids[i, :k].tolist()))
    return hits / (q * k)
