"""Exact (brute-force) scoring: the script-score surface + exact fallback.

Port of `opensearch_jvector_tpu/query/exact.py`. Mirrors the painless
`knn_score` engine's space functions (KNNScoringUtil.java:100-253:
l2Squared, l1Norm, lInfNorm, innerProduct, cosinesimil, hamming) and the
filtered-exact-search iterators used when a filter is too selective for
graph search. Every segment is scored in one batched pass on its device
(`pairwise_scores` / `exact_scores` / `hamming_scores`), then top-k; only
the top-k comes back to the host.

A segment's valid rows are its live, mapped ordinals intersected with the
caller's accept mask over ordinals (`index/reader.ordinal_accept_mask`,
which also folds in the tombstones of the caller's snapshot).
"""

from __future__ import annotations

import numpy as np
import torch

from opensearch_jvector_tpu_torch.index.reader import _blocked_scan_topr
from opensearch_jvector_tpu_torch.index.segment import Segment
from opensearch_jvector_tpu_torch.ops.beam_kernel import _first_topk
from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    exact_scores,
    hamming_scores,
    pairwise_scores,
)

NEG_INF = float("-inf")

# script-score space names (SpaceType strings of the reference)
SCRIPT_SPACES = ("l2", "l1", "linf", "innerproduct", "cosinesimil", "hamming")


def script_score(query, vectors: torch.Tensor, space: str) -> torch.Tensor:
    """Raw script scores of every row of `vectors` [n, d] (on its device)
    against one query [d] -> [n] f32 (KNNScoringUtil parity). For
    "hamming", query and rows are bytes: [b] against [n, b]."""
    dev = vectors.device
    if space == "hamming":
        q = torch.as_tensor(np.asarray(query).astype(np.uint8), device=dev)
        return hamming_scores(q, vectors.to(torch.uint8))
    if space not in SCRIPT_SPACES:
        raise ValueError(f"unknown space {space}; one of {SCRIPT_SPACES}")
    q = torch.as_tensor(np.asarray(query, np.float32), device=dev)
    return exact_scores(q, vectors.float(), space)


def _segment_fp32(seg: Segment) -> torch.Tensor:
    """Every fp32 row of the segment on its device: the resident rows, the
    whole on_disk row file paged in, or the NVQ decode."""
    if seg.vectors is not None:
        return seg.vectors
    if seg.row_store is not None:  # on_disk mode: page the full row file
        rows = seg.row_store.gather(np.arange(seg.row_store.num_rows))
        return torch.from_numpy(rows).to(seg.device)
    assert seg.nvq is not None
    return seg.nvq.decode()


def _padded_docs(seg: Segment, n: int) -> np.ndarray:
    """ord_to_doc over `n` rows (capacity-bucket padding rows map to -1)."""
    docs = seg.docmap.ord_to_doc
    if docs.shape[0] < n:
        docs = np.pad(docs, (0, n - docs.shape[0]), constant_values=-1)
    return docs[:n]


def valid_rows(seg: Segment, n: int,
               accept_ords: np.ndarray | None = None) -> torch.Tensor:
    """Bool [n] on the segment's device: live, mapped ordinals, and where
    `accept_ords` is given, accepted ones (ordinals beyond it are not)."""
    valid = seg.graph.live[:n].cpu().numpy() & (_padded_docs(seg, n) >= 0)
    if accept_ords is not None:
        acc = np.asarray(accept_ords, bool)
        n_acc = min(acc.shape[0], n)
        valid[:n_acc] &= acc[:n_acc]
        valid[n_acc:] = False  # filtered search: unmapped tail not accepted
    return torch.as_tensor(valid, device=seg.device)


def _pad_to(doc_ids: np.ndarray, scores: np.ndarray, k: int):
    if doc_ids.shape[1] < k:
        pad = ((0, 0), (0, k - doc_ids.shape[1]))
        doc_ids = np.pad(doc_ids, pad, constant_values=-1)
        scores = np.pad(scores, pad, constant_values=-np.inf)
    return doc_ids, scores


def exact_search_segment(
    seg: Segment,
    queries,  # [Q, d]
    k: int,
    simf: SimilarityFunction | None = None,
    accept_ords: np.ndarray | None = None,  # bool [capacity]
) -> tuple[np.ndarray, np.ndarray]:
    """Brute-force top-k over one segment -> host (doc_ids [Q, k], scores
    [Q, k]), -1 / -inf pads. Scored in row blocks on the segment's device
    (`index/reader._blocked_scan_topr`)."""
    simf = simf or seg.config.similarity
    v = _segment_fp32(seg)
    n = v.shape[0]
    q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                        device=v.device)
    valid = valid_rows(seg, n, accept_ords)

    def block_scores(lo, hi):
        s = pairwise_scores(q, v[lo:hi], simf)
        return s.masked_fill_(~valid[lo:hi][None, :], NEG_INF)

    kk = min(k, n)
    top_s, top_i = _blocked_scan_topr(block_scores, n, kk)
    top_s, top_i = top_s.cpu().numpy(), top_i.cpu().numpy()
    doc_ids = np.where(top_s > -np.inf, _padded_docs(seg, n)[top_i], -1)
    return _pad_to(doc_ids, top_s, k)


def radial_search_segment(
    seg: Segment,
    queries,
    score_floor: float,
    max_results: int = 10_000,
    accept_ords: np.ndarray | None = None,
):
    """Radial (range) search: all docs with score >= floor, best-first, at
    most `max_results` a query (RNNQueryFactory counterpart)."""
    doc_ids, scores = exact_search_segment(
        seg, queries, min(max_results, seg.capacity() or 1),
        accept_ords=accept_ords,
    )
    keep = scores >= score_floor
    return np.where(keep, doc_ids, -1), np.where(keep, scores, -np.inf)


def script_search_segment(seg: Segment, query, space: str, k: int,
                          accept_ords: np.ndarray | None = None):
    """`knn_score` over every valid row of one segment -> host (doc_ids
    [k'], scores [k']), k' = min(k, rows), best first; among equal scores
    the lower ordinal first (Hamming scores tie in long runs)."""
    rows = _segment_fp32(seg)
    n = rows.shape[0]
    scores = script_score(query, rows, space)
    scores = scores.masked_fill_(~valid_rows(seg, n, accept_ords), NEG_INF)
    top_s, top_i = _first_topk(scores[None, :], min(k, n))
    top_s, top_i = top_s[0].cpu().numpy(), top_i[0].cpu().numpy()
    return (np.where(top_s > -np.inf, _padded_docs(seg, n)[top_i], -1),
            top_s)
