"""KNN query execution: ANN / exact-fallback / radial / rescore dispatch.

Port of `opensearch_jvector_tpu/query/knn.py`. Mirrors
`KNNQueryBuilder.doToQuery` + Lucene's filtered-search policy
(KNNQueryBuilder.java:376-611; exact fallback when the filter is more
selective than the ANN budget, with the
`index.knn.advanced.filtered_exact_search_threshold` setting).

The exact, radial and script passes take the segment set and its
tombstones in one snapshot (`VectorIndex.snapshot`), fold each segment's
tombstones into its accept mask, and hold the segment's reader for the
length of its scan (`VectorIndex._pinned_reader`): a merge that swaps the
set meanwhile can neither bring deleted docs back nor close an on_disk
row store under the scan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import SearchConfig
from opensearch_jvector_tpu_torch.api.settings import (
    GLOBAL_SETTINGS,
    SettingsRegistry,
)
from opensearch_jvector_tpu_torch.api.stats import STATS, Counter, StatsRegistry
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.reader import (
    QueryResult,
    ordinal_accept_mask,
)
from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    batched_candidate_scores,
)
from opensearch_jvector_tpu_torch.query import exact as exact_mod
from opensearch_jvector_tpu_torch.query.builder import KnnQuery


def _filter_count(filter_docs) -> int | None:
    if filter_docs is None:
        return None
    f = np.asarray(filter_docs)
    return int(f.sum()) if f.dtype == bool else int(f.size)


def execute_knn_query(
    index: VectorIndex,
    query: KnnQuery,
    settings: SettingsRegistry = GLOBAL_SETTINGS,
    stats: StatsRegistry = STATS,
) -> QueryResult:
    """Run a validated knn query against a VectorIndex."""
    if query.is_radial:
        return _radial(index, query)

    k = query.k
    oq = query.overquery_factor
    fcount = _filter_count(query.filter_docs)

    # exact fallback: filter more selective than the ANN budget
    threshold = settings.get("index.knn.advanced.filtered_exact_search_threshold")
    if threshold == -1:
        threshold = k * oq
    if fcount is not None and fcount <= threshold:
        return _exact_over_segments(index, query, k)

    nested = index.has_nested() and not query.expand_nested_docs
    fetch_k = k
    if query.rescore is not None:
        fetch_k = min(int(np.ceil(k * query.rescore.oversample_factor)),
                      10_000)
    if nested:
        # oversample children so k distinct parents survive the collapse
        fetch_k = min(fetch_k * 3, 10_000)
    sc = SearchConfig(
        k=fetch_k,
        ef_search=query.ef_search,
        overquery_factor=oq,
        threshold=query.threshold,
        rerank_floor=query.rerank_floor,
        use_pruning=query.use_pruning,
    )
    res = index.search(query.vector, sc, accept_docs=query.filter_docs)

    if query.rescore is not None:
        res = _rescore(index, query, res, k if not nested else fetch_k)
    if nested:
        res = _collapse_nested(index, res, k)
    return res


def _collapse_nested(index: VectorIndex, res: QueryResult,
                     k: int) -> QueryResult:
    """Aggregate child hits to parents (max child score per parent).

    Lucene nested-knn semantics: the parent joins its best-scoring child;
    expand_nested_docs=True skips this.
    """
    ids = res.doc_ids
    parents = index.parents_of(ids)
    # docs without a parent represent themselves
    group = np.where(parents >= 0, parents, ids)
    out_ids = np.full((ids.shape[0], k), -1, np.int64)
    out_scores = np.full((ids.shape[0], k), -np.inf, np.float32)
    for qi in range(ids.shape[0]):
        seen: dict[int, float] = {}
        order = []
        for d, g, s in zip(ids[qi], group[qi], res.scores[qi]):
            if d < 0 or not np.isfinite(s):
                continue
            if int(g) not in seen:  # hits arrive score-desc: first is max
                seen[int(g)] = float(s)
                order.append(int(g))
            if len(order) >= k:
                break
        for j, g in enumerate(order):
            out_ids[qi, j] = g
            out_scores[qi, j] = seen[g]
    return dataclasses.replace(res, doc_ids=out_ids, scores=out_scores)


def _merge_top(ids: list[np.ndarray], scores: list[np.ndarray], qn: int,
               k: int | None) -> tuple[np.ndarray, np.ndarray]:
    """Per-segment [Q, *] results -> the best `k` a query (all when None),
    best first, ties in segment order; -1 / -inf pads up to k."""
    all_ids = np.concatenate([np.full((qn, 0), -1, np.int64)] + ids, axis=1)
    all_scores = np.concatenate([np.zeros((qn, 0), np.float32)] + scores,
                                axis=1)
    order = np.argsort(-all_scores, axis=1, kind="stable")[:, :k]
    out_ids = np.take_along_axis(all_ids, order, axis=1)
    out_scores = np.take_along_axis(all_scores, order, axis=1)
    if k is not None:
        out_ids, out_scores = exact_mod._pad_to(out_ids, out_scores, k)
    return out_ids, out_scores


def _accept_ords(seg, filter_docs, deleted_docs=None) -> np.ndarray | None:
    """Doc filter (+ the snapshot's tombstones) -> ordinal mask over the
    full graph capacity, None when neither applies (one implementation:
    reader.ordinal_accept_mask handles bool masks, id arrays and the
    capacity-bucket padding)."""
    return ordinal_accept_mask(seg, filter_docs, deleted_docs)


def _scan_segments(index: VectorIndex, filter_docs, scan) -> tuple[list, list]:
    """scan(segment, accept_ords) -> (ids, scores) for every segment of one
    snapshot, each under its pinned reader."""
    ids, scores = [], []
    for name, dead in index.snapshot():
        with index._pinned_reader(name) as reader:
            seg = reader.seg
            i, s = scan(seg, _accept_ords(seg, filter_docs, dead))
        ids.append(i)
        scores.append(s)
    return ids, scores


def execute_script_score(
    index: VectorIndex,
    space: str,
    query_value,
    k: int = 10,
    accept_docs=None,
) -> QueryResult:
    """Exact script scoring over the whole index (painless knn_score parity).

    The reference's `knn_score` painless script (KNNScoringScriptEngine +
    KNNScoringSpaceFactory) scores every candidate doc with a space
    function; here it is one batched pass per segment on its device
    (KNNScoringUtil.java:100-253 space semantics via
    query/exact.script_score).
    """
    if space not in exact_mod.SCRIPT_SPACES:
        # counted separately so operators can spot misconfigured scripts
        # (KNNCounter.SCRIPT_QUERY_ERRORS parity)
        index.stats.increment(Counter.SCRIPT_QUERY_REQUESTS)
        index.stats.increment(Counter.SCRIPT_QUERY_ERRORS)
        raise ValueError(f"unknown space {space}; "
                         f"one of {exact_mod.SCRIPT_SPACES}")
    q = np.asarray(query_value, np.float32)

    def scan(seg, accept):
        i, s = exact_mod.script_search_segment(seg, q, space, k, accept)
        return i[None, :], s[None, :]

    ids, scores = _scan_segments(index, accept_docs, scan)
    ids, scores = _merge_top(ids, scores, 1, k)
    index.stats.increment(Counter.SCRIPT_QUERY_REQUESTS)
    return QueryResult(doc_ids=ids, scores=scores,
                       visited=0, expanded=0, reranked=0)


def _exact_over_segments(index: VectorIndex, query: KnnQuery,
                         k: int) -> QueryResult:
    """Brute-force scan of every segment (restrictive-filter path)."""
    q = np.atleast_2d(query.vector)
    ids, scores = _scan_segments(
        index, query.filter_docs,
        lambda seg, accept: exact_mod.exact_search_segment(
            seg, q, k, accept_ords=accept))
    ids, scores = _merge_top(ids, scores, q.shape[0], k)
    return QueryResult(doc_ids=ids, scores=scores,
                       visited=0, expanded=0, reranked=0)


def _rescore(index: VectorIndex, query: KnnQuery, res: QueryResult,
             k: int) -> QueryResult:
    """Exact re-scoring of the oversampled candidates (RescoreContext).

    Batched: candidate vectors for ALL queries are fetched in one bulk
    read-back (per-segment doc->ordinal inverse) and rescored in one
    batched call on the index's device.
    """
    dev = index.device
    q = torch.as_tensor(np.atleast_2d(query.vector), dtype=torch.float32,
                        device=dev)  # [Q, d]
    cand_ids = res.doc_ids  # [Q, fetch_k]
    qn, fk = cand_ids.shape
    vecs, found = index.get_vectors(cand_ids.reshape(-1))
    vecs = torch.as_tensor(vecs.reshape(qn, fk, -1), device=dev)
    found = found.reshape(qn, fk)
    s = batched_candidate_scores(q, vecs, index.config.similarity)
    s = np.where(found & (cand_ids >= 0), s.cpu().numpy(), -np.inf)
    order = np.argsort(-s, axis=1, kind="stable")[:, :k]
    ids = np.take_along_axis(cand_ids, order, axis=1)
    scores = np.take_along_axis(s, order, axis=1)
    ids = np.where(scores > -np.inf, ids, -1)
    return dataclasses.replace(res, doc_ids=ids, scores=scores)


def _radial(index: VectorIndex, query: KnnQuery) -> QueryResult:
    """Radial search: all docs within a distance / above a score."""
    simf = index.config.similarity
    if query.min_score is not None:
        # translate the user's score (reference score space, per space
        # type) into the engine's score convention. EUCLIDEAN and COSINE
        # reference scores coincide with the engine's (1/(1+d^2) and
        # (1+cos)/2); INNER_PRODUCT is piecewise in the reference
        # (dot>=0 -> 1+dot, dot<0 -> 1/(1-dot), JVector.java:44-49) while
        # the engine scores (1+dot)/2.
        s = float(query.min_score)
        if simf is SimilarityFunction.DOT_PRODUCT:
            dot = (s - 1.0) if s >= 1.0 else (1.0 - 1.0 / max(s, 1e-30))
            floor = (1.0 + dot) / 2.0
        else:
            floor = s
    else:
        # translate max_distance -> engine score floor per space:
        # EUCLIDEAN distance is squared-L2 (score 1/(1+d)), COSINE distance
        # is 1-cos (score (2-d)/2), INNER_PRODUCT distance is -dot
        # (score (1-d)/2) — SpaceType semantics.
        d = float(query.max_distance)
        if simf is SimilarityFunction.EUCLIDEAN:
            floor = 1.0 / (1.0 + d)
        elif simf is SimilarityFunction.DOT_PRODUCT:
            floor = (1.0 - d) / 2.0
        else:
            floor = (2.0 - d) / 2.0  # cosine
    q = np.atleast_2d(query.vector)
    ids, scores = _scan_segments(
        index, query.filter_docs,
        lambda seg, accept: exact_mod.radial_search_segment(
            seg, q, floor, accept_ords=accept))
    ids, scores = _merge_top(ids, scores, q.shape[0], None)
    width = int((scores > -np.inf).sum(axis=1).max(initial=0))
    return QueryResult(
        doc_ids=ids[:, :width], scores=scores[:, :width],
        visited=0, expanded=0, reranked=0,
    )
