"""Segment reader: two-phase search + doc-id mapping + counters.

Port of the in-memory tiers of `opensearch_jvector_tpu/index/reader.py`:
  * scan tier (`_scan_search`) for PQ segments of at most
    `scan_tier_max_codes` codes, and for flat segments: per-query LUTs,
    the fused ADC scan kernel (ops/adc_kernel.py), exact top-r, then a
    gather and an exact fp32 rerank; flat unquantized segments score exact
    fp32 rows instead of codes;
  * beam tier for larger graph segments: beam search with the exact fp32
    provider (models/searcher.py).
Top-r is exact at every width (the reference switches to `approx_max_k`
above 2^18 on the TPU). The on_disk tier (`_tiered_search`) is not ported
yet (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import SearchConfig
from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
from opensearch_jvector_tpu_torch.api.stats import STATS, Counter, StatsRegistry
from opensearch_jvector_tpu_torch.index import segment as segment_mod
from opensearch_jvector_tpu_torch.index.segment import Segment
from opensearch_jvector_tpu_torch.models import searcher as searcher_mod
from opensearch_jvector_tpu_torch.models.searcher import SearchParams
from opensearch_jvector_tpu_torch.ops import adc as adc_ops
from opensearch_jvector_tpu_torch.ops.adc_kernel import adc_scan
from opensearch_jvector_tpu_torch.ops.distances import (
    batched_candidate_scores,
    pairwise_scores,
)
from opensearch_jvector_tpu_torch.utils.profiling import phase

NEG_INF = float("-inf")
SCAN_BLOCK = 1 << 20  # bounds the [Q, block] score slab (~2GB at Q=512)


@dataclasses.dataclass
class QueryResult:
    doc_ids: np.ndarray  # [Q, k] int64, -1 pad
    scores: np.ndarray  # [Q, k] f32, -inf pad
    visited: int
    expanded: int
    reranked: int


def _blocked_scan_topr(block_scores, n: int, r: int):
    """Running exact top-r over a blocked corpus scan.

    `block_scores(lo, hi) -> [Q, hi-lo]` scores (invalid rows at -inf) for
    one corpus slice; blocks of SCAN_BLOCK keep the score slab bounded.
    Returns (top_s [Q, r'], top_i [Q, r']) with global ids."""
    best_s = best_i = None
    for lo in range(0, n, SCAN_BLOCK):
        hi = min(lo + SCAN_BLOCK, n)
        scores = block_scores(lo, hi)
        top_s, top_i = torch.topk(scores, min(r, hi - lo), dim=1)
        del scores
        top_i = top_i + lo
        if best_s is not None:
            top_s = torch.cat([best_s, top_s], 1)
            top_i = torch.cat([best_i, top_i], 1)
            top_s, sel = torch.topk(top_s, min(r, top_s.shape[1]), dim=1)
            top_i = torch.gather(top_i, 1, sel)
        best_s, best_i = top_s, top_i
    return best_s, best_i


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Tensors -> numpy arrays with one wait on the device: every copy is
    queued without blocking (into pinned memory), then the stream is
    synchronised once."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    if tensors[0].is_cuda:
        torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


def ordinal_accept_mask(seg: Segment, accept_docs,
                        deleted_docs=None) -> np.ndarray | None:
    """Accepted docs -> graph-ordinal bitmap (None when unfiltered).

    Tombstoned docs are intersected into the mask, so dead docs never
    consume result slots."""
    if accept_docs is None and not deleted_docs:
        return None
    o2d = seg.docmap.ord_to_doc
    if accept_docs is None:
        mask = o2d >= 0
    else:
        accept_docs = np.asarray(accept_docs)
        if accept_docs.dtype == bool:
            ok = (o2d >= 0) & (o2d < accept_docs.shape[0])
            mask = np.zeros(o2d.shape[0], bool)
            mask[ok] = accept_docs[o2d[ok]]
        else:  # a set/array of accepted doc ids
            mask = np.isin(o2d, accept_docs) & (o2d >= 0)
    if deleted_docs:
        dead = np.fromiter(deleted_docs, np.int64)
        mask = mask & ~np.isin(o2d, dead)
    cap = seg.graph.capacity
    if mask.shape[0] < cap:
        mask = np.pad(mask, (0, cap - mask.shape[0]))
    return mask[:cap]


class SegmentReader:
    # Segments of at most this many codes take the exhaustive scan tier.
    SCAN_TIER_MAX_CODES = 1 << 18

    def __init__(self, seg: Segment, stats: StatsRegistry = STATS):
        self.seg = seg
        self.stats = stats
        # device masks kept between searches: the unfiltered accept mask
        # with the tombstones it was built from, and the scan tier's mask
        # of live, mapped ordinals
        self._accept_key: frozenset | None = None
        self._accept_mask: torch.Tensor | None = None
        self._valid: torch.Tensor | None = None

    @classmethod
    def open(cls, path: str | Path, device: torch.device | str,
             verify: bool = True,
             stats: StatsRegistry = STATS) -> "SegmentReader":
        return cls(segment_mod.read_segment(path, device, verify=verify),
                   stats)

    def _scan_bound(self) -> int:
        """`index.knn.advanced.scan_tier_max_codes` when set (>= 0), else
        the class default."""
        v = GLOBAL_SETTINGS.get("index.knn.advanced.scan_tier_max_codes")
        return self.SCAN_TIER_MAX_CODES if v < 0 else v

    def search(
        self,
        queries,  # [Q, d]
        sc: SearchConfig,
        accept_docs=None,  # bool array over doc ids, or array of doc ids
        deleted_docs=None,  # set of tombstoned doc ids (liveDocs analog)
    ) -> QueryResult:
        seg = self.seg
        queries = torch.as_tensor(np.asarray(queries, np.float32),
                                  device=seg.device)
        if queries.dim() == 1:
            queries = queries[None, :]
        qn = queries.shape[0]
        if seg.capacity() == 0:
            return QueryResult(
                doc_ids=np.full((qn, sc.k), -1, np.int64),
                scores=np.full((qn, sc.k), -np.inf, np.float32),
                visited=0, expanded=0, reranked=0,
            )
        params = SearchParams(
            k=sc.k,
            ef_search=sc.resolved_ef(),
            overquery_factor=sc.overquery_factor,
            threshold=sc.threshold,
            rerank_floor=sc.rerank_floor,
        )
        accept = self._accept(accept_docs, deleted_docs)
        filtered = accept_docs is not None
        flat = seg.config.index_type == "flat"
        if flat or (seg.pqv is not None
                    and seg.capacity() <= self._scan_bound()):
            return self._scan_search(queries, params, accept, filtered)
        if seg.graph.upper_adjacency is not None:
            raise NotImplementedError(
                "hierarchy-layer search is not ported yet "
                "(ROADMAP queue 1 item 9)")

        t0 = time.monotonic()
        with phase("query", stats=self.stats):
            res = searcher_mod.search(
                seg.graph.adjacency, seg.graph.live, seg.graph.entry,
                queries, params, seg.config.similarity,
                vectors=seg.vectors, accept=accept,
            )
            ids, scores, visited, expanded, reranked = _to_host(
                res.ids, res.scores, res.visited_count.sum(),
                res.expanded_count.sum(), res.reranked_count.sum())
            visited, expanded, reranked = (
                int(visited), int(expanded), int(reranked))
        self.stats.increment(Counter.KNN_GRAPH_SEARCH_TIME,
                             int((time.monotonic() - t0) * 1000))
        self._count(qn, filtered, visited, expanded, reranked)
        doc_ids = seg.docmap.lookup_docs(ids)
        return QueryResult(
            doc_ids=doc_ids,
            scores=np.where(doc_ids >= 0, scores, -np.inf),
            visited=visited, expanded=expanded, reranked=reranked,
        )

    def _accept(self, accept_docs, deleted_docs) -> torch.Tensor | None:
        """Device accept mask over ordinals (None when unfiltered). Without
        a filter it depends only on the tombstones, so it stays on the
        device until they change."""
        if accept_docs is not None:
            return torch.as_tensor(
                ordinal_accept_mask(self.seg, accept_docs, deleted_docs),
                device=self.seg.device)
        key = frozenset(deleted_docs or ())
        if key != self._accept_key:
            mask = ordinal_accept_mask(self.seg, None, key)
            self._accept_mask = (None if mask is None else
                                 torch.as_tensor(mask, device=self.seg.device))
            self._accept_key = key
        return self._accept_mask

    def _live_valid(self) -> torch.Tensor:
        """Live ordinals that map to a doc, built once per segment."""
        if self._valid is None:
            seg = self.seg
            o2d = torch.tensor(seg.docmap.ord_to_doc, device=seg.device)
            valid = seg.graph.live.clone()
            valid[: o2d.shape[0]] &= o2d >= 0
            valid[o2d.shape[0]:] = False
            self._valid = valid
        return self._valid

    def _count(self, qn, filtered, visited, expanded, reranked) -> None:
        self.stats.increment(Counter.KNN_QUERY_COUNT, qn)
        if filtered:
            self.stats.increment(Counter.KNN_QUERY_WITH_FILTER_COUNT, qn)
        self.stats.increment(Counter.KNN_QUERY_VISITED_NODES, visited)
        self.stats.increment(Counter.KNN_QUERY_EXPANDED_NODES, expanded)
        self.stats.increment(Counter.KNN_QUERY_EXPANDED_BASE_LAYER_NODES,
                             expanded)
        self.stats.increment(Counter.KNN_QUERY_RERANKED_COUNT, reranked)

    def _scan_search(self, queries, params: SearchParams, accept,
                     filtered: bool) -> QueryResult:
        """Exhaustive scan (fused ADC over PQ codes, or exact fp32 rows for
        flat unquantized segments), exact top-r, exact fp32 rerank."""
        seg = self.seg
        simf = seg.config.similarity
        r = max(params.k * params.overquery_factor, params.k)
        t0 = time.monotonic()
        valid = self._live_valid() if accept is None else accept
        with phase("query", stats=self.stats):
            if seg.pqv is not None:
                luts = seg.pqv.build_query_luts(queries, simf)

                def block_scores(lo, hi):
                    vals = adc_scan(luts, seg.pqv.codes[lo:hi])
                    s = adc_ops.adc_value_to_score(vals, simf)
                    return s.masked_fill_(~valid[lo:hi][None, :], NEG_INF)
            else:
                def block_scores(lo, hi):
                    s = pairwise_scores(queries, seg.vectors[lo:hi], simf)
                    return s.masked_fill_(~valid[lo:hi][None, :], NEG_INF)

            approx, cand_ids = _blocked_scan_topr(block_scores,
                                                  seg.capacity(), r)
            qualify = approx > NEG_INF
            if params.rerank_floor > 0.0:
                qualify &= approx >= params.rerank_floor
            cand = seg.vectors[cand_ids.clamp(min=0)]
            exact = batched_candidate_scores(queries, cand, simf)
            exact = torch.where(qualify, exact, NEG_INF)
            kk = min(params.k, exact.shape[1])
            top_s, idx = torch.topk(exact, kk, dim=1)
            top_i = torch.gather(cand_ids, 1, idx)
            keep = top_s > NEG_INF
            if params.threshold > 0.0:
                keep &= top_s >= params.threshold
            # one host transfer for results and counters
            top_i, top_s, scanned, reranked = _to_host(
                torch.where(keep, top_i, -1),
                torch.where(keep, top_s, NEG_INF), valid.sum(),
                qualify.sum())
            scanned, reranked = int(scanned), int(reranked)
        self.stats.increment(Counter.KNN_GRAPH_SEARCH_TIME,
                             int((time.monotonic() - t0) * 1000))
        qn = queries.shape[0]
        if kk < params.k:
            padw = params.k - kk
            top_i = np.pad(top_i, ((0, 0), (0, padw)), constant_values=-1)
            top_s = np.pad(top_s, ((0, 0), (0, padw)),
                           constant_values=-np.inf)
        self._count(qn, filtered, scanned * qn, 0, reranked)
        doc_ids = seg.docmap.lookup_docs(top_i)
        return QueryResult(
            doc_ids=doc_ids, scores=np.where(doc_ids >= 0, top_s, -np.inf),
            visited=scanned * qn, expanded=0, reranked=reranked,
        )
