"""Segment reader: two-phase search + doc-id mapping + counters.

Port of `opensearch_jvector_tpu/index/reader.py`:
  * in_memory scan tier (`_scan_search`) for PQ segments of at most
    `scan_tier_max_codes` codes, and for flat segments: per-query LUTs,
    the fused ADC scan kernel (ops/adc_kernel.py, which also maps the sums
    to scores and masks invalid rows), exact top-r, then a
    gather and an exact fp32 rerank on the device; flat unquantized
    segments score exact fp32 rows instead of codes;
  * NVQ segments of at most `scan_tier_max_codes` codes scan the
    NVQ-decoded bf16 cache instead (one matmul); for euclidean and dot
    product those scores are the reconstruction's own, so the rerank is
    skipped, while cosine reranks against the decoded rows;
  * in_memory beam tier for larger graph segments and for scalar
    segments of any size (models/searcher.py): the exact fp32 provider
    where the rows are resident; Hamming scores of the 1/2/4-bit codes
    with an fp32 rerank for scalar segments; the auxiliary PQ's codes with
    a rerank against NVQ-decoded rows for NVQ segments; the hierarchy
    layer's descent first where the graph has one;
  * on_disk tier (`_tiered_search`): the fp32 rows live in the host row
    store, the approximate phase runs on the device and the exact rerank
    runs on the host. Its scan tier (flat segments at any size, graph
    segments up to the bound) takes the first rung the memory circuit
    breaker allows: the decoded-bf16 cache (2*d bytes per row), else,
    codes only (M bytes per row), the fused decode-then-score kernel
    (ops/pq_scan_kernel.py) for batches that bucket to at least
    FUSED_DECODE_MIN_QUERIES queries, else per-query LUTs and the fused
    ADC scan. Its beam tier scores with the `pq_decoded` provider, or the
    codes-only `pq` provider when the cache is refused. Its three stages
    are profiler ranges (`approximate`, `rerank_gather`, `rerank_score`),
    so a trace splits a batch's host time between them.
Top-r is exact at every width (the reference switches to `approx_max_k`
above 2^18 on the TPU).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from opensearch_jvector_tpu_torch.api.config import SearchConfig
from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
from opensearch_jvector_tpu_torch.api.stats import STATS, Counter, StatsRegistry
from opensearch_jvector_tpu_torch.index import segment as segment_mod
from opensearch_jvector_tpu_torch.index.segment import Segment
from opensearch_jvector_tpu_torch.models import searcher as searcher_mod
from opensearch_jvector_tpu_torch.models.graph import bucket_capacity
from opensearch_jvector_tpu_torch.models.searcher import SearchParams
from opensearch_jvector_tpu_torch.ops.adc_kernel import adc_scan
from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    batched_candidate_scores,
    host_candidate_scores,
    pairwise_scores,
)
from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import decode_scan
from opensearch_jvector_tpu_torch.utils.circuit_breaker import (
    BREAKER,
    CircuitBreakerException,
)
from opensearch_jvector_tpu_torch.utils.profiling import phase

NEG_INF = float("-inf")
SCAN_BLOCK = 1 << 20  # bounds the [Q, block] score slab (~2GB at Q=512)
# Codes-only scan batches whose pow2 bucket (min 8, the reference's batch
# padding) holds at least this many queries take decode_scan; smaller ones
# take per-query LUTs + adc_scan. The reference's routing, kept so both
# packages send a batch to the same rung.
FUSED_DECODE_MIN_QUERIES = 256
# cache rows upcast at a time (CPU matmul, the cache's row norms)
DECODED_MATMUL_ROWS = 1 << 16


def _fused_scan_ok(q_count: int) -> bool:
    """Route a codes-only scan batch to the fused decode-then-score kernel."""
    return bucket_capacity(q_count, minimum=8) >= FUSED_DECODE_MIN_QUERIES


def bf16_scores(qb: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """qb [Q, d] bf16 times rows [n, d] bf16 -> [Q, n] float32, with
    float32 products and sums (the reference's bf16 matmul with a float32
    result). On the card: one tensor-core matmul that writes float32. On
    the CPU, which has no such matmul, the rows are upcast
    DECODED_MATMUL_ROWS at a time."""
    if qb.is_cuda:
        return torch.mm(qb, rows.T, out_dtype=torch.float32)
    qf = qb.float()
    out = torch.empty((qb.shape[0], rows.shape[0]), dtype=torch.float32)
    for s in range(0, rows.shape[0], DECODED_MATMUL_ROWS):
        blk = rows[s: s + DECODED_MATMUL_ROWS].float()
        out[:, s: s + blk.shape[0]] = qf @ blk.T
    return out


def _euclidean_fold(q2: torch.Tensor, sq: torch.Tensor,
                    dot: torch.Tensor) -> torch.Tensor:
    """1 / (1 + max(q2 + sq - 2*dot, 0)) over a [Q, n] slab (reuses
    `dot`), in the reference's order of operations."""
    out = q2[:, None] + sq[None, :]
    out.sub_(dot.mul_(2.0)).clamp_(min=0.0).add_(1.0).reciprocal_()
    return out


def _decoded_scan_scores(queries: torch.Tensor, decoded: torch.Tensor,
                         dec_sq: torch.Tensor,
                         simf: SimilarityFunction) -> torch.Tensor:
    """[Q, n] approximate scores from the decoded-bf16 cache: bf16 queries
    times bf16 rows with float32 products and sums (`bf16_scores`), then
    the score map."""
    if simf is SimilarityFunction.COSINE:
        queries = queries * torch.rsqrt(
            torch.sum(queries * queries, -1, keepdim=True) + 1e-30)
    dot = bf16_scores(queries.to(decoded.dtype), decoded)
    if simf is SimilarityFunction.EUCLIDEAN:
        return _euclidean_fold(torch.sum(queries * queries, -1), dec_sq, dot)
    return dot.add_(1.0).div_(2.0)


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
        # with the tombstones it was built from, as one (tombstones, mask)
        # pair that is replaced whole (searches may run from several
        # threads, each with its own tombstone snapshot), and the scan
        # tier's mask of live, mapped ordinals
        self._accept_cache: tuple[frozenset, torch.Tensor | None] | None = None
        self._valid: torch.Tensor | None = None
        # on_disk scoring caches, built on first use when the breaker
        # allows: the decoded-bf16 cache with its row norms, and the
        # codes-only reconstruction norms
        self._pq_decoded: torch.Tensor | None = None
        self._pq_decoded_sq: torch.Tensor | None = None
        self._codes_sq_cache: torch.Tensor | None = None
        self._scalar_thresholds: torch.Tensor | None = None  # on the device
        # searches run from many threads (the REST service): one builds a
        # device cache while the others wait, so it is never built twice
        self._cache_lock = threading.Lock()

    def close(self) -> None:
        """Release the segment's host row store (on_disk segments)."""
        if self.seg.row_store is not None:
            self.seg.row_store.close()

    def _decoded_cache(self) -> torch.Tensor:
        """Decoded-bf16 scoring cache (2*d bytes per row on the device,
        charged to the breaker): the PQ reconstruction, or for an NVQ
        segment the NVQ one. Raises CircuitBreakerException when it does
        not fit."""
        with self._cache_lock:
            if self._pq_decoded is not None:
                return self._pq_decoded
            seg = self.seg
            n, d = seg.capacity(), seg.config.dim
            if seg.nvq is not None:
                # the NVQ scan tier's cache: the transient float32 decode
                # (4 bytes per dimension) is charged on top of the 2 it is
                # cast down to
                BREAKER.check(n * d * 6, seg.device)
                dec = seg.nvq.decode().to(torch.bfloat16)
            else:
                BREAKER.check(n * d * 2, seg.device)
                dec = seg.pqv.decode_bf16()
            sq = torch.empty((dec.shape[0],), dtype=torch.float32,
                             device=dec.device)
            for s in range(0, dec.shape[0], DECODED_MATMUL_ROWS):
                blk = dec[s: s + DECODED_MATMUL_ROWS].float()
                sq[s: s + blk.shape[0]] = torch.linalg.vecdot(blk, blk)
            self._pq_decoded_sq = sq  # before the cache that announces it
            self._pq_decoded = dec
            return dec

    def _codes_sq(self) -> torch.Tensor:
        """Reconstruction norms ||decode_nocenter||^2 [n] for the codes-only
        fused scan: one adc_scan pass over a Q=1 table of squared codebook
        norms (4 bytes per row, charged to the breaker)."""
        with self._cache_lock:
            if self._codes_sq_cache is None:
                pqv = self.seg.pqv
                BREAKER.check(pqv.codes.shape[0] * 4, self.seg.device)
                cb = pqv.pq.codebooks
                cb_sq = torch.sum(cb * cb, -1)[None].contiguous()  # [1, M, K]
                self._codes_sq_cache = adc_scan(cb_sq, pqv.codes)[0]
        return self._codes_sq_cache

    @classmethod
    def open(cls, path: str | Path, device: torch.device | str,
             verify: bool = True,
             stats: StatsRegistry = STATS) -> "SegmentReader":
        return cls(segment_mod.read_segment(path, device, verify=verify),
                   stats)

    @staticmethod
    def check_integrity(path: str | Path) -> bool:
        """Every checksum of the segment directory `path` holds
        (`segment.check_integrity`)."""
        return segment_mod.check_integrity(path)

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
        q_host = np.atleast_2d(np.asarray(queries, np.float32))
        queries = torch.as_tensor(q_host, device=seg.device)
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
        if seg.row_store is not None:  # on_disk: host-tier rerank
            return self._tiered_search(queries, q_host, params, accept,
                                       filtered, force_scan=flat)
        # scalar segments carry no PQ and NVQ segments' PQ codes are not
        # their rerank source, so neither takes the ADC scan; NVQ segments
        # scan their own decoded cache
        if flat or ((seg.pqv is not None or seg.nvq is not None)
                    and seg.capacity() <= self._scan_bound()):
            return self._scan_search(queries, params, accept, filtered)

        t0 = time.monotonic()
        with phase("query", stats=self.stats):
            res = searcher_mod.search(
                seg.graph.adjacency, seg.graph.live, seg.graph.entry,
                queries, params, seg.config.similarity,
                accept=accept, **self._beam_sources())
            ids, scores, visited, expanded, base, reranked = _to_host(
                res.ids, res.scores, res.visited_count.sum(),
                res.expanded_count.sum(), res.expanded_base_count.sum(),
                res.reranked_count.sum())
            visited, expanded, base, reranked = (
                int(visited), int(expanded), int(base), int(reranked))
        self.stats.increment(Counter.KNN_GRAPH_SEARCH_TIME,
                             int((time.monotonic() - t0) * 1000))
        self._count(qn, filtered, visited, expanded, reranked, base)
        doc_ids = seg.docmap.lookup_docs(ids)
        return QueryResult(
            doc_ids=doc_ids,
            scores=np.where(doc_ids >= 0, scores, -np.inf),
            visited=visited, expanded=expanded, reranked=reranked,
        )

    def _beam_sources(self) -> dict:
        """What the in_memory beam tier hands the searcher. Resident fp32
        rows score exactly (faster and more accurate than the PQ codes
        beside them); scalar segments add their codes and thresholds
        (Hamming approximate phase, fp32 rerank); NVQ segments have no
        resident rows, so their auxiliary PQ drives the approximate phase
        and the NVQ decode the rerank."""
        seg = self.seg
        kwargs: dict = {}
        if seg.graph.upper_adjacency is not None:
            kwargs["upper_adjacency"] = seg.graph.upper_adjacency
        vectors, nvq = seg.rerank_source()
        if vectors is not None:
            kwargs["vectors"] = vectors
        elif seg.pqv is not None:
            kwargs.update(pq_codes=seg.pqv.codes,
                          pq_codebooks=seg.pqv.pq.codebooks,
                          pq_center=seg.pqv.pq.center)
        if seg.scalar_state is not None:
            if self._scalar_thresholds is None:
                self._scalar_thresholds = torch.from_numpy(
                    np.ascontiguousarray(seg.scalar_state.thresholds)
                ).to(seg.device)
            kwargs.update(scalar_codes=seg.scalar_codes,
                          scalar_thresholds=self._scalar_thresholds)
        if nvq is not None:
            assert seg.pqv is not None, (
                "NVQ segments always carry an auxiliary PQ (nvq+pq)")
            kwargs["nvq"] = nvq
        return kwargs

    def _accept(self, accept_docs, deleted_docs) -> torch.Tensor | None:
        """Device accept mask over ordinals (None when unfiltered). Without
        a filter it depends only on the tombstones, so it stays on the
        device until they change."""
        if accept_docs is not None:
            return torch.as_tensor(
                ordinal_accept_mask(self.seg, accept_docs, deleted_docs),
                device=self.seg.device)
        # the index hands the same frozen snapshot until the set changes
        key = frozenset(deleted_docs or ())
        cached = self._accept_cache
        if cached is None or (cached[0] is not key and cached[0] != key):
            mask = ordinal_accept_mask(self.seg, None, key)
            cached = self._accept_cache = (
                key, None if mask is None else
                torch.as_tensor(mask, device=self.seg.device))
        return cached[1]

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

    def _count(self, qn, filtered, visited, expanded, reranked,
               expanded_base=None) -> None:
        """`expanded_base` is the base layer's share of `expanded` where a
        hierarchy layer was descended first; by default all of it."""
        self.stats.increment(Counter.KNN_QUERY_COUNT, qn)
        if filtered:
            self.stats.increment(Counter.KNN_QUERY_WITH_FILTER_COUNT, qn)
        self.stats.increment(Counter.KNN_QUERY_VISITED_NODES, visited)
        self.stats.increment(Counter.KNN_QUERY_EXPANDED_NODES, expanded)
        self.stats.increment(
            Counter.KNN_QUERY_EXPANDED_BASE_LAYER_NODES,
            expanded if expanded_base is None else expanded_base)
        self.stats.increment(Counter.KNN_QUERY_RERANKED_COUNT, reranked)

    def _scan_search(self, queries, params: SearchParams, accept,
                     filtered: bool) -> QueryResult:
        """Exhaustive scan (the NVQ-decoded bf16 cache for NVQ segments,
        else fused ADC over PQ codes, else exact fp32 rows for flat
        unquantized segments), exact top-r, exact rerank."""
        seg = self.seg
        simf = seg.config.similarity
        r = max(params.k * params.overquery_factor, params.k)
        t0 = time.monotonic()
        valid = self._live_valid() if accept is None else accept
        with phase("query", stats=self.stats):
            if seg.nvq is not None:
                # before the PQ branch: an NVQ segment's auxiliary PQ codes
                # are not its rerank source
                decoded = self._decoded_cache()
                dec_sq = self._pq_decoded_sq

                def block_scores(lo, hi):
                    s = _decoded_scan_scores(queries, decoded[lo:hi],
                                             dec_sq[lo:hi], simf)
                    return s.masked_fill_(~valid[lo:hi][None, :], NEG_INF)
            elif seg.pqv is not None:
                luts = seg.pqv.build_query_luts(queries, simf)

                def block_scores(lo, hi):
                    return adc_scan(luts, seg.pqv.codes[lo:hi], simf,
                                    valid[lo:hi])
            else:
                def block_scores(lo, hi):
                    s = pairwise_scores(queries, seg.vectors[lo:hi], simf)
                    return s.masked_fill_(~valid[lo:hi][None, :], NEG_INF)

            approx, cand_ids = _blocked_scan_topr(block_scores,
                                                  seg.capacity(), r)
            qualify = approx > NEG_INF
            if params.rerank_floor > 0.0:
                qualify &= approx >= params.rerank_floor
            if (seg.nvq is not None
                    and simf is not SimilarityFunction.COSINE):
                # a rerank would rescore the very rows the scan scored: for
                # euclidean and dot product the approximate scores are the
                # reconstruction's exact ones. (The reconstruction is not
                # normalized, so cosine still reranks.)
                exact = torch.where(qualify, approx, NEG_INF)
            else:
                rows = (seg.vectors if seg.vectors is not None
                        else self._decoded_cache())  # the NVQ reconstruction
                cand = rows[cand_ids.clamp(min=0)].float()
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

    def _codes_scan_fn(self, queries, valid):
        """block_scores(lo, hi) for the on_disk scan tier, on the first rung
        the breaker allows (see the module docstring)."""
        seg = self.seg
        simf = seg.config.similarity
        pq = seg.pqv.pq
        codes = seg.pqv.codes

        def masked(s, lo, hi):
            return s.masked_fill_(~valid[lo:hi][None, :], NEG_INF)

        try:
            decoded = self._decoded_cache()
            dec_sq = self._pq_decoded_sq
            return lambda lo, hi: masked(_decoded_scan_scores(
                queries, decoded[lo:hi], dec_sq[lo:hi], simf), lo, hi)
        except CircuitBreakerException:  # memory-tight: codes only
            pass
        codes_sq = None
        if _fused_scan_ok(queries.shape[0]):
            try:
                codes_sq = self._codes_sq()
            except CircuitBreakerException:
                codes_sq = None  # not even 4 bytes per row: the LUT rung
        if codes_sq is None:
            luts = seg.pqv.build_query_luts(queries, simf)
            return lambda lo, hi: adc_scan(luts, codes[lo:hi], simf,
                                           valid[lo:hi])
        q_c = queries - pq.center
        if simf is SimilarityFunction.COSINE:
            q_c = q_c * torch.rsqrt(torch.sum(q_c * q_c, -1, keepdim=True)
                                    + 1e-30)
        q2 = torch.sum(q_c * q_c, -1)

        def fused(lo, hi):
            ip = decode_scan(q_c, codes[lo:hi], pq.codebooks)
            if simf is SimilarityFunction.EUCLIDEAN:
                return masked(_euclidean_fold(q2, codes_sq[lo:hi], ip),
                              lo, hi)
            return masked(ip.add_(1.0).div_(2.0), lo, hi)

        return fused

    def _tiered_search(self, queries, q_host: np.ndarray,
                       params: SearchParams, accept, filtered: bool,
                       force_scan: bool) -> QueryResult:
        """on_disk search: approximate phase on the device (scan or beam
        tier), fp32 rows paged from the host row store, exact rerank on the
        host. `force_scan` pins flat segments to the scan tier."""
        seg = self.seg
        r = max(params.k * params.overquery_factor, params.k)
        qn = queries.shape[0]
        t0 = time.monotonic()
        with phase("query", stats=self.stats):
            with record_function("approximate"):
                cand_ids, approx, visited, expanded = self._approximate(
                    queries, params, accept, r, force_scan)
            qualify = cand_ids >= 0
            if params.rerank_floor > 0.0:
                qualify &= approx >= params.rerank_floor
            flat_ids = cand_ids.reshape(-1)
            with record_function("rerank_gather"):
                seg.row_store.prefetch(flat_ids)
                rows = seg.row_store.gather(flat_ids).reshape(qn, r, -1)
            with record_function("rerank_score"):
                top_i, top_s = _host_rerank(q_host, rows, cand_ids, qualify,
                                            params, seg.config.similarity)
        self.stats.increment(Counter.KNN_GRAPH_SEARCH_TIME,
                             int((time.monotonic() - t0) * 1000))
        reranked = int(qualify.sum())
        self._count(qn, filtered, visited, expanded, reranked)
        doc_ids = seg.docmap.lookup_docs(top_i)
        return QueryResult(
            doc_ids=doc_ids, scores=np.where(doc_ids >= 0, top_s, -np.inf),
            visited=visited, expanded=expanded, reranked=reranked,
        )

    def _approximate(self, queries, params: SearchParams, accept, r: int,
                     force_scan: bool):
        """The on_disk approximate phase on the device (scan or beam tier)
        -> on the host: cand_ids [Q, r] (-1 pads), approx [Q, r], visited,
        expanded."""
        seg = self.seg
        if force_scan or seg.capacity() <= self._scan_bound():
            valid = self._live_valid() if accept is None else accept
            approx, cand_ids = _blocked_scan_topr(
                self._codes_scan_fn(queries, valid), seg.capacity(), r)
            # counter semantics: the scan tier visits every scanned code
            # once per query
            cand_ids, approx, scanned = _to_host(cand_ids, approx,
                                                 valid.sum())
            cand_ids = np.where(approx > -np.inf, cand_ids, -1)
            if cand_ids.shape[1] < r:  # tiny segment: pad to r
                padw = r - cand_ids.shape[1]
                cand_ids = np.pad(cand_ids, ((0, 0), (0, padw)),
                                  constant_values=-1)
                approx = np.pad(approx, ((0, 0), (0, padw)),
                                constant_values=-np.inf)
            return cand_ids, approx, int(scanned) * queries.shape[0], 0
        source: dict = {}
        if seg.graph.upper_adjacency is not None:
            source["upper_adjacency"] = seg.graph.upper_adjacency
        try:
            source["pq_decoded"] = self._decoded_cache()
        except CircuitBreakerException:  # memory-tight: codes only
            source.update(pq_codes=seg.pqv.codes,
                          pq_codebooks=seg.pqv.pq.codebooks,
                          pq_center=seg.pqv.pq.center)
        res = searcher_mod.search(
            seg.graph.adjacency, seg.graph.live, seg.graph.entry, queries,
            dataclasses.replace(params, k=r), seg.config.similarity,
            accept=accept, **source)
        cand_ids, approx, visited, expanded = _to_host(
            res.ids, res.scores, res.visited_count.sum(),
            res.expanded_count.sum())
        return cand_ids, approx, int(visited), int(expanded)


def _host_rerank(q_host: np.ndarray, rows: np.ndarray, cand_ids: np.ndarray,
                 qualify: np.ndarray, params: SearchParams,
                 simf: SimilarityFunction):
    """Exact fp32 rerank of the gathered candidate rows [Q, r, d] on the
    host: argpartition to k, then a stable sort by score -> (ids [Q, k]
    with -1 pads, scores [Q, k])."""
    exact = host_candidate_scores(q_host, rows, simf)
    exact = np.where(qualify, exact, -np.inf)
    if params.k < exact.shape[1]:
        idx = np.argpartition(-exact, params.k - 1, axis=1)[:, : params.k]
    else:
        idx = np.broadcast_to(np.arange(exact.shape[1])[None, :],
                              exact.shape).copy()
    sel = np.take_along_axis(exact, idx, axis=1)
    idx = np.take_along_axis(idx, np.argsort(-sel, axis=1, kind="stable"),
                             axis=1)
    top_s = np.take_along_axis(exact, idx, axis=1)
    top_i = np.take_along_axis(cand_ids, idx, axis=1)
    if params.threshold > 0.0:
        keep = top_s >= params.threshold
        top_i = np.where(keep, top_i, -1)
        top_s = np.where(keep, top_s, -np.inf)
    return np.where(top_s > -np.inf, top_i, -1), top_s
