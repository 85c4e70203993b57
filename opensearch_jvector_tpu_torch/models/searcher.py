"""Batched Vamana beam search (the query-time and build-time hot loop).

Port of `opensearch_jvector_tpu/models/searcher.py`. A whole batch of
queries walks the graph together:
  * per query a candidate pool of `L` (ef_search) that doubles as a running
    deduplicated top-L of everything scored;
  * `E` expansions per iteration, a visited ring of `max_iters * E`
    expanded ids, and an `active` mask; a query stops when its pool holds
    no unexpanded candidate or the iteration budget is spent;
  * results are the accepted & live top-R of the pool, then top-k with the
    `threshold` cut.

Score providers (the approximate phase), chosen by what `search` is given:
  * `exact`: fp32 rows (`vectors`);
  * `pq_decoded`: exact scoring over the bf16 decoded-PQ cache with bf16
    queries (float32 products);
  * `pq`: codes only — the candidates' codebook rows are gathered
    (decode) and scored against the centered (cosine: normalized)
    queries.
The two PQ providers return approximate scores: their callers rerank
(the on_disk tier on the host) or use them as they are (graph build).
The device rerank of PQ candidates against fp32 rows, the Hamming and
NVQ providers and the hierarchy entry stage wait (ROADMAP queue 1,
"on_disk remnants" and "Other quantizers").

Counters follow `SearchResult`: nodes scored (visited), nodes expanded,
nodes reranked (always 0 here: no provider reranks on the device yet).

Deduplication of new neighbors against the pool, the visited ring and
each other is one per-row sort instead of the reference's pairwise
equality masks: [Q, L + V + E*M] keys rather than [Q, E*M, L + V] booleans,
with the same result.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    batched_candidate_scores,
)
from opensearch_jvector_tpu_torch.ops.topk import topk_scores

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Search configuration."""

    k: int
    ef_search: int = 100  # candidate pool size L
    overquery_factor: int = 5  # result pool R = k * overquery_factor
    expansions_per_iter: int = 16  # E: beam widening factor
    max_iters: int = 0  # 0 -> derived from ef_search
    threshold: float = 0.0  # similarity cutoff on final results
    rerank_floor: float = 0.0  # approx-score floor to qualify for rerank
    # (read by the scan tier's rerank, index/reader.py)


@dataclasses.dataclass
class SearchResult:
    """Batched results + per-query counters."""

    ids: torch.Tensor  # [Q, k] int64 (-1 pad)
    scores: torch.Tensor  # [Q, k] f32 (-inf pad)
    visited_count: torch.Tensor  # [Q] nodes scored
    expanded_count: torch.Tensor  # [Q] nodes expanded
    reranked_count: torch.Tensor  # [Q]


def _new_neighbors(nb: torch.Tensor, pool: torch.Tensor,
                   visited: torch.Tensor) -> torch.Tensor:
    """[Q, C] mask: nb >= 0, not in pool [Q, L], not in visited [Q, V],
    and the first occurrence of its id within nb.

    Sorts (id, column) keys per row with pool and visited columns first:
    an nb entry survives iff it leads its id's run."""
    x = torch.cat([pool, visited, nb], dim=1)
    w = x.shape[1]
    col = torch.arange(w, device=x.device)
    key = torch.where(x >= 0, x * w + col, -1)
    sk, order = torch.sort(key, dim=1)
    sid = torch.where(sk >= 0, sk // w, -1)
    lead = torch.ones_like(sid, dtype=torch.bool)
    lead[:, 1:] = sid[:, 1:] != sid[:, :-1]
    lead_x = torch.empty_like(lead).scatter_(1, order, lead)
    return lead_x[:, w - nb.shape[1]:] & (nb >= 0)


ScoreFn = Callable[[torch.Tensor], torch.Tensor]  # ids [Q, C] -> [Q, C]


def exact_provider(queries: torch.Tensor, vectors: torch.Tensor,
                   simf: SimilarityFunction) -> ScoreFn:
    """Exact scoring of candidate rows of `vectors` against `queries`."""

    def score(ids: torch.Tensor) -> torch.Tensor:
        return batched_candidate_scores(queries, vectors[ids.clamp(min=0)],
                                        simf)

    return score


def _to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).float()


def pq_decoded_provider(queries: torch.Tensor, decoded: torch.Tensor,
                        simf: SimilarityFunction) -> ScoreFn:
    """Scoring over the decoded cache (it holds the center): bf16 queries
    against bf16 rows, float32 products and sums. Squared norms (and, for
    cosine, inverse norms) are rounded to the cache dtype, as the
    reference's compiled program computes them; the rest stays float32."""
    dt = decoded.dtype

    def sq(x):  # rounded squared norm, keepdim
        return _to_cache_dtype(torch.sum(x * x, -1, keepdim=True), dt)

    def unit(x):
        return x * _to_cache_dtype(torch.rsqrt(sq(x) + 1e-30), dt)

    q = _to_cache_dtype(queries, dt)
    if simf is SimilarityFunction.COSINE:
        q = unit(q)
    q2 = sq(q)

    def score(ids: torch.Tensor) -> torch.Tensor:
        c = decoded[ids.clamp(min=0)].float()  # [Q, C, d]
        if simf is SimilarityFunction.COSINE:
            c = unit(c)
        dot = torch.bmm(c, q.unsqueeze(-1)).squeeze(-1)
        if simf is SimilarityFunction.EUCLIDEAN:
            d2 = torch.clamp(q2 + sq(c).squeeze(-1) - 2.0 * dot, min=0.0)
            return 1.0 / (1.0 + d2)
        return (1.0 + dot) / 2.0

    return score


def pq_provider(queries: torch.Tensor, codes: torch.Tensor,
                codebooks: torch.Tensor, center: torch.Tensor | None,
                simf: SimilarityFunction) -> ScoreFn:
    """Codes-only scoring: gather the candidates' codebook rows (decode
    without the center) and score them against the centered queries;
    cosine corpora are encoded normalized, so cosine scores as a plain dot
    of normalized queries."""
    q = queries if center is None else queries - center
    score_simf = simf
    if simf is SimilarityFunction.COSINE:
        q = q * torch.rsqrt(torch.sum(q * q, -1, keepdim=True) + 1e-30)
        score_simf = SimilarityFunction.DOT_PRODUCT
    sub = torch.arange(codebooks.shape[0], device=codes.device)

    def score(ids: torch.Tensor) -> torch.Tensor:
        c = codes[ids.clamp(min=0)].long()  # [Q, C, M]
        dec = codebooks[sub, c].reshape(*ids.shape, -1)  # [Q, C, d]
        return batched_candidate_scores(q, dec, score_simf)

    return score


def beam_search(
    adjacency: torch.Tensor,  # [N, M] int32
    live: torch.Tensor,  # [N] bool
    entry: int,
    score: ScoreFn,  # the approximate phase's provider
    q: int,  # number of queries
    accept: torch.Tensor,  # [N] bool result filter
    L: int,
    E: int,
    R: int,
    max_iters: int,
    masked_results: bool = True,  # False -> skip the accept/live mask
):
    """Batched best-first graph search scoring through `score`.

    Returns (res_ids [Q,R] int64, res_scores [Q,R], visited [Q],
    expanded [Q]). Tombstoned nodes stay traversable (the reference's
    markNodeDeleted -> cleanup semantics); they are masked out of the
    results through `accept & live`.
    """
    dev = adjacency.device
    m = adjacency.shape[1]
    rows = torch.arange(q, device=dev)

    cand_ids = torch.full((q, L), -1, dtype=torch.long, device=dev)
    cand_ids[:, 0] = int(entry)
    cand_scores = torch.full((q, L), NEG_INF, device=dev)
    cand_scores[:, 0] = score(cand_ids[:, :1])[:, 0]
    cand_expanded = torch.zeros((q, L), dtype=torch.bool, device=dev)
    visited_buf = torch.full((q, max_iters * E), -1, dtype=torch.long,
                             device=dev)
    visited_n = torch.ones((q,), dtype=torch.int32, device=dev)
    expanded_n = torch.zeros((q,), dtype=torch.int32, device=dev)
    active = torch.ones((q,), dtype=torch.bool, device=dev)

    it = 0
    while it < max_iters and bool(active.any()):
        # ---- pick top-E unexpanded candidates per query ----------------
        pickable = ~cand_expanded & (cand_ids >= 0)
        top_s, slots = torch.topk(
            torch.where(pickable, cand_scores, NEG_INF), E, dim=1)
        picked_ids = torch.gather(cand_ids, 1, slots)
        q_active = active & (top_s[:, 0] > NEG_INF)
        picked_valid = (top_s > NEG_INF) & q_active[:, None]
        cand_expanded[rows[:, None], slots] |= picked_valid
        visited_buf[:, it * E:(it + 1) * E] = torch.where(
            picked_valid, picked_ids, -1)
        expanded_n += picked_valid.sum(1, dtype=torch.int32)

        # ---- gather + dedup neighbors ----------------------------------
        nb = adjacency[picked_ids.clamp(min=0)].long()  # [Q, E, M]
        nb = torch.where(picked_valid[:, :, None], nb, -1).reshape(q, E * m)
        nb_valid = _new_neighbors(nb, cand_ids, visited_buf)
        nb = torch.where(nb_valid, nb, -1)

        # ---- score new candidates, merge into the pool (top-L) ---------
        nb_scores = torch.where(nb_valid, score(nb), NEG_INF)
        visited_n += nb_valid.sum(1, dtype=torch.int32)
        cand_scores, idx = torch.topk(
            torch.cat([cand_scores, nb_scores], 1), L, dim=1)
        cand_ids = torch.gather(torch.cat([cand_ids, nb], 1), 1, idx)
        cand_expanded = torch.gather(
            torch.cat([cand_expanded, torch.zeros_like(nb_valid)], 1), 1, idx)
        active = q_active
        it += 1

    # ---- results: accepted & live top-R of the pool ---------------------
    if masked_results:
        safe = cand_ids.clamp(min=0)
        ok = accept[safe] & live[safe] & (cand_ids >= 0)
        pool_scores = torch.where(ok, cand_scores, NEG_INF)
    else:
        pool_scores = cand_scores
    res_scores, res_ids = topk_scores(pool_scores, cand_ids, R)
    res_ids = torch.where(res_scores > NEG_INF, res_ids, -1)
    return res_ids, res_scores, visited_n, expanded_n


def search(
    adjacency: torch.Tensor,
    live: torch.Tensor,
    entry: int,
    queries: torch.Tensor,  # [Q, d] f32
    params: SearchParams,
    simf: SimilarityFunction,
    *,
    vectors: torch.Tensor | None = None,  # [N, d] exact storage
    pq_codes: torch.Tensor | None = None,  # [N, M] uint8 PQ codes
    pq_codebooks: torch.Tensor | None = None,  # [M, K, dsub]
    pq_center: torch.Tensor | None = None,  # [d] (EUCLIDEAN centering)
    pq_decoded: torch.Tensor | None = None,  # [N, d] bf16 decoded-PQ cache
    accept: torch.Tensor | None = None,  # [N] bool result filter
    has_tombstones: bool = True,  # False -> skip result masking when
    # unfiltered (clean graph: every pool entry is live)
) -> SearchResult:
    """Search over one graph segment, then the top-k and the `threshold`
    cut. The provider is `pq_decoded` when the decoded cache is given,
    else `pq` when codes are, else `exact` over `vectors`; PQ scores are
    returned as they are (no device rerank: `rerank_src == "none"`)."""
    if pq_decoded is not None or pq_codes is not None:
        if vectors is not None:
            raise NotImplementedError(
                "the device rerank of PQ candidates against fp32 rows is "
                'not ported yet (ROADMAP queue 1, "on_disk remnants")')
        if pq_decoded is not None:
            score = pq_decoded_provider(queries, pq_decoded, simf)
        else:
            score = pq_provider(queries, pq_codes, pq_codebooks, pq_center,
                                simf)
    else:
        score = exact_provider(queries, vectors, simf)
    masked_results = (accept is not None) or has_tombstones
    if accept is None:
        accept = live
    r = max(params.k * params.overquery_factor, params.k)
    ef = max(params.ef_search, r)
    e = params.expansions_per_iter
    iters = params.max_iters or max(8, (ef + e - 1) // e)
    res_ids, res_scores, visited, expanded = beam_search(
        adjacency, live, entry, score, queries.shape[0], accept,
        L=ef, E=e, R=r, max_iters=iters, masked_results=masked_results,
    )
    final_scores, final_ids = topk_scores(res_scores, res_ids, params.k)
    keep = final_scores > NEG_INF
    if params.threshold > 0.0:  # 0.0 == disabled (reference default)
        keep &= final_scores >= params.threshold
    return SearchResult(
        ids=torch.where(keep, final_ids, -1),
        scores=torch.where(keep, final_scores, NEG_INF),
        visited_count=visited,
        expanded_count=expanded,
        reranked_count=torch.zeros_like(visited),
    )
