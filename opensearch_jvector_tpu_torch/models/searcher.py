"""Batched Vamana beam search (the query-time and build-time hot loop).

Port of `opensearch_jvector_tpu/models/searcher.py`. A whole batch of
queries walks the graph together:
  * per query a candidate pool of `L` (ef_search) that doubles as a running
    deduplicated top-L of everything scored;
  * `E` expansions per iteration, a visited ring of `max_iters * E`
    expanded ids, and an `active` mask; a query stops when its pool holds
    no unexpanded candidate or the iteration budget is spent;
  * results are the accepted & live top-R of the pool;
  * with a hierarchy layer, a short beam over the coarse upper graph first
    picks each query's own base-layer entry point;
  * the rerank phase rescores the R survivors exactly (fp32 rows, or
    NVQ-decoded rows), after the `rerank_floor` cut on the approximate
    score; then top-k and the `threshold` cut.

Score providers (the approximate phase), chosen by what `search` is given:
  * `exact`: fp32 rows (`vectors`); nothing to rerank;
  * `pq_decoded`: exact scoring over the bf16 decoded-PQ cache with bf16
    queries (float32 products);
  * `pq`: codes only — the candidates' codebook rows are gathered
    (decode) and scored against the centered (cosine: normalized)
    queries;
  * `scalar`: Hamming scores of bit-packed 1/2/4-bit codes against the
    queries' own codes.
The approximate providers rerank on the device when a rerank source is
given (`nvq`, `rerank_vectors` or `vectors`); without one their scores are
returned as they are (the on_disk tier reranks on the host, the graph
build prunes on fp32 rows).

Counters follow `SearchResult`: nodes scored (visited), nodes expanded on
both layers, on the base layer alone, and candidates reranked.

The walk itself (`ops/beam_kernel.py`) is one launch of a hand-written
CUDA kernel for the row providers (`exact` and `pq_decoded`, objects that
expose their rows and prepared queries) on a CUDA device, where the
reference runs one compiled `while_loop`; the codes providers (`pq`,
`scalar`) and every CPU search walk in its plain version, a loop of tensor
operations. There, deduplication of new neighbors against the pool, the
visited ring and each other is one per-row sort instead of the
reference's pairwise equality masks: [Q, L + V + E*M] keys rather than
[Q, E*M, L + V] booleans, with the same result.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from opensearch_jvector_tpu_torch.models.nvq import NVQVectors
from opensearch_jvector_tpu_torch.models.scalar import thermometer_codes
from opensearch_jvector_tpu_torch.ops import beam_kernel
from opensearch_jvector_tpu_torch.ops.beam_kernel import _first_topk
from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    _normalize,
    batched_candidate_scores,
    hamming_scores,
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

    def resolved_iters(self) -> int:
        """Beam iterations `search` runs at most: `max_iters`, else enough
        for E expansions an iteration to cover the pool of
        max(ef_search, k * overquery_factor) (at least 8)."""
        ef = max(self.ef_search, self.k * self.overquery_factor, self.k)
        e = self.expansions_per_iter
        return self.max_iters or max(8, -(-ef // e))


@dataclasses.dataclass
class SearchResult:
    """Batched results + per-query counters."""

    ids: torch.Tensor  # [Q, k] int64 (-1 pad)
    scores: torch.Tensor  # [Q, k] f32 (-inf pad)
    visited_count: torch.Tensor  # [Q] nodes scored
    expanded_count: torch.Tensor  # [Q] nodes expanded (all layers)
    reranked_count: torch.Tensor  # [Q]
    expanded_base_count: torch.Tensor  # [Q] base layer only


ScoreFn = Callable[[torch.Tensor], torch.Tensor]  # ids [Q, C] -> [Q, C]


class RowProvider:
    """A provider that scores candidate rows of a row matrix: callable as a
    `ScoreFn`, and it exposes what the beam kernel
    (`ops.beam_kernel.beam_search`) reads instead: `rows` [N, d] (float32,
    or the bf16 decoded cache), `simf`, `rounded` (squared and inverse
    norms are rounded to the rows' dtype) and `prepared()` -> (queries
    [Q, d] float32 as the formula uses them, their squared norms [Q])."""

    rows: torch.Tensor
    simf: SimilarityFunction
    rounded: bool = False

    def prepared(self) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class ExactProvider(RowProvider):
    """Exact scoring of candidate rows of `vectors` against `queries`."""

    def __init__(self, queries: torch.Tensor, vectors: torch.Tensor,
                 simf: SimilarityFunction):
        self.queries, self.rows, self.simf = queries, vectors, simf
        self._prepared = None

    def prepared(self):
        if self._prepared is None:
            q = self.queries
            if self.simf is SimilarityFunction.COSINE:
                q = _normalize(q)
            self._prepared = (q, torch.sum(q * q, -1))
        return self._prepared

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        return batched_candidate_scores(
            self.queries, self.rows[ids.clamp(min=0)], self.simf)



def _to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).float()


class PQDecodedProvider(RowProvider):
    """Scoring over the decoded cache (it holds the center): bf16 queries
    against bf16 rows, float32 products and sums. Squared norms (and, for
    cosine, inverse norms) are rounded to the cache dtype, as the
    reference's compiled program computes them; the rest stays float32."""

    def __init__(self, queries: torch.Tensor, decoded: torch.Tensor,
                 simf: SimilarityFunction):
        self.rows, self.simf = decoded, simf
        self.rounded = decoded.dtype != torch.float32
        q = _to_cache_dtype(queries, decoded.dtype)
        if simf is SimilarityFunction.COSINE:
            q = self._unit(q)
        self.q, self.q2 = q, self._sq(q)

    def _sq(self, x):  # rounded squared norm, keepdim
        return _to_cache_dtype(torch.sum(x * x, -1, keepdim=True),
                               self.rows.dtype)

    def _unit(self, x):
        return x * _to_cache_dtype(torch.rsqrt(self._sq(x) + 1e-30),
                                   self.rows.dtype)

    def prepared(self):
        return self.q, self.q2[:, 0]

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        c = self.rows[ids.clamp(min=0)].float()  # [Q, C, d]
        if self.simf is SimilarityFunction.COSINE:
            c = self._unit(c)
        dot = torch.bmm(c, self.q.unsqueeze(-1)).squeeze(-1)
        if self.simf is SimilarityFunction.EUCLIDEAN:
            d2 = torch.clamp(self.q2 + self._sq(c).squeeze(-1) - 2.0 * dot,
                             min=0.0)
            return 1.0 / (1.0 + d2)
        return (1.0 + dot) / 2.0



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


def hamming_provider(queries: torch.Tensor, codes: torch.Tensor,
                     thresholds: torch.Tensor) -> ScoreFn:
    """Hamming scoring for scalar (1/2/4-bit) quantization: the queries
    are coded against `thresholds` exactly as the stored rows were, then
    each candidate's packed code is XORed with its query's and the set
    bits counted; score = 1/(1+distance)."""
    qcodes = thermometer_codes(queries, thresholds).unsqueeze(1)  # [Q, 1, B]

    def score(ids: torch.Tensor) -> torch.Tensor:
        return hamming_scores(qcodes, codes[ids.clamp(min=0)])

    return score


def beam_search(
    adjacency: torch.Tensor,  # [N, M] int32
    live: torch.Tensor,  # [N] bool
    entry: int | torch.Tensor,  # shared, or one per query ([Q] int64)
    score: ScoreFn,  # the approximate phase's provider
    q: int,  # number of queries
    accept: torch.Tensor,  # [N] bool result filter
    L: int,
    E: int,
    R: int,
    max_iters: int,
    masked_results: bool = True,  # False -> skip the accept/live mask
    first_among_ties: bool = False,  # select like the reference where
    # scores tie in long runs (Hamming): the lower slot wins
):
    """Batched best-first graph search scoring through `score`.

    Returns (res_ids [Q,R] int64, res_scores [Q,R], visited [Q],
    expanded [Q]). Tombstoned nodes stay traversable (the reference's
    markNodeDeleted -> cleanup semantics); they are masked out of the
    results through `accept & live`. A row provider (`ExactProvider`,
    `PQDecodedProvider`) walks in the beam kernel (one launch on a CUDA
    device, its plain version on the CPU); the codes providers walk in the
    plain loop.
    """
    if isinstance(score, RowProvider):
        cand_ids, cand_scores, visited_n, expanded_n = beam_kernel.beam_search(
            adjacency, entry, score, q, L, E, max_iters)
    else:
        cand_ids, cand_scores, visited_n, expanded_n = (
            beam_kernel.beam_search_reference(
                adjacency, entry, score, q, L, E, max_iters,
                first_among_ties=first_among_ties))
    topk = _first_topk if first_among_ties else (
        lambda x, k: torch.topk(x, k, dim=1))

    # ---- results: accepted & live top-R of the pool ---------------------
    if masked_results:
        safe = cand_ids.clamp(min=0)
        ok = accept[safe] & live[safe] & (cand_ids >= 0)
        pool_scores = torch.where(ok, cand_scores, NEG_INF)
    else:
        pool_scores = cand_scores
    res_scores, idx = topk(pool_scores, R)
    res_ids = torch.where(res_scores > NEG_INF,
                          torch.gather(cand_ids, 1, idx), -1)
    return res_ids, res_scores, visited_n, expanded_n


# The hierarchy descent: a short beam over the upper layer (pool, expansions
# per iteration, iterations), as the reference runs it.
UPPER_POOL, UPPER_EXPANSIONS, UPPER_ITERS = 16, 4, 8


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
    rerank_vectors: torch.Tensor | None = None,  # override rerank source
    nvq: NVQVectors | None = None,  # rerank source decoded row by row
    has_tombstones: bool = True,  # False -> skip result masking when
    # unfiltered (clean graph: every pool entry is live)
    upper_adjacency: torch.Tensor | None = None,  # hierarchy layer
    scalar_codes: torch.Tensor | None = None,  # [N, B] uint8 packed codes
    scalar_thresholds: torch.Tensor | None = None,  # [levels, d] f32
) -> SearchResult:
    """Two-phase search over one graph segment.

    The approximate phase scores with the decoded cache when it is given,
    else PQ codes, else scalar codes, else exact `vectors`. The rerank
    phase rescores the top `k * overquery_factor` survivors exactly from
    `nvq` (PQ codes only), else `rerank_vectors`, else `vectors`, after
    the `rerank_floor` cut; without a source the approximate scores
    stand. Then top-k and the `threshold` cut."""
    rerank_src = None
    ties = False
    if pq_decoded is not None or pq_codes is not None:
        if pq_decoded is not None:
            score = PQDecodedProvider(queries, pq_decoded, simf)
        else:
            score = pq_provider(queries, pq_codes, pq_codebooks, pq_center,
                                simf)
            if nvq is not None:
                rerank_src = nvq.decode_rows
        if rerank_src is None:
            rows = rerank_vectors if rerank_vectors is not None else vectors
            if rows is not None:
                rerank_src = lambda ids: rows[ids]  # noqa: E731
    elif scalar_codes is not None:
        score = hamming_provider(queries, scalar_codes, scalar_thresholds)
        ties = True  # a few hundred distinct scores at most
        rerank_src = lambda ids: vectors[ids]  # noqa: E731
    else:
        score = ExactProvider(queries, vectors, simf)
    masked_results = (accept is not None) or has_tombstones
    if accept is None:
        accept = live
    qn = queries.shape[0]
    r = max(params.k * params.overquery_factor, params.k)
    ef = max(params.ef_search, r)
    e = params.expansions_per_iter
    iters = params.resolved_iters()

    upper_expanded = 0
    if upper_adjacency is not None:
        # hierarchy layer: a short beam on the coarse graph picks each
        # query's base-layer entry point (HNSW-style descent)
        up_ids, _, _, upper_expanded = beam_search(
            upper_adjacency, live, entry, score, qn, accept,
            L=UPPER_POOL, E=UPPER_EXPANSIONS, R=1, max_iters=UPPER_ITERS,
            masked_results=False, first_among_ties=ties)
        entry = torch.where(up_ids[:, 0] >= 0, up_ids[:, 0], entry)
    res_ids, res_scores, visited, base_expanded = beam_search(
        adjacency, live, entry, score, qn, accept,
        L=ef, E=e, R=r, max_iters=iters, masked_results=masked_results,
        first_among_ties=ties,
    )

    if rerank_src is not None:
        qualify = res_ids >= 0
        if params.rerank_floor > 0.0:  # 0.0 == disabled (reference default)
            qualify &= res_scores >= params.rerank_floor
        exact = batched_candidate_scores(
            queries, rerank_src(res_ids.clamp(min=0)).float(), simf)
        res_scores = torch.where(qualify, exact, NEG_INF)
        reranked = qualify.sum(1, dtype=torch.int32)
    else:
        reranked = torch.zeros_like(visited)
    final_scores, final_ids = topk_scores(res_scores, res_ids, params.k)
    keep = final_scores > NEG_INF
    if params.threshold > 0.0:  # 0.0 == disabled (reference default)
        keep &= final_scores >= params.threshold
    return SearchResult(
        ids=torch.where(keep, final_ids, -1),
        scores=torch.where(keep, final_scores, NEG_INF),
        visited_count=visited,
        expanded_count=base_expanded + upper_expanded,
        reranked_count=reranked,
        expanded_base_count=base_expanded,
    )
