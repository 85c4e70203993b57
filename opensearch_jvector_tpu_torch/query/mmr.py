"""MMR (maximal marginal relevance) reranking.

Port of `opensearch_jvector_tpu/query/mmr.py`. Mirrors the reference's MMR
search-pipeline pair (search/processor/mmr/): `MMROverSampleProcessor`
bumps the fetch size to `candidates` (default 3x size,
MMRSearchExtBuilder.java:127-143), then `MMRRerankProcessor` greedily
selects
    argmax (1 - diversity) * relevance - diversity * maxSimToSelected
(MMRRerankProcessor.java:201-237). The vector similarity used for the
diversity term is the index's similarity function over the hit vectors.

Here both halves are one call: `mmr_search` oversamples, reads the hit
vectors back in one bulk `get_vectors`, scores every query's candidates
against each other in one batched call on the index's device, and runs
the short greedy loop per query on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import SearchConfig, ValidationError
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.reader import QueryResult
from opensearch_jvector_tpu_torch.ops.distances import pairwise_scores

DEFAULT_DIVERSITY = 0.5  # MMRSearchExtBuilder default
DEFAULT_CANDIDATE_MULTIPLIER = 3  # candidates default 3x size


@dataclasses.dataclass
class MMRParams:
    diversity: float = DEFAULT_DIVERSITY
    candidates: int | None = None  # None -> 3 * size

    def __post_init__(self):
        if not 0.0 <= self.diversity <= 1.0:
            raise ValidationError(
                f"mmr.diversity must be in [0, 1]: {self.diversity}"
            )


def mmr_select(sims: np.ndarray, relevance: np.ndarray, size: int,
               diversity: float) -> np.ndarray:
    """Greedy MMR selection over a candidate similarity matrix sims [C, C]
    -> indices into the candidate list, [<= size]."""
    c = relevance.shape[0]
    size = min(size, c)
    lam = diversity
    selected: list[int] = []
    max_sim = np.full((c,), -np.inf)
    avail = relevance > -np.inf
    for _ in range(size):
        penal = np.where(np.isfinite(max_sim), max_sim, 0.0)
        mmr = (1.0 - lam) * relevance - lam * penal
        mmr = np.where(avail, mmr, -np.inf)
        i = int(np.argmax(mmr))
        if not avail[i] or mmr[i] == -np.inf:
            break
        selected.append(i)
        avail[i] = False
        max_sim = np.maximum(max_sim, sims[i])
    return np.asarray(selected, np.int64)


def mmr_rerank(
    candidate_vectors: torch.Tensor,  # [C, d] vectors of the hits
    relevance: np.ndarray,  # [C] relevance scores (higher better)
    size: int,
    diversity: float,
    simf,
) -> np.ndarray:
    """Greedy MMR selection -> indices into the candidate list, [size]. The
    similarities are computed on the vectors' device."""
    v = candidate_vectors.float()
    sims = pairwise_scores(v, v, simf).cpu().numpy()
    return mmr_select(sims, relevance, size, diversity)


def mmr_search(
    index: VectorIndex,
    query_vector: np.ndarray,
    size: int,
    params: MMRParams | None = None,
    sc: SearchConfig | None = None,
    vector_source: VectorIndex | None = None,
) -> QueryResult:
    """Oversampled search + MMR rerank (the full pipeline in one call).

    Batched: `query_vector` may be [d] or [Q, d]. The oversampled ANN
    search runs as one dispatch for the whole batch, the candidate vectors
    come back in one bulk `get_vectors`, and every query's candidate
    similarities come from one batched call; only the greedy selection
    loops per query on the host.

    `vector_source` (the reference's `vector_field_path`): diversity
    vectors may come from a different knn_vector field's index than the
    one searched; hits missing in the source field are excluded from the
    selection (they carry no vector to diversify against).
    """
    params = params or MMRParams()
    candidates = params.candidates or DEFAULT_CANDIDATE_MULTIPLIER * size
    sc = sc or SearchConfig(k=candidates)
    if sc.k < candidates:
        sc = dataclasses.replace(sc, k=candidates)
    res = index.search(query_vector, sc)

    qn, c = res.doc_ids.shape
    flat_ids = res.doc_ids.reshape(-1)
    if not (flat_ids >= 0).any():
        return res

    # candidate vectors read back from the segments (derived-source
    # analog: vectors are stored once, in the index) through the
    # per-segment doc->ordinal inverse: O(hits), not O(N)
    src = vector_source if vector_source is not None else index
    vecs, found = src.get_vectors(flat_ids)
    vecs = torch.as_tensor(vecs.reshape(qn, c, -1), device=src.device)
    found = found.reshape(qn, c)
    sims = pairwise_scores(vecs, vecs, src.config.similarity).cpu().numpy()

    out_ids = np.full((qn, size), -1, np.int64)
    out_scores = np.full((qn, size), -np.inf, np.float32)
    for qi in range(qn):
        ids = res.doc_ids[qi]
        valid = ids >= 0
        if not valid.any():
            continue
        rel = np.where(valid & found[qi], res.scores[qi], -np.inf)
        order = mmr_select(sims[qi], rel, size, params.diversity)
        out_ids[qi, : order.size] = ids[order]
        out_scores[qi, : order.size] = res.scores[qi][order]
    return dataclasses.replace(res, doc_ids=out_ids, scores=out_scores)
