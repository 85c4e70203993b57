"""KNN query DSL: parse + validate (the "knn" query surface).

Copy of `opensearch_jvector_tpu/query/builder.py`
(host-only code; the port keeps its own so that it imports nothing of
the JAX package).

Mirrors `KNNQueryBuilder` / `KNNQueryBuilderParser` semantics
(KNNQueryBuilder.java:376-611): vector, k (<= 10000), filter,
ignore_unmapped, radial (max_distance | min_score), method_parameters
(ef_search, overquery_factor, advanced.threshold, advanced.rerank_floor,
advanced.use_pruning — JVectorDiskANNSearchContext.java:22-42), and
rescore {oversample_factor in [1, 100]} (RescoreContext parity).

Capability note: the reference rejects radial queries on the jVector engine
(KNNQueryBuilder.java:440-453, Lucene-engine only via RNNQueryFactory);
this engine supports radial natively (score/distance threshold search).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from opensearch_jvector_tpu_torch.api.config import (
    DEFAULT_OVERQUERY_FACTOR,
    DEFAULT_RERANK_FLOOR,
    DEFAULT_THRESHOLD,
    DEFAULT_USE_PRUNING,
    ValidationError,
)

MAX_K = 10_000  # KNNQueryBuilder.java:83
MIN_OVERSAMPLE, MAX_OVERSAMPLE = 1.0, 100.0  # RescoreContext bounds


@dataclasses.dataclass
class Rescore:
    oversample_factor: float = 2.0

    def __post_init__(self):
        if not MIN_OVERSAMPLE <= self.oversample_factor <= MAX_OVERSAMPLE:
            raise ValidationError(
                f"rescore.oversample_factor must be in "
                f"[{MIN_OVERSAMPLE}, {MAX_OVERSAMPLE}]: {self.oversample_factor}"
            )


@dataclasses.dataclass
class KnnQuery:
    """A validated knn query."""

    vector: np.ndarray
    k: int | None = None
    filter_docs: np.ndarray | None = None  # bool mask over doc space or ids
    max_distance: float | None = None  # radial by distance
    min_score: float | None = None  # radial by score
    ef_search: int | None = None
    overquery_factor: int = DEFAULT_OVERQUERY_FACTOR
    threshold: float = DEFAULT_THRESHOLD
    rerank_floor: float = DEFAULT_RERANK_FLOOR
    use_pruning: bool = DEFAULT_USE_PRUNING
    rescore: Rescore | None = None
    expand_nested_docs: bool = False
    # unmapped target field -> empty results instead of an error
    # (KNNQueryBuilder.ignoreUnmapped parity)
    ignore_unmapped: bool = False

    def __post_init__(self):
        self.vector = np.asarray(self.vector, np.float32)
        # 1-D = single query (the REST DSL shape); 2-D [Q, d] = batched
        # execution of Q query vectors under one set of parameters — the
        # engine's native batch amortization exposed at the public API
        if self.vector.ndim not in (1, 2):
            raise ValidationError("query vector must be 1-D or [Q, d] 2-D")
        modes = sum(
            x is not None for x in (self.k, self.max_distance, self.min_score)
        )
        if modes == 0:
            raise ValidationError(
                "one of k, max_distance, min_score is required"
            )
        if modes > 1:
            raise ValidationError(
                "k, max_distance and min_score are mutually exclusive"
            )
        if self.k is not None and not 1 <= self.k <= MAX_K:
            raise ValidationError(f"k must be in [1, {MAX_K}]: {self.k}")
        if self.overquery_factor < 1:
            raise ValidationError("overquery_factor must be >= 1")
        if self.ef_search is not None and self.ef_search < 1:
            raise ValidationError("ef_search must be >= 1")

    @property
    def is_radial(self) -> bool:
        return self.k is None


def parse_knn_query(body: dict) -> KnnQuery:
    """Parse the JSON-ish query DSL:

    {"vector": [...], "k": 10, "filter": <mask/ids>,
     "method_parameters": {"ef_search": ..., "overquery_factor": ...,
                           "advanced.threshold": ..., "advanced.rerank_floor":
                           ..., "advanced.use_pruning": ...},
     "rescore": {"oversample_factor": 2.0} | true,
     "max_distance": ... | "min_score": ...,
     "expand_nested_docs": bool}
    """
    known = {
        "vector", "k", "filter", "method_parameters", "rescore",
        "max_distance", "min_score", "expand_nested_docs",
        "ignore_unmapped",
    }
    unknown = set(body) - known
    if unknown:
        raise ValidationError(f"unknown knn query fields: {sorted(unknown)}")
    if "vector" not in body:
        raise ValidationError("knn query requires a vector")

    mp = dict(body.get("method_parameters") or {})
    known_mp = {
        "ef_search", "overquery_factor", "advanced.threshold",
        "advanced.rerank_floor", "advanced.use_pruning",
    }
    unknown_mp = set(mp) - known_mp
    if unknown_mp:
        raise ValidationError(
            f"unknown method_parameters: {sorted(unknown_mp)}"
        )

    rescore = body.get("rescore")
    if rescore is True:
        rescore = Rescore()
    elif isinstance(rescore, dict):
        rescore = Rescore(**rescore)
    elif rescore in (None, False):
        rescore = None
    else:
        raise ValidationError(f"bad rescore: {rescore!r}")

    return KnnQuery(
        vector=body["vector"],
        k=body.get("k"),
        filter_docs=body.get("filter"),
        max_distance=body.get("max_distance"),
        min_score=body.get("min_score"),
        ef_search=mp.get("ef_search"),
        overquery_factor=int(mp.get("overquery_factor",
                                    DEFAULT_OVERQUERY_FACTOR)),
        threshold=float(mp.get("advanced.threshold", DEFAULT_THRESHOLD)),
        rerank_floor=float(mp.get("advanced.rerank_floor",
                                  DEFAULT_RERANK_FLOOR)),
        use_pruning=bool(mp.get("advanced.use_pruning", DEFAULT_USE_PRUNING)),
        rescore=rescore,
        expand_nested_docs=bool(body.get("expand_nested_docs", False)),
        ignore_unmapped=bool(body.get("ignore_unmapped", False)),
    )
