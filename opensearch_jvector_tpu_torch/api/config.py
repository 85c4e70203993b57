"""Index/method configuration with the reference's parameter surface.

Mirrors the `disk_ann` method schema (JVectorDiskANNMethod.java:37-113) and
its defaults (KNNConstants.java:84-116). Validation rules follow the
reference's Parameter DSL bounds.
"""

from __future__ import annotations

import dataclasses

from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction

# quantization type strings (KNNConstants.java:104-107)
QUANT_NONE = "none"
QUANT_PQ = "pq"
QUANT_NVQ = "nvq+pq"  # NVQ always pairs with an aux PQ in the reference
# scalar (binary / multi-bit) quantization — the reference pairs these with
# its Lucene-engine path (quantization/quantizer/*); here they are native
# disk_ann modes: Hamming approximate phase over bit-packed codes + fp32
# rerank (thermometer coding for 2/4-bit)
QUANT_1BIT = "1bit"
QUANT_2BIT = "2bit"
QUANT_4BIT = "4bit"
SCALAR_QUANTS = (QUANT_1BIT, QUANT_2BIT, QUANT_4BIT)
SCALAR_BITS = {QUANT_1BIT: 1, QUANT_2BIT: 2, QUANT_4BIT: 4}

# defaults (KNNConstants.java:84-116, JVectorFormat.java:34-35)
DEFAULT_M = 32
DEFAULT_BEAM_WIDTH = 100  # ef_construction
DEFAULT_ALPHA = 1.2
DEFAULT_NEIGHBOR_OVERFLOW = 1.2
DEFAULT_MIN_BATCH_FOR_QUANTIZATION = 1024
DEFAULT_HIERARCHY_ENABLED = False
DEFAULT_QUANTIZATION = QUANT_PQ
DEFAULT_NVQ_SUBVECTORS = 2
DEFAULT_LEADING_MERGE_DISABLED = False

# query-time defaults (KNNConstants.java:90-93)
DEFAULT_OVERQUERY_FACTOR = 5
DEFAULT_THRESHOLD = 0.0
DEFAULT_RERANK_FLOOR = 0.0
DEFAULT_USE_PRUNING = False  # accepted, not yet wired (reference TODO too)


class ValidationError(ValueError):
    pass


@dataclasses.dataclass
class DiskAnnConfig:
    """Per-field index configuration (the resolved disk_ann method)."""

    dim: int
    similarity: SimilarityFunction = SimilarityFunction.EUCLIDEAN
    m: int = DEFAULT_M
    ef_construction: int = DEFAULT_BEAM_WIDTH
    alpha: float = DEFAULT_ALPHA
    neighbor_overflow: float = DEFAULT_NEIGHBOR_OVERFLOW
    hierarchy_enabled: bool = DEFAULT_HIERARCHY_ENABLED
    min_batch_size_for_quantization: int = DEFAULT_MIN_BATCH_FOR_QUANTIZATION
    num_pq_subspaces: int | None = None  # None -> dimension-adaptive default
    # Anisotropic (score-aware) PQ training, ScaNN-style (beyond-reference
    # extension, named in BASELINE config 4): quantization error parallel
    # to the data point is weighted by eta = (d-1) T^2/(1-T^2). None/0 ->
    # plain UNWEIGHTED k-means (reference behavior). Best for
    # inner-product / cosine corpora.
    pq_anisotropic_threshold: float | None = None
    quantization_type: str = DEFAULT_QUANTIZATION
    nvq_num_subvectors: int = DEFAULT_NVQ_SUBVECTORS
    leading_segment_merge_disabled: bool = DEFAULT_LEADING_MERGE_DISABLED
    # Mode parity (Mode.java:22-34): in_memory keeps fp32 rows in HBM;
    # on_disk keeps only graph + PQ codes in HBM and pages fp32 rows from
    # the native host-tier store for the rerank phase.
    mode: str = "in_memory"
    # Index structure: "vamana" builds the DiskANN graph; "flat" skips the
    # graph entirely and serves every query through the MXU scan tier
    # (FlatVectorFieldMapper parity — the reference's no-index flat vector
    # type, mapper/FlatVectorFieldMapper; on TPU the flat tier is a
    # first-class production path because a dense bf16 scan at batch
    # saturates the MXU and beats graph traversal well past 1M codes).
    index_type: str = "vamana"

    def __post_init__(self):
        if self.mode not in ("in_memory", "on_disk"):
            raise ValidationError(
                f"mode must be in_memory|on_disk: {self.mode}"
            )
        if self.index_type not in ("vamana", "flat"):
            raise ValidationError(
                f"index_type must be vamana|flat: {self.index_type}"
            )
        if self.index_type == "flat" and self.quantization_type not in (
            QUANT_NONE, QUANT_PQ,
        ):
            raise ValidationError(
                "flat index_type supports none|pq quantization (the scan "
                f"tier scores ADC or exact): {self.quantization_type}"
            )
        if self.mode == "on_disk" and self.quantization_type == QUANT_NONE:
            raise ValidationError(
                "on_disk mode requires quantization (the approximate phase "
                "runs over PQ codes; fp32 rows stay on the host tier)"
            )
        if self.dim <= 0 or self.dim > 16000:
            raise ValidationError(f"dimension must be in (0, 16000]: {self.dim}")
        if not 1 <= self.m <= 512:
            raise ValidationError(f"m must be in [1, 512]: {self.m}")
        if not 1 <= self.ef_construction <= 10_000:
            raise ValidationError(
                f"ef_construction must be in [1, 10000]: {self.ef_construction}"
            )
        if self.alpha < 1.0:
            raise ValidationError(f"alpha must be >= 1.0: {self.alpha}")
        if self.neighbor_overflow < 1.0:
            raise ValidationError(
                f"neighbor_overflow must be >= 1.0: {self.neighbor_overflow}"
            )
        allowed = (QUANT_NONE, QUANT_PQ, QUANT_NVQ) + SCALAR_QUANTS
        if self.quantization_type not in allowed:
            raise ValidationError(
                f"quantization_type must be one of {'|'.join(allowed)}: "
                f"{self.quantization_type}"
            )
        if (self.mode == "on_disk"
                and self.quantization_type in SCALAR_QUANTS):
            raise ValidationError(
                "on_disk mode requires pq/nvq+pq quantization (the host "
                "tier pages rows against an ADC approximate phase)"
            )
        if self.nvq_num_subvectors < 1:
            raise ValidationError("nvq.num_subvectors must be >= 1")
        if self.pq_anisotropic_threshold is not None and not (
            0.0 <= self.pq_anisotropic_threshold < 1.0
        ):
            raise ValidationError(
                "pq_anisotropic_threshold must be in [0, 1) (0 disables): "
                f"{self.pq_anisotropic_threshold}"
            )
        if self.min_batch_size_for_quantization < 1:
            raise ValidationError("min_batch_size_for_quantization must be >= 1")

    def to_meta(self) -> dict:
        d = dataclasses.asdict(self)
        d["similarity"] = self.similarity.value
        return d

    @staticmethod
    def from_meta(meta: dict) -> "DiskAnnConfig":
        meta = dict(meta)
        meta["similarity"] = SimilarityFunction(meta["similarity"])
        return DiskAnnConfig(**meta)


@dataclasses.dataclass
class SearchConfig:
    """Query-time parameters (JVectorDiskANNSearchContext.java:22-42)."""

    k: int
    ef_search: int | None = None  # None -> max(k * overquery, 100)
    overquery_factor: int = DEFAULT_OVERQUERY_FACTOR
    threshold: float = DEFAULT_THRESHOLD
    rerank_floor: float = DEFAULT_RERANK_FLOOR
    use_pruning: bool = DEFAULT_USE_PRUNING

    def __post_init__(self):
        if not 1 <= self.k <= 10_000:  # KNNQueryBuilder.java:83 (k <= 10000)
            raise ValidationError(f"k must be in [1, 10000]: {self.k}")
        if self.overquery_factor < 1:
            raise ValidationError("overquery_factor must be >= 1")

    def resolved_ef(self) -> int:
        return self.ef_search or max(self.k * self.overquery_factor, 100)
