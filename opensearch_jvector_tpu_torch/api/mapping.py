"""Field-mapping layer: `knn_vector` mapping -> resolved index config.

Copy of `opensearch_jvector_tpu/api/mapping.py`
(host-only code; the port keeps its own so that it imports nothing of
the JAX package).

Mirrors the reference's mapper stack (index/mapper/KNNVectorFieldMapper:
type "knn_vector" with dimension / space_type / mode / method tree;
method resolution fills engine + parameter defaults at mapping-parse time,
KNNVectorFieldMapper.java:349-357,474). The method parameter names and
defaults follow JVectorDiskANNMethod.java:37-113 and KNNConstants.java.
"""

from __future__ import annotations

from opensearch_jvector_tpu_torch.api.config import (
    DiskAnnConfig,
    ValidationError,
)
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction

# SpaceType -> engine similarity. L1/LINF exist in the method's declared
# spaces but the engine rejects them at build time, exactly like the
# reference (JVectorDiskANNMethod.java:26-33 lists them; the writer's
# similarity mapping throws, JVectorWriter.java:667-675). They remain
# available through exact/script scoring.
SPACE_TO_SIMILARITY = {
    "l2": SimilarityFunction.EUCLIDEAN,
    "cosinesimil": SimilarityFunction.COSINE,
    "innerproduct": SimilarityFunction.DOT_PRODUCT,
    "undefined": SimilarityFunction.EUCLIDEAN,
}
ENGINE_SPACES = set(SPACE_TO_SIMILARITY)
SCRIPT_ONLY_SPACES = {"l1", "linf", "hamming"}
DEFAULT_SPACE = "l2"

MODES = ("in_memory", "on_disk")  # Mode.java:22-34


def parse_knn_vector_mapping(body: dict) -> tuple[DiskAnnConfig, dict]:
    """Parse a `knn_vector` field mapping -> (config, extras).

    extras: {"mode": ..., "space_type": ...} for layers above.
    """
    if body.get("type") != "knn_vector":
        raise ValidationError(f"field type must be knn_vector: {body.get('type')}")
    if "dimension" not in body:
        raise ValidationError("knn_vector mapping requires dimension")
    dim = int(body["dimension"])

    space = str(body.get("space_type", DEFAULT_SPACE)).lower()
    if space in SCRIPT_ONLY_SPACES:
        raise ValidationError(
            f"space_type {space} is exact-scoring only; the disk_ann engine "
            f"supports {sorted(ENGINE_SPACES - {'undefined'})}"
        )
    if space not in ENGINE_SPACES:
        raise ValidationError(f"unknown space_type {space}")

    mode = str(body.get("mode", "in_memory"))
    if mode not in MODES:
        raise ValidationError(f"mode must be one of {MODES}: {mode}")

    # data_type parity: the jVector engine supports float vectors only
    # (VectorDataType.java:28 "jVector supports float data type"; byte
    # vectors throw UnsupportedOperationException in the codec —
    # KNNJVectorTests.testJVectorKnnIndex_simpleCase_withBinaryVector).
    # byte/binary are recognized-but-rejected (distinct message); anything
    # else is an unknown data type.
    data_type = str(body.get("data_type", "float")).lower()
    if data_type in ("byte", "binary"):
        raise ValidationError(
            f"data_type {data_type} is not supported by the jvector "
            f"engine (float only)"
        )
    if data_type != "float":
        raise ValidationError(
            f"unknown data_type {data_type}; supported types are "
            f"[float, byte, binary]"
        )

    # CompressionLevel parity (CompressionLevel.java:49-61 + Mode pairing):
    # "x32" style levels translate to a PQ subspace count hitting that
    # bytes-per-vector ratio, with the level's default rescore oversample
    # (x8=2.0, x16=3.0, x32=3.0, x64=5.0). x2 is rejected for PQ: one-byte
    # codes can express at most dim bytes/vector (= x4 for fp32), so a x2
    # target is unreachable and would silently snap to x4.
    compression = body.get("compression_level")
    compression_oversample = None
    compression_subspaces = None
    if compression is not None:
        lv = str(compression).lower().lstrip("x")
        if not lv.isdigit() or int(lv) not in (1, 2, 4, 8, 16, 32, 64):
            raise ValidationError(
                f"compression_level must be one of x1..x64 (powers of 2): "
                f"{compression}"
            )
        factor = int(lv)
        if factor == 2:
            raise ValidationError(
                "compression_level x2 is not expressible with PQ byte "
                "codes (minimum PQ compression is x4); use x1 or >=x4"
            )
        if factor > 1:
            target_bytes = max(1, (int(body["dimension"]) * 4) // factor)
            compression_subspaces = target_bytes
            compression_oversample = (
                5.0 if factor >= 64 else 3.0 if factor >= 16 else 2.0
            )

    method = body.get("method") or {}
    name = method.get("name", "disk_ann")
    if name not in ("disk_ann", "hnsw"):
        raise ValidationError(f"unknown method {name}")
    engine = method.get("engine", "jvector")
    if engine not in ("jvector", "jvector_tpu"):
        raise ValidationError(f"unknown engine {engine}")
    p = dict(method.get("parameters") or {})

    known = {
        "m", "ef_construction",
        "advanced.alpha", "advanced.neighbor_overflow",
        "advanced.hierarchy_enabled",
        "advanced.min_batch_size_for_quantization",
        "advanced.num_pq_subspaces", "advanced.quantization_type",
        "advanced.nvq.num_subvectors",
        "advanced.leading_segment_merge_disabled",
        "advanced.pq_anisotropic_threshold",
    }
    unknown = set(p) - known
    if unknown:
        raise ValidationError(f"unknown method parameters: {sorted(unknown)}")

    kwargs = dict(dim=dim, similarity=SPACE_TO_SIMILARITY[space], mode=mode)
    if compression_subspaces is not None:
        m_sub = compression_subspaces
        while dim % m_sub != 0:  # subspaces must tile the dimension
            m_sub -= 1
        kwargs["num_pq_subspaces"] = max(1, m_sub)
        kwargs["quantization_type"] = "pq"
    if "m" in p:
        kwargs["m"] = int(p["m"])
    if "ef_construction" in p:
        kwargs["ef_construction"] = int(p["ef_construction"])
    if "advanced.alpha" in p:
        kwargs["alpha"] = float(p["advanced.alpha"])
    if "advanced.neighbor_overflow" in p:
        kwargs["neighbor_overflow"] = float(p["advanced.neighbor_overflow"])
    if "advanced.hierarchy_enabled" in p:
        kwargs["hierarchy_enabled"] = bool(p["advanced.hierarchy_enabled"])
    if "advanced.min_batch_size_for_quantization" in p:
        kwargs["min_batch_size_for_quantization"] = int(
            p["advanced.min_batch_size_for_quantization"]
        )
    if "advanced.num_pq_subspaces" in p:
        kwargs["num_pq_subspaces"] = int(p["advanced.num_pq_subspaces"])
    if "advanced.quantization_type" in p:
        kwargs["quantization_type"] = str(p["advanced.quantization_type"])
    if "advanced.nvq.num_subvectors" in p:
        kwargs["nvq_num_subvectors"] = int(p["advanced.nvq.num_subvectors"])
    if "advanced.leading_segment_merge_disabled" in p:
        kwargs["leading_segment_merge_disabled"] = bool(
            p["advanced.leading_segment_merge_disabled"]
        )
    if "advanced.pq_anisotropic_threshold" in p:
        kwargs["pq_anisotropic_threshold"] = float(
            p["advanced.pq_anisotropic_threshold"]
        )
    extras = {"mode": mode, "space_type": space}
    if compression_oversample is not None:
        extras["default_rescore_oversample"] = compression_oversample
    return DiskAnnConfig(**kwargs), extras
