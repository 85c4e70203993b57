"""PyTorch + CUDA port of the DiskANN vector search engine.

Mirrors the layout of `opensearch_jvector_tpu` (ops/, models/, index/,
query/, service/, grpc/, api/, utils/) so each module's counterpart sits
at the same relative path.
Plain tensor code is PyTorch; the fused ADC scan is a hand-written CUDA
kernel (`csrc/adc_scan.cu`, bound in `ops/adc_kernel.py`).

Numerics contract: every float32 matrix product in this package runs in
full float32. LUT builds, the encode argmin and the exact rerank match the
reference's `preferred_element_type=f32` paths, so TF32 is switched off for
matmuls and convolutions alike when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__all__ = [
    "DiskAnnConfig",
    "SearchConfig",
    "SimilarityFunction",
    "VectorIndex",
    "ShardedVectorIndex",
    "KnnService",
    "parse_knn_query",
    "execute_knn_query",
]


def __getattr__(name):  # lazy: the service and query layers load on use
    if name in ("DiskAnnConfig", "SearchConfig"):
        from opensearch_jvector_tpu_torch.api import config as _c

        return getattr(_c, name)
    if name == "SimilarityFunction":
        from opensearch_jvector_tpu_torch.ops.distances import (
            SimilarityFunction,
        )

        return SimilarityFunction
    if name == "VectorIndex":
        from opensearch_jvector_tpu_torch.index.index import VectorIndex

        return VectorIndex
    if name == "ShardedVectorIndex":
        from opensearch_jvector_tpu_torch.parallel.distributed import (
            ShardedVectorIndex,
        )

        return ShardedVectorIndex
    if name == "KnnService":
        from opensearch_jvector_tpu_torch.service.http import KnnService

        return KnnService
    if name == "parse_knn_query":
        from opensearch_jvector_tpu_torch.query.builder import parse_knn_query

        return parse_knn_query
    if name == "execute_knn_query":
        from opensearch_jvector_tpu_torch.query.knn import execute_knn_query

        return execute_knn_query
    raise AttributeError(name)
