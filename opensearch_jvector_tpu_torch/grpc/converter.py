"""Proto -> query-builder conversion (gRPC transport parity).

Port of `opensearch_jvector_tpu/grpc/converter.py` (host-only code). The
messages are those of `knn_query_pb2`, a byte-identical copy of the JAX
package's generated module: its serialized descriptor (proto package
`opensearch_jvector_tpu`) is the wire contract, so a client built for
either server talks to the other.

Counterpart of the reference's `KNNQueryBuilderProtoConverter`
(grpc/proto/request/search/query/KNNQueryBuilderProtoConverter.java:18-44):
converts the protobuf `QueryContainer.knn` payload into a validated
`KnnQuery` that the normal execution path consumes, so the gRPC surface and
the JSON DSL share one query pipeline.
"""

from __future__ import annotations

import numpy as np

from opensearch_jvector_tpu_torch.api.config import ValidationError
from opensearch_jvector_tpu_torch.grpc import knn_query_pb2 as pb
from opensearch_jvector_tpu_torch.query.builder import KnnQuery, Rescore


def knn_query_from_proto(container: pb.QueryContainer) -> tuple[str, KnnQuery]:
    """QueryContainer -> (field name, validated KnnQuery)."""
    if container.WhichOneof("query") != "knn":
        raise ValidationError("QueryContainer must carry a knn query")
    p = container.knn
    if not p.field:
        raise ValidationError("knn query requires a field")
    mp = p.method_parameters

    if p.query_vectors:
        # batched surface: Q rows -> the engine's native [Q, d] batch
        # (one device dispatch); mutually exclusive with `vector`
        if p.vector:
            raise ValidationError(
                "knn query takes either vector or query_vectors, not both"
            )
        lens = {len(row.values) for row in p.query_vectors}
        if len(lens) != 1:
            raise ValidationError(
                f"query_vectors rows must share one length (got {sorted(lens)})"
            )
        if 0 in lens:
            raise ValidationError("query_vectors rows must be non-empty")
        vector = np.asarray(
            [list(row.values) for row in p.query_vectors], np.float32
        )
    else:
        vector = np.asarray(list(p.vector), np.float32)

    kwargs = dict(
        vector=vector,
        k=int(p.k) if p.HasField("k") else None,
        max_distance=p.max_distance if p.HasField("max_distance") else None,
        min_score=p.min_score if p.HasField("min_score") else None,
        expand_nested_docs=bool(p.expand_nested_docs),
    )
    if p.filter_ids:
        kwargs["filter_docs"] = np.asarray(list(p.filter_ids), np.int64)
    if mp.HasField("ef_search"):
        kwargs["ef_search"] = int(mp.ef_search)
    if mp.HasField("overquery_factor"):
        kwargs["overquery_factor"] = int(mp.overquery_factor)
    if mp.HasField("threshold"):
        kwargs["threshold"] = float(mp.threshold)
    if mp.HasField("rerank_floor"):
        kwargs["rerank_floor"] = float(mp.rerank_floor)
    if mp.HasField("use_pruning"):
        kwargs["use_pruning"] = bool(mp.use_pruning)
    if p.HasField("rescore") and p.rescore.HasField("oversample_factor"):
        kwargs["rescore"] = Rescore(float(p.rescore.oversample_factor))
    return p.field, KnnQuery(**kwargs)


def response_to_proto(doc_ids, scores, visited=0, expanded=0,
                      reranked=0) -> pb.SearchResponse:
    """Query result arrays -> SearchResponse proto."""
    resp = pb.SearchResponse(visited=int(visited), expanded=int(expanded),
                             reranked=int(reranked))
    for d, s in zip(np.asarray(doc_ids).reshape(-1),
                    np.asarray(scores).reshape(-1)):
        if d < 0:
            continue
        resp.hits.add(id=int(d), score=float(s))
    return resp


def batched_response_to_proto(doc_ids, scores, size: int, visited=0,
                              expanded=0, reranked=0) -> pb.SearchResponse:
    """Batched [Q, k] result arrays -> SearchResponse with one HitGroup per
    query row; `hits` carries row 0 so single-query clients keep working."""
    resp = pb.SearchResponse(visited=int(visited), expanded=int(expanded),
                             reranked=int(reranked))
    ids = np.asarray(doc_ids)
    sc = np.asarray(scores)
    for qi in range(ids.shape[0]):
        group = resp.responses.add()
        for d, s in zip(ids[qi][:size], sc[qi][:size]):
            if d < 0:
                continue
            group.hits.add(id=int(d), score=float(s))
        if qi == 0:
            resp.hits.extend(group.hits)
    return resp
