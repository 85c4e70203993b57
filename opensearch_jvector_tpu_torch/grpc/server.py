"""gRPC query service (L6 transport parity).

Port of `opensearch_jvector_tpu/grpc/server.py` over the port's
`IndexManager` (service/http.py): a field's index is a `VectorIndex` or,
for `number_of_shards` > 1, a `ShardedVectorIndex`, served alike. Only
this package (grpc/) imports `grpc`; where grpcio is not installed the
REST service still runs.

The reference exposes KNN queries over OpenSearch's gRPC transport by
registering a QueryBuilderProtoConverter SPI (grpc/proto/request/search/
query/KNNQueryBuilderProtoConverter.java:18-44, exercised end-to-end by
KNNQueryGrpcIT.java). Here the converter (grpc/converter.py) is served by
a real gRPC endpoint: a unary Search RPC over the same IndexManager and
query pipeline the REST surface uses, so both transports share one
execution path (parse -> validate -> execute_knn_query -> hits).

Service: /opensearch_jvector_tpu.KnnService/Search
  SearchRequest -> SearchResponse (proto/knn_query.proto)

grpcio's generic-handler API is used directly with the generated message
classes — no grpc_tools service stubs are needed (the codegen plugin is
not in the image, and generic handlers are the stable public API for
exactly this).
"""

from __future__ import annotations

from concurrent import futures

import grpc

from opensearch_jvector_tpu_torch.api.config import ValidationError
from opensearch_jvector_tpu_torch.grpc import knn_query_pb2 as pb
from opensearch_jvector_tpu_torch.grpc.converter import (
    batched_response_to_proto,
    knn_query_from_proto,
    response_to_proto,
)
from opensearch_jvector_tpu_torch.query import knn as knn_mod

# the proto's own service name: the wire contract, shared with the JAX
# package's server
SERVICE_NAME = "opensearch_jvector_tpu.KnnService"


class _SearchHandler:
    """Unary Search over an IndexManager (service/http.py registry)."""

    def __init__(self, manager):
        self._mgr = manager

    def search(self, request: pb.SearchRequest, context) -> pb.SearchResponse:
        try:
            fields = self._mgr.get(request.index)
        except KeyError:
            context.abort(grpc.StatusCode.NOT_FOUND,
                          f"no such index {request.index!r}")
        try:
            field, query = knn_query_from_proto(request.query)
            if field not in fields:
                raise ValidationError(
                    f"knn query must target one of {sorted(fields)}"
                )
            dim = fields[field].config.dim
            if query.vector.shape[-1] != dim:
                raise ValidationError(
                    f"query vector dimension {query.vector.shape[-1]} does "
                    f"not match field {field!r} dimension {dim}"
                )
            res = knn_mod.execute_knn_query(fields[field], query)
        except ValidationError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        size = int(request.size) if request.HasField("size") else (
            int(query.k) if query.k else 10
        )
        if query.vector.ndim == 2:
            # batched request (query_vectors): one HitGroup per query row,
            # all rows served by the single device dispatch above
            return batched_response_to_proto(
                res.doc_ids, res.scores, size,
                visited=res.visited, expanded=res.expanded,
                reranked=res.reranked,
            )
        return response_to_proto(
            res.doc_ids[0][:size], res.scores[0][:size],
            visited=res.visited, expanded=res.expanded,
            reranked=res.reranked,
        )


def _handlers(manager):
    handler = _SearchHandler(manager)
    return grpc.method_handlers_generic_handler(
        SERVICE_NAME,
        {
            "Search": grpc.unary_unary_rpc_method_handler(
                handler.search,
                request_deserializer=pb.SearchRequest.FromString,
                response_serializer=pb.SearchResponse.SerializeToString,
            ),
        },
    )


class KnnGrpcService:
    """gRPC server wrapping an IndexManager (or sharing KnnService's).

    Control plane (index create/ingest/flush) stays on REST — matching the
    reference, whose gRPC surface carries only the query path while index
    management rides the normal OpenSearch APIs.
    """

    def __init__(self, manager, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 8):
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers)
        )
        self._server.add_generic_rpc_handlers((_handlers(manager),))
        self._port = self._server.add_insecure_port(f"{host}:{port}")
        if self._port == 0:
            raise RuntimeError(f"could not bind gRPC port on {host}:{port}")

    @property
    def port(self) -> int:
        return self._port

    def start(self) -> None:
        self._server.start()

    def stop(self, grace: float | None = None) -> None:
        self._server.stop(grace).wait()


def search_stub(channel: grpc.Channel):
    """Client-side callable for the Search RPC (stub-less: message-typed
    unary_unary over the wire path, mirroring the server's generic
    registration)."""
    return channel.unary_unary(
        f"/{SERVICE_NAME}/Search",
        request_serializer=pb.SearchRequest.SerializeToString,
        response_deserializer=pb.SearchResponse.FromString,
    )
