"""Port parity for the gRPC surface (grpc/): the converter against the JAX
package's, byte for byte, and the port's `KnnGrpcService` over a real
grpcio channel against the in-process query path.

The port's `knn_query_pb2` is a byte-identical copy of the JAX package's
generated module (the serialized descriptor is the wire contract), so
both import into one process and share message classes; a stub of either
package talks to the port's server.
"""

import grpc
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.grpc import converter as jconv
from opensearch_jvector_tpu.grpc import knn_query_pb2 as jpb
from opensearch_jvector_tpu.grpc.server import search_stub as jstub
from opensearch_jvector_tpu_torch.grpc import converter as conv
from opensearch_jvector_tpu_torch.grpc import knn_query_pb2 as pb
from opensearch_jvector_tpu_torch.grpc.server import (
    KnnGrpcService,
    search_stub,
)
from opensearch_jvector_tpu_torch.query import knn as knn_mod
from opensearch_jvector_tpu_torch.query.builder import KnnQuery, Rescore
from opensearch_jvector_tpu_torch.service.http import IndexManager

torch.set_num_threads(2)

D, N = 16, 300


def test_generated_module_is_the_reference_file():
    """One wire contract: the same serialized descriptor, the same
    message classes once both are imported."""
    assert pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert pb.DESCRIPTOR.package == "opensearch_jvector_tpu"
    assert pb.SearchRequest is jpb.SearchRequest


def _knn(**kw):
    return pb.QueryContainer(knn=pb.KnnQuery(**kw))


QUERIES = [
    _knn(field="v", vector=[1.0, 2.0], k=3),
    _knn(field="v", vector=[0.5] * 4, k=5,
         method_parameters=pb.MethodParameters(
             ef_search=40, overquery_factor=2, threshold=0.1,
             rerank_floor=0.05, use_pruning=True),
         rescore=pb.Rescore(oversample_factor=3.0), filter_ids=[4, 9],
         expand_nested_docs=True),
    _knn(field="v", vector=[1.0], min_score=0.25),
    _knn(field="v", vector=[1.0], max_distance=2.5),
    _knn(field="v", k=2, query_vectors=[pb.VectorRow(values=[1.0, 2.0]),
                                        pb.VectorRow(values=[3.0, 4.0])]),
    pb.QueryContainer(),
    _knn(vector=[1.0], k=2),
    _knn(field="v", vector=[1.0], k=2,
         query_vectors=[pb.VectorRow(values=[1.0])]),
    _knn(field="v", k=2, query_vectors=[pb.VectorRow(values=[1.0]),
                                        pb.VectorRow(values=[1.0, 2.0])]),
    _knn(field="v", k=2, query_vectors=[pb.VectorRow()]),
    _knn(field="v", vector=[1.0]),
    _knn(field="v", vector=[1.0], k=3, min_score=0.5),
    _knn(field="v", vector=[1.0], k=20_000),
    _knn(field="v", vector=[1.0], k=3,
         rescore=pb.Rescore(oversample_factor=0.5)),
]


def _outcome(fn, container):
    try:
        field, q = fn(container)
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__, str(e))
    return ("ok", field, q.vector.dtype.str, q.vector.tolist(), q.k,
            None if q.filter_docs is None else q.filter_docs.tolist(),
            q.max_distance, q.min_score, q.ef_search, q.overquery_factor,
            q.threshold, q.rerank_floor, q.use_pruning,
            None if q.rescore is None else q.rescore.oversample_factor,
            q.expand_nested_docs)


@pytest.mark.parametrize("container", QUERIES, ids=range(len(QUERIES)))
def test_query_conversion_matches(container):
    assert (_outcome(conv.knn_query_from_proto, container)
            == _outcome(jconv.knn_query_from_proto, container))


RESULTS = [
    (np.array([[3, 1, -1]]), np.array([[0.9, 0.5, -np.inf]], np.float32)),
    (np.array([[7, 2], [5, -1], [-1, -1]]),
     np.array([[0.8, 0.7], [0.6, -np.inf], [-np.inf, -np.inf]], np.float32)),
]


@pytest.mark.parametrize("res", RESULTS, ids=["single", "batched"])
def test_response_protos_are_byte_equal(res):
    ids, scores = res
    kw = dict(visited=11, expanded=4, reranked=3)
    assert (conv.response_to_proto(ids[0], scores[0], **kw)
            .SerializeToString()
            == jconv.response_to_proto(ids[0], scores[0], **kw)
            .SerializeToString())
    for size in (1, 2):
        assert (conv.batched_response_to_proto(ids, scores, size, **kw)
                .SerializeToString()
                == jconv.batched_response_to_proto(ids, scores, size, **kw)
                .SerializeToString())


@pytest.fixture(scope="module")
def grpc_env(tmp_path_factory):
    rng = np.random.default_rng(12)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    mgr = IndexManager(tmp_path_factory.mktemp("grpc"), device="cpu")
    mgr.create("gidx", {"properties": {"vec": {
        "type": "knn_vector", "dimension": D,
        "method": {"name": "disk_ann", "engine": "jvector",
                   "parameters": {"m": 8, "ef_construction": 32}}}}})
    idx = mgr.get("gidx")["vec"]
    idx.add_batch(np.arange(N), vecs)
    idx.flush()
    svc = KnnGrpcService(mgr)
    svc.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{svc.port}")
    yield mgr, vecs, search_stub(channel), jstub(channel)
    channel.close()
    svc.stop()
    mgr.close()


def _request(index, field, vector, k=None, size=None, **knn_kwargs):
    q = pb.KnnQuery(field=field, vector=[float(x) for x in vector],
                    **knn_kwargs)
    if k is not None:
        q.k = k
    req = pb.SearchRequest(index=index, query=pb.QueryContainer(knn=q))
    if size is not None:
        req.size = size
    return req


def _inprocess(mgr, **kw):
    return knn_mod.execute_knn_query(mgr.get("gidx")["vec"], KnnQuery(**kw))


@pytest.mark.parametrize("which", ["port_stub", "jax_stub"])
def test_search_matches_the_inprocess_path(grpc_env, which):
    mgr, vecs, search, jsearch = grpc_env
    call = search if which == "port_stub" else jsearch
    resp = call(_request("gidx", "vec", vecs[42], k=5))
    res = _inprocess(mgr, vector=vecs[42], k=5)
    assert [h.id for h in resp.hits] == res.doc_ids[0].tolist()
    np.testing.assert_array_equal([h.score for h in resp.hits],
                                  res.scores[0])
    assert resp.hits[0].id == 42 and resp.visited == res.visited > 0


def test_method_parameters_and_size(grpc_env):
    mgr, vecs, search, _ = grpc_env
    resp = search(_request(
        "gidx", "vec", vecs[7], k=10, size=3,
        method_parameters=pb.MethodParameters(ef_search=64,
                                              overquery_factor=2),
        rescore=pb.Rescore(oversample_factor=2.0)))
    res = _inprocess(mgr, vector=vecs[7], k=10, ef_search=64,
                     overquery_factor=2, rescore=Rescore(2.0))
    assert [h.id for h in resp.hits] == res.doc_ids[0, :3].tolist()
    assert len(resp.hits) == 3 and resp.hits[0].id == 7


def test_filter_ids(grpc_env):
    mgr, vecs, search, _ = grpc_env
    allowed = [3, 17, 42, 99, 250]
    resp = search(_request("gidx", "vec", vecs[42], k=3, filter_ids=allowed))
    ids = [h.id for h in resp.hits]
    assert ids[0] == 42 and set(ids) <= set(allowed)
    res = _inprocess(mgr, vector=vecs[42], k=3,
                     filter_docs=np.asarray(allowed))
    assert ids == res.doc_ids[0].tolist()


def test_radial(grpc_env):
    mgr, vecs, search, _ = grpc_env
    resp = search(_request("gidx", "vec", vecs[5], min_score=0.05))
    res = _inprocess(mgr, vector=vecs[5], min_score=0.05)
    assert [h.id for h in resp.hits] == res.doc_ids[0][
        res.doc_ids[0] >= 0].tolist()[:len(resp.hits)]
    assert resp.hits[0].id == 5
    assert all(h.score >= 0.05 - 1e-6 for h in resp.hits)


def test_batched_query_vectors(grpc_env):
    mgr, vecs, search, _ = grpc_env
    q = pb.KnnQuery(field="vec", k=4, query_vectors=[
        pb.VectorRow(values=vecs[i].tolist()) for i in (1, 2, 3)])
    resp = search(pb.SearchRequest(index="gidx",
                                   query=pb.QueryContainer(knn=q)))
    res = _inprocess(mgr, vector=vecs[[1, 2, 3]], k=4)
    assert len(resp.responses) == 3
    for row, group in zip(res.doc_ids, resp.responses, strict=True):
        assert [h.id for h in group.hits] == row.tolist()
    assert [h.id for h in resp.hits] == res.doc_ids[0].tolist()


@pytest.mark.parametrize("case", [
    ("nope", "vec", 3, grpc.StatusCode.NOT_FOUND),
    ("gidx", "other", 3, grpc.StatusCode.INVALID_ARGUMENT),
    ("gidx", "vec", 0, grpc.StatusCode.INVALID_ARGUMENT),
    ("gidx", "", 3, grpc.StatusCode.INVALID_ARGUMENT),
], ids=["unknown_index", "unknown_field", "bad_k", "no_field"])
def test_error_statuses(grpc_env, case):
    _, vecs, search, _ = grpc_env
    index, field, k, code = case
    with pytest.raises(grpc.RpcError) as e:
        search(_request(index, field, vecs[0], k=k))
    assert e.value.code() == code


def test_wrong_dimension_and_empty_rows(grpc_env):
    _, vecs, search, _ = grpc_env
    with pytest.raises(grpc.RpcError) as e:
        search(_request("gidx", "vec", vecs[0][:5], k=3))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "dimension 5" in e.value.details()
    q = pb.KnnQuery(field="vec", k=3, query_vectors=[pb.VectorRow()])
    with pytest.raises(grpc.RpcError) as e:
        search(pb.SearchRequest(index="gidx",
                                query=pb.QueryContainer(knn=q)))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "non-empty" in e.value.details()
