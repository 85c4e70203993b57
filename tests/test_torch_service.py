"""Port parity for the REST service (service/http.py): the JAX package's
`KnnService` and the port's `KnnService(device="cpu")` run side by side
and get the same request sequence.

  * deterministic routes (errors, `_count`, `GET _doc`, `GET /{index}`
    and its replay into `PUT`, `_mapping`, `_cluster/settings`, the stats
    keys, `match_all` with `from`/`size`): status codes and bodies equal;
  * search routes over an index the JAX package built, which the port's
    service attaches through `PUT`: ids equal up to score ties, scores
    within rtol 1e-5 / atol 1e-6, for `knn`, the batched body,
    `script_score`, `ext.mmr` and `docvalue_fields`;
  * the same docs sent over `_bulk`: the port's recall@10 at least the JAX
    service's, less 0.02;
  * the port's own service: the micro-batcher coalesces concurrent
    same-key requests and runs the excluded shapes alone, HTTP/1.1
    keep-alive (a body a route does not read is drained, not taken for
    the next request), 8 threads of mixed requests give the serial answers,
    a `number_of_shards` that is not a positive integer is refused, and a
    CUDA service without a card raises.
"""

import http.client
import json
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.service.http import KnnService as JService
from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
from opensearch_jvector_tpu_torch.parallel.pools import ComputePools
from opensearch_jvector_tpu_torch.service.http import KnnService

torch.set_num_threads(2)

D, N, Q, K = 16, 600, 6, 10
RTOL, ATOL = 1e-5, 1e-6
PARAMS = {"m": 12, "ef_construction": 48,
          "advanced.num_pq_subspaces": 8,
          "advanced.min_batch_size_for_quantization": 256}
MAPPING = {"properties": {"vec": {
    "type": "knn_vector", "dimension": D, "space_type": "l2",
    "method": {"name": "disk_ann", "engine": "jvector",
               "parameters": PARAMS}}}}


def _latent(rng, n):
    a = rng.standard_normal((8, D)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(21)
    return _latent(rng, N), _latent(rng, Q)


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """(JAX service, port service), each over its own root."""
    j = JService(tmp_path_factory.mktemp("jsvc"))
    t = KnnService(tmp_path_factory.mktemp("tsvc"), device="cpu")
    j.start()
    t.start()
    yield j, t
    for svc in (j, t):
        svc.stop()
    t.manager.close()


def _raw(svc, method, path, raw=None, conn=None):
    own = conn is None
    conn = conn or http.client.HTTPConnection("127.0.0.1", svc.port,
                                              timeout=300)
    conn.request(method, path, raw, {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = json.loads(r.read())
    if own:
        conn.close()
    return r.status, data


def _req(svc, method, path, body=None, conn=None):
    return _raw(svc, method, path,
                None if body is None else json.dumps(body), conn)


def _same(services, method, path, body=None, raw=None):
    """Send one request to both services -> the (equal) body."""
    j, t = services
    if raw is not None:
        a, b = _raw(j, method, path, raw), _raw(t, method, path, raw)
    else:
        a, b = _req(j, method, path, body), _req(t, method, path, body)
    assert b == a, (method, path)
    return b[1]


@pytest.fixture(scope="module")
def lifecycle(services, corpus):
    """The deterministic sequence on both services: create, ingest, flush,
    delete one doc."""
    docs = [{"_id": i, "vec": corpus[0][i].tolist()} for i in range(2, 40)]
    _same(services, "PUT", "/life", {"mappings": MAPPING})
    _same(services, "POST", "/life/_doc/1", {"vec": corpus[0][1].tolist()})
    _same(services, "POST", "/life/_bulk", {"docs": docs})
    _same(services, "GET", "/life/_count")  # buffered docs are not counted
    _same(services, "POST", "/life/_flush")
    _same(services, "DELETE", "/life/_doc/5")
    return services


# -- deterministic routes -----------------------------------------------------

ERRORS = [
    ("PUT", "/life", {"mappings": MAPPING}, None),  # duplicate create
    ("POST", "/life/_search", None, b"{not json"),
    ("POST", "/life/_search", None, b"\xff\xfe\xfd"),  # invalid UTF-8
    ("POST", "/nope/_search", {"query": {"match_all": {}}}, None),
    ("POST", "/life/_search",
     {"query": {"knn": {"other": {"vector": [0.0] * D, "k": 3}}}}, None),
    ("POST", "/life/_search",
     {"query": {"knn": {"vec": {"vector": [0.0] * D, "k": 0}}}}, None),
    ("POST", "/life/_search", {"size": -1}, None),
    ("POST", "/life/_search", {"docvalue_fields": [{"field": "vec",
                                                    "format": "x"}]}, None),
    ("POST", "/life/_search", {"query": {"script_score": {"script": {
        "source": "other"}}}}, None),
    ("POST", "/life/_doc/77", {"nofield": [1.0]}, None),
    ("POST", "/life/_bulk", {"docs": [{"_id": 3}]}, None),
    ("GET", "/nope", None, None),
    ("GET", "/nope/_count", None, None),
    ("DELETE", "/nope", None, None),
    ("GET", "/_plugins/_knn/stats/bogus_stat", None, None),
    ("GET", "/a/b/c", None, None),
    ("PUT", "/bad", {"mappings": {"properties": {"v": {"type": "text"}}}},
     None),
    ("PUT", "/bad", {"mappings": {"properties": {"v": {
        "type": "knn_vector", "dimension": D, "space_type": "l1"}}}}, None),
    ("PUT", "/life/_mapping", {"properties": {"vec": {
        "type": "knn_vector", "dimension": 8}}}, None),  # conflict
]


@pytest.mark.parametrize("case", ERRORS, ids=range(len(ERRORS)))
def test_error_routes_match(lifecycle, case):
    method, path, body, raw = case
    _same(lifecycle, method, path, body, raw)


@pytest.mark.parametrize("path", ["/life/_count", "/life/_doc/1",
                                  "/life/_doc/7", "/life/_doc/5",
                                  "/life/_doc/999", "/life"])
def test_read_routes_match(lifecycle, path):
    _same(lifecycle, "GET", path)


def test_get_index_replays_into_put(lifecycle):
    out = _same(lifecycle, "GET", "/life")
    body = out["life"]
    _same(lifecycle, "PUT", "/life_copy", body)
    again = _same(lifecycle, "GET", "/life_copy")
    assert again["life_copy"] == body
    _same(lifecycle, "DELETE", "/life_copy")
    _same(lifecycle, "GET", "/life_copy")  # 404 after the delete


def test_mapping_add_and_resend_match(lifecycle):
    alt = {"properties": {"alt": {"type": "knn_vector", "dimension": 4}}}
    _same(lifecycle, "PUT", "/life/_mapping", alt)
    _same(lifecycle, "PUT", "/life/_mapping", {"mappings": alt})  # no-op
    _same(lifecycle, "POST", "/life/_doc/300", {"alt": [1.0, 2.0, 3.0, 4.0]})
    _same(lifecycle, "POST", "/life/_flush")
    _same(lifecycle, "GET", "/life/_count")  # the doc-id union
    _same(lifecycle, "GET", "/life/_doc/300")


@pytest.mark.parametrize("frm,size", [(0, 5), (3, 4), (30, 50)])
def test_match_all_pages_match(lifecycle, frm, size):
    out = _same(lifecycle, "POST", "/life/_search", {
        "query": {"match_all": {}}, "from": frm, "size": size,
        "docvalue_fields": ["vec", "missing_field"]})
    assert out["hits"]["hits"]


def test_stats_keys_match(lifecycle):
    j, t = lifecycle
    a = _req(j, "GET", "/_plugins/_knn/stats")
    b = _req(t, "GET", "/_plugins/_knn/stats")
    assert a[0] == b[0] == 200
    assert set(b[1]["nodes"]["local"]) == set(a[1]["nodes"]["local"])


def test_cluster_settings_match_and_fire_the_thread_consumer(lifecycle):
    j, t = lifecycle
    a = _req(j, "GET", "/_cluster/settings")
    b = _req(t, "GET", "/_cluster/settings")
    assert set(b[1]["persistent"]) == set(a[1]["persistent"])
    for body in ({"persistent": {"knn.no.such.setting": 1}},
                 {"persistent": {"knn.memory.circuit_breaker.limit": 400.0}},
                 {"persistent": "x"}, {},
                 {"transient": {"knn.memory.circuit_breaker.limit": 50.0}}):
        _same(lifecycle, "PUT", "/_cluster/settings", body)
    ComputePools.instance()  # the pools exist; the consumer drops them
    try:
        _same(lifecycle, "PUT", "/_cluster/settings",
              {"persistent": {"knn.algo_param.index_thread_qty": 3}})
        assert ComputePools._instance is None
        assert GLOBAL_SETTINGS.get("knn.algo_param.index_thread_qty") == 3
    finally:
        _same(lifecycle, "PUT", "/_cluster/settings",
              {"persistent": {"knn.algo_param.index_thread_qty": 1}})


# -- search routes over a JAX-built index -------------------------------------

@pytest.fixture(scope="module")
def attached(services, corpus):
    """/docs built by the JAX service; its directory copied under the port
    service's root and attached there through PUT."""
    j, t = services
    docs = [{"_id": i, "vec": corpus[0][i].tolist()} for i in range(N)]
    assert _req(j, "PUT", "/docs", {"mappings": MAPPING})[0] == 200
    assert _req(j, "POST", "/docs/_bulk", {"docs": docs})[0] == 200
    assert _req(j, "POST", "/docs/_flush")[0] == 200
    shutil.copytree(j.manager.root / "docs", t.manager.root / "docs")
    assert _req(t, "PUT", "/docs", {"mappings": MAPPING})[0] == 200
    assert _req(t, "GET", "/docs/_count")[1] == {"count": N}
    return services


def _hits(out):
    hits = out["hits"]["hits"]
    return (np.array([[h["_id"] for h in hits]]),
            np.array([[h["_score"] for h in hits]], np.float32))


def assert_same_up_to_ties(ids_a, s_a, ids_b, s_b):
    assert ids_a.shape == ids_b.shape
    np.testing.assert_allclose(s_b, s_a, rtol=RTOL, atol=ATOL)
    tol = 2 * (ATOL + RTOL * np.abs(s_a))
    for r in range(ids_a.shape[0]):
        for c in np.nonzero(ids_a[r] != ids_b[r])[0]:
            tied = np.abs(s_a[r] - s_a[r, c]) <= tol[r, c]
            tied[c] = False
            assert tied.any(), (r, c, ids_a[r], ids_b[r])


def _both_search(attached, body):
    j, t = attached
    a, b = _req(j, "POST", "/docs/_search", body), _req(t, "POST",
                                                        "/docs/_search", body)
    assert a[0] == b[0] == 200, (a, b)
    return a[1], b[1]


@pytest.mark.parametrize("qi", range(3))
def test_knn_search_matches(attached, corpus, qi):
    a, b = _both_search(attached, {"size": K, "query": {"knn": {"vec": {
        "vector": corpus[1][qi].tolist(), "k": K}}}})
    assert_same_up_to_ties(*_hits(a), *_hits(b))


def test_batched_body_matches(attached, corpus):
    a, b = _both_search(attached, {"size": K, "query": {"knn": {"vec": {
        "vector": corpus[1].tolist(), "k": K}}}})
    assert b["profile"]["dispatch_rows"] == Q
    for ra, rb in zip(a["responses"], b["responses"], strict=True):
        assert_same_up_to_ties(*_hits(ra), *_hits(rb))


@pytest.mark.parametrize("space", ["l2", "innerproduct", "cosinesimil"])
def test_script_score_matches(attached, corpus, space):
    a, b = _both_search(attached, {"size": K, "from": 2, "query": {
        "script_score": {"script": {"source": "knn_score", "lang": "knn",
                                    "params": {"field": "vec",
                                               "space_type": space,
                                               "query_value":
                                                   corpus[1][0].tolist()}}}}})
    assert_same_up_to_ties(*_hits(a), *_hits(b))


def test_mmr_matches(attached, corpus):
    a, b = _both_search(attached, {"size": 5, "query": {"knn": {"vec": {
        "vector": corpus[1][1].tolist(), "k": 5}}},
        "ext": {"mmr": {"diversity": 0.5}}})
    assert _hits(b)[0].tolist() == _hits(a)[0].tolist()
    np.testing.assert_allclose(_hits(b)[1], _hits(a)[1], rtol=RTOL,
                               atol=ATOL)


def test_docvalue_fields_match(attached, corpus):
    a, b = _both_search(attached, {"size": 4, "docvalue_fields": ["vec"],
                                   "query": {"knn": {"vec": {
                                       "vector": corpus[1][2].tolist(),
                                       "k": 4}}}})
    assert_same_up_to_ties(*_hits(a), *_hits(b))
    for h in b["hits"]["hits"]:  # the stored vector, bit for bit
        np.testing.assert_array_equal(
            np.asarray(h["fields"]["vec"][0], np.float32),
            corpus[0][h["_id"]])


def test_bulk_ingest_recall_matches(services, corpus):
    """The same docs sent over _bulk to each service: the port's recall@10
    against exact search at least the JAX service's, less 0.02."""
    rows, queries = corpus
    d2 = ((queries[:, None, :] - rows[None, :, :]) ** 2).sum(-1)
    truth = np.argsort(d2, axis=1, kind="stable")[:, :K]
    recalls = []
    for svc in services:
        assert _req(svc, "PUT", "/bulk", {"mappings": MAPPING})[0] == 200
        for lo in range(0, N, 200):
            docs = [{"_id": i, "vec": rows[i].tolist()}
                    for i in range(lo, lo + 200)]
            assert _req(svc, "POST", "/bulk/_bulk", {"docs": docs})[0] == 200
        assert _req(svc, "POST", "/bulk/_flush")[0] == 200
        st, out = _req(svc, "POST", "/bulk/_search", {
            "size": K, "query": {"knn": {"vec": {"vector": queries.tolist(),
                                                 "k": K}}}})
        assert st == 200
        got = [[h["_id"] for h in r["hits"]["hits"]]
               for r in out["responses"]]
        recalls.append(np.mean([len(set(g) & set(t)) / K
                                for g, t in zip(got, truth)]))
    assert recalls[1] >= recalls[0] - 0.02, recalls


# -- the port's service -------------------------------------------------------

@pytest.fixture(scope="module")
def port_svc(attached):
    return attached[1]


def test_micro_batcher_coalesces_same_key_requests(port_svc, corpus):
    port_svc.manager.batcher.window_s = 0.25  # slow machines still coalesce
    barrier = threading.Barrier(8)
    out = {}

    def one(i):
        barrier.wait()
        out[i] = _req(port_svc, "POST", "/docs/_search", {"query": {"knn": {
            "vec": {"vector": corpus[0][i].tolist(), "k": 3}}}})

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        port_svc.manager.batcher.window_s = 0.002
    rows = 0
    for i in range(8):
        status, body = out[i]
        assert status == 200
        assert body["hits"]["hits"][0]["_id"] == i  # its own row
        rows = max(rows, body["profile"]["dispatch_rows"])
    assert rows >= 2


@pytest.mark.parametrize("extra", [{"filter": list(range(0, 600, 3))},
                                   {"expand_nested_docs": True}],
                         ids=["filter", "nested"])
def test_micro_batcher_runs_excluded_shapes_alone(port_svc, corpus, extra):
    st, body = _req(port_svc, "POST", "/docs/_search", {"query": {"knn": {
        "vec": {"vector": corpus[0][9].tolist(), "k": 3, **extra}}}})
    assert st == 200 and body["profile"]["dispatch_rows"] == 1


def test_radial_request_runs_alone(port_svc, corpus):
    st, body = _req(port_svc, "POST", "/docs/_search", {"query": {"knn": {
        "vec": {"vector": corpus[0][9].tolist(), "min_score": 0.9}}}})
    assert st == 200 and body["profile"]["dispatch_rows"] == 1
    assert body["hits"]["hits"][0]["_id"] == 9


def test_http11_keepalive_reuses_one_connection(port_svc):
    conn = http.client.HTTPConnection("127.0.0.1", port_svc.port, timeout=60)
    socks = set()
    for _ in range(3):
        assert _req(port_svc, "GET", "/docs/_count", conn=conn)[0] == 200
        assert conn.sock is not None
        socks.add(id(conn.sock))
    conn.close()
    assert len(socks) == 1


def test_a_body_a_route_does_not_read_is_drained(port_svc):
    """Routes that take no body (`_flush`, `_count`) still consume one, so
    the next request on the keep-alive connection parses (the reference
    reads it as the start of that request)."""
    conn = http.client.HTTPConnection("127.0.0.1", port_svc.port, timeout=60)
    assert _req(port_svc, "POST", "/docs/_flush", {"unused": 1}, conn)[0] \
        == 200
    assert _req(port_svc, "GET", "/docs/_count", {"unused": 2}, conn) == (
        200, {"count": N})
    assert _req(port_svc, "GET", "/docs/_count", conn=conn)[0] == 200
    conn.close()


def _mixed_requests(corpus):
    q = corpus[1]
    reqs = []
    for i in range(Q):
        reqs.append({"query": {"knn": {"vec": {"vector": q[i].tolist(),
                                               "k": K}}}})
        reqs.append({"query": {"knn": {"vec": {
            "vector": q[i].tolist(), "k": 5,
            "filter": list(range(i, N, 7))}}}})
    reqs.append({"size": K, "query": {"knn": {"vec": {
        "vector": q[:3].tolist(), "k": K}}}})
    return reqs


def _answers(out):
    if "responses" in out:
        return [_hits(r) for r in out["responses"]]
    return [_hits(out)]


def test_eight_threads_of_mixed_requests_give_the_serial_answers(port_svc,
                                                                 corpus):
    reqs = _mixed_requests(corpus)
    serial = [_req(port_svc, "POST", "/docs/_search", r) for r in reqs]
    assert all(s == 200 for s, _ in serial)
    got = [None] * (8 * len(reqs))
    barrier = threading.Barrier(8)

    def worker(w):
        conn = http.client.HTTPConnection("127.0.0.1", port_svc.port,
                                          timeout=300)
        barrier.wait()
        for n in range(len(reqs)):
            i = (n + 3 * w) % len(reqs)
            got[w * len(reqs) + i] = _req(port_svc, "POST", "/docs/_search",
                                          reqs[i], conn)
        conn.close()

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: races show sooner
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    for n, (status, out) in enumerate(got):
        assert status == 200
        want = _answers(serial[n % len(reqs)][1])
        for (ia, sa), (ib, sb) in zip(want, _answers(out), strict=True):
            assert_same_up_to_ties(ia, sa, ib, sb)


def test_more_than_one_shard_is_refused(port_svc):
    """More than one shard is served now (tests/test_torch_sharded.py);
    what is refused is a shard count that is not a positive integer, and
    the refused index does not exist."""
    for bad in (0, "two"):
        st, body = _req(port_svc, "PUT", "/sharded", {
            "settings": {"index": {"number_of_shards": bad}},
            "mappings": MAPPING})
        assert st == 400 and "number_of_shards" in body["error"]
        assert _req(port_svc, "GET", "/sharded")[0] == 404
    st, body = _req(port_svc, "PUT", "/sharded", {
        "settings": {"index": {"number_of_shards": 2}},
        "mappings": MAPPING})
    assert st == 200 and body["shards"] == 2
    st, body = _req(port_svc, "GET", "/sharded")
    assert body["sharded"]["settings"]["index"]["number_of_shards"] == 2
    assert _req(port_svc, "DELETE", "/sharded")[0] == 200


def test_cuda_service_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        KnnService(tmp_path, device="cuda").server.server_close()
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KnnService(tmp_path, device="cuda")
