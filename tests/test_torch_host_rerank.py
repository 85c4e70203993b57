"""The on_disk tier's host rerank kernel (`csrc/host_rerank.cpp`, bound by
`ops/host_rerank.py`) against the numpy path it replaced, which stays as
the fallback where no host compiler exists (`reader._host_rerank_numpy`),
and against a float64 reference.

Held: the same ids as the numpy path, scores within 1e-5 of it and within
3e-5 of float64 (relative), over the three similarities, widths that are
and are not multiples of the vector width, k under and over r; the
qualify mask, -1 candidate ids, the threshold, exact ties (the lower
candidate position first), one query (the one-thread path), the numpy
fallback when the library is made unavailable, and the counter of rows
the kernel scored on real on_disk searches.
"""

import numpy as np
import pytest

from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig, SearchConfig
from opensearch_jvector_tpu_torch.api.stats import Counter
from opensearch_jvector_tpu_torch.index import reader as treader
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.models.searcher import SearchParams
from opensearch_jvector_tpu_torch.ops import _kernels, host_rerank
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction

SIMS = list(host_rerank.SIMILARITY_CODES)
Q, R = 40, 20


@pytest.fixture
def kernel():
    """Skip where the host compiler cannot build the library here."""
    if host_rerank._load_lib() is None:
        pytest.skip("no host C++ compiler: the numpy fallback serves")


def _block(seed, q, r, d):
    """Queries [q, d], rows [q, r, d] of non-negative values (so no score
    sits near 0, where a relative comparison means nothing), candidate ids
    with some -1 pads (their rows zero, as the row store fills them) and a
    qualify mask as `_tiered_search` builds it."""
    rng = np.random.default_rng(seed)
    queries = np.abs(rng.standard_normal((q, d))).astype(np.float32)
    rows = np.abs(rng.standard_normal((q, r, d))).astype(np.float32)
    cand = rng.permutation(q * r * 4)[: q * r].reshape(q, r).astype(np.int64)
    cand[rng.random((q, r)) < 0.1] = -1
    rows[cand < 0] = 0.0
    qualify = (cand >= 0) & (rng.random((q, r)) < 0.9)
    return queries, rows, cand, qualify


def _f64_scores(queries, rows, simf):
    q = queries.astype(np.float64)[:, None, :]
    c = rows.astype(np.float64)
    if simf is SimilarityFunction.EUCLIDEAN:
        return 1.0 / (1.0 + np.sum((q - c) ** 2, -1))
    if simf is SimilarityFunction.DOT_PRODUCT:
        return (1.0 + np.sum(q * c, -1)) / 2.0
    cos = np.sum(q * c, -1) / (np.sqrt(np.sum(q * q, -1) + 1e-30)
                               * np.sqrt(np.sum(c * c, -1) + 1e-30))
    return (1.0 + cos) / 2.0


def _both(queries, rows, cand, qualify, params, simf):
    """(kernel ids, scores, rows scored), (numpy ids, scores)."""
    native = host_rerank.rerank_topk(queries, rows, cand, qualify, params.k,
                                     params.threshold, simf)
    return native, treader._host_rerank_numpy(queries, rows, cand, qualify,
                                              params, simf)


@pytest.mark.parametrize("k", [5, R + 5], ids=["k<r", "k>=r"])
@pytest.mark.parametrize("d", [3, 100, 960])
@pytest.mark.parametrize("simf", SIMS, ids=lambda s: s.name.lower())
def test_kernel_matches_numpy_and_float64(kernel, simf, d, k):
    queries, rows, cand, qualify = _block(d, Q, R, d)
    params = SearchParams(k=k)
    (ids, scores, scored), (np_ids, np_scores) = _both(
        queries, rows, cand, qualify, params, simf)
    assert ids.shape == scores.shape == (Q, min(k, R))
    assert scored == int(qualify.sum())
    np.testing.assert_array_equal(ids, np_ids)
    np.testing.assert_allclose(scores, np_scores, rtol=1e-5, atol=0)
    # every returned id is a qualifying candidate; its float64 score
    ref = _f64_scores(queries, rows, simf)
    live = ids >= 0
    assert live.sum() == np.minimum(qualify.sum(1), k).sum()
    for qi in range(Q):
        pos = [int(np.nonzero(cand[qi] == i)[0][0])
               for i in ids[qi][live[qi]]]
        assert qualify[qi, pos].all()
        np.testing.assert_allclose(scores[qi][live[qi]], ref[qi, pos],
                                   rtol=3e-5, atol=0)
    assert np.all(scores[~live] == -np.inf)
    pairs = live[:, 1:]  # descending wherever the next entry is live
    assert np.all(scores[:, 1:][pairs] <= scores[:, :-1][pairs])


@pytest.mark.parametrize("simf", SIMS, ids=lambda s: s.name.lower())
def test_threshold_drops_scores_under_it(kernel, simf):
    queries, rows, cand, qualify = _block(7, Q, R, 100)
    ref = _f64_scores(queries, rows, simf)
    threshold = float(np.median(ref[qualify]))
    params = SearchParams(k=8, threshold=threshold)
    (ids, scores, _), (np_ids, np_scores) = _both(
        queries, rows, cand, qualify, params, simf)
    np.testing.assert_array_equal(ids, np_ids)
    np.testing.assert_allclose(scores, np_scores, rtol=1e-5, atol=0)
    kept = ids >= 0
    assert 0 < kept.sum() < kept.size
    assert np.all(scores[kept] >= np.float32(threshold))
    assert np.all(scores[~kept] == -np.inf)


@pytest.mark.parametrize("k", [3, 12], ids=["k<r", "k>=r"])
@pytest.mark.parametrize("simf", SIMS, ids=lambda s: s.name.lower())
def test_exact_ties_go_to_the_lower_position(kernel, simf, k):
    """Query 0: ten equal rows, position 2 not qualifying. Query 1: equal
    rows but position 4. Candidate ids fall as positions rise, so the
    order shows that ties go by position, not by id."""
    rng = np.random.default_rng(3)
    r, d = 10, 33
    queries = np.abs(rng.standard_normal((2, d))).astype(np.float32)
    rows = np.repeat(np.abs(rng.standard_normal((2, 1, d))), r, 1).astype(
        np.float32)
    rows[1, 4] += 1.0
    cand = np.arange(2 * r, dtype=np.int64).reshape(2, r)[:, ::-1].copy()
    qualify = np.ones((2, r), bool)
    qualify[0, 2] = False
    ids, scores, _ = host_rerank.rerank_topk(queries, rows, cand, qualify, k,
                                             0.0, simf)
    kk = min(k, r)
    first = [p for p in range(r) if p != 2][:kk]
    assert list(ids[0]) == list(cand[0, first]) + [-1] * (kk - len(first))
    assert np.unique(scores[0][ids[0] >= 0]).size == 1
    ref = _f64_scores(queries, rows, simf)[1]
    others = [p for p in range(r) if p != 4]
    order = [4] + others if ref[4] > ref[0] else others + [4]
    assert list(ids[1]) == list(cand[1, order[:kk]])


@pytest.mark.parametrize("simf", SIMS, ids=lambda s: s.name.lower())
def test_one_query_and_thread_split_agree(kernel, simf):
    """Q = 1 (a one-query REST search, 768 KB: the one-thread path) gives
    each query of a multi-threaded block the very same answer."""
    queries, rows, cand, qualify = _block(11, 24, 200, 960)
    ids, scores, scored = host_rerank.rerank_topk(queries, rows, cand,
                                                  qualify, 10, 0.0, simf)
    assert scored == int(qualify.sum())
    for qi in (0, 7, 23):
        one = host_rerank.rerank_topk(queries[qi:qi + 1], rows[qi:qi + 1],
                                      cand[qi:qi + 1], qualify[qi:qi + 1],
                                      10, 0.0, simf)
        np.testing.assert_array_equal(one[0][0], ids[qi])
        np.testing.assert_array_equal(one[1][0], scores[qi])
        np_ids, np_scores = treader._host_rerank_numpy(
            queries[qi:qi + 1], rows[qi:qi + 1], cand[qi:qi + 1],
            qualify[qi:qi + 1], SearchParams(k=10), simf)
        np.testing.assert_array_equal(one[0], np_ids)
        np.testing.assert_allclose(one[1], np_scores, rtol=1e-5, atol=0)


def test_nothing_qualifies(kernel):
    queries, rows, cand, _ = _block(5, 4, 6, 8)
    ids, scores, scored = host_rerank.rerank_topk(
        queries, rows, cand, np.zeros((4, 6), bool), 3, 0.0,
        SimilarityFunction.EUCLIDEAN)
    assert scored == 0
    assert np.all(ids == -1) and np.all(scores == -np.inf)


def test_bad_shapes_raise(kernel):
    queries, rows, cand, qualify = _block(5, 4, 6, 8)
    with pytest.raises(ValueError):
        host_rerank.rerank_topk(queries[:3], rows, cand, qualify, 3, 0.0,
                                SimilarityFunction.EUCLIDEAN)
    with pytest.raises(ValueError):
        host_rerank.rerank_topk(queries, rows, cand[:, :5], qualify, 3, 0.0,
                                SimilarityFunction.EUCLIDEAN)


@pytest.mark.parametrize("simf", SIMS, ids=lambda s: s.name.lower())
def test_numpy_fallback_when_library_unavailable(kernel, simf, monkeypatch):
    queries, rows, cand, qualify = _block(13, Q, R, 100)
    params = SearchParams(k=6, threshold=0.0)
    native = treader._host_rerank(queries, rows, cand, qualify, params, simf)
    monkeypatch.setattr(host_rerank, "_load_lib", lambda: None)
    assert host_rerank.rerank_topk(queries, rows, cand, qualify, 6, 0.0,
                                   simf) is None
    ids, scores, scored = treader._host_rerank(queries, rows, cand, qualify,
                                               params, simf)
    assert scored == 0 and native[2] == int(qualify.sum())
    np.testing.assert_array_equal(ids, native[0])
    np.testing.assert_allclose(scores, native[1], rtol=1e-5, atol=0)


def test_host_sources_build_with_the_host_compiler():
    assert _kernels._source("host_rerank").suffix == ".cpp"
    assert _kernels._flags("host_rerank") == _kernels.HOST_CXX_FLAGS
    assert _kernels._flags("vector_store") == _kernels.HOST_CXX_FLAGS
    assert _kernels._flags("adc_scan") == _kernels.NVCC_FLAGS
    assert "-march=native" not in _kernels.HOST_CXX_FLAGS
    assert "-ffast-math" not in _kernels.HOST_CXX_FLAGS


D, N = 16, 400


@pytest.fixture(scope="module")
def on_disk_index(tmp_path_factory):
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((12, D)).astype(np.float32)
    cfg = DiskAnnConfig(dim=D, m=8, ef_construction=32,
                        quantization_type="pq",
                        min_batch_size_for_quantization=128,
                        num_pq_subspaces=4, mode="on_disk",
                        index_type="flat")
    idx = VectorIndex(tmp_path_factory.mktemp("host_rerank"), cfg,
                      device="cpu")
    idx.add_batch(np.arange(N), vectors)
    idx.flush()
    yield idx, queries
    idx.close()


def _deltas(idx, fn):
    before = idx.stats.snapshot()
    res = fn()
    after = idx.stats.snapshot()
    return res, {key: after[key] - before[key] for key in (
        Counter.KNN_QUERY_HOST_RERANK_NATIVE_ROWS.value,
        Counter.KNN_QUERY_RERANKED_COUNT.value)}


@pytest.mark.parametrize("search", ["batch", "one_query", "filtered",
                                    "rerank_floor"])
def test_native_rows_counter_follows_reranked(kernel, on_disk_index, search):
    idx, queries = on_disk_index
    sc = SearchConfig(k=5, overquery_factor=4)
    accept = None
    if search == "one_query":
        queries = queries[:1]
    elif search == "filtered":
        accept = np.arange(0, N, 3)
    elif search == "rerank_floor":
        sc = SearchConfig(k=5, overquery_factor=4, rerank_floor=0.02)
    res, delta = _deltas(idx, lambda: idx.search(queries, sc,
                                                 accept_docs=accept))
    native = delta[Counter.KNN_QUERY_HOST_RERANK_NATIVE_ROWS.value]
    assert native == delta[Counter.KNN_QUERY_RERANKED_COUNT.value]
    assert native == res.reranked > 0
    if search == "filtered":
        assert np.all(res.doc_ids[res.doc_ids >= 0] % 3 == 0)


def test_native_rows_counter_stays_at_zero_on_the_fallback(
        kernel, on_disk_index, monkeypatch):
    idx, queries = on_disk_index
    sc = SearchConfig(k=5, overquery_factor=4)
    want, _ = _deltas(idx, lambda: idx.search(queries, sc))
    monkeypatch.setattr(host_rerank, "_load_lib", lambda: None)
    res, delta = _deltas(idx, lambda: idx.search(queries, sc))
    assert delta[Counter.KNN_QUERY_HOST_RERANK_NATIVE_ROWS.value] == 0
    assert delta[Counter.KNN_QUERY_RERANKED_COUNT.value] == res.reranked > 0
    np.testing.assert_array_equal(res.doc_ids, want.doc_ids)
    np.testing.assert_allclose(res.scores, want.scores, rtol=1e-5, atol=0)
