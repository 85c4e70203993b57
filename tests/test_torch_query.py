"""Port parity for the query layer: the knn query DSL and its execution
(ANN, filtered exact fallback, broad filter, radial, rescore, nested
collapse, `knn_score` script scoring, MMR), the mapping parser, and the
index's read side (`get_vectors`, `get_vector`, `parents_of`,
`has_nested`, `Segment.ords_for_docs`).

The JAX package writes one index directory of five segments of different
kinds (in_memory PQ with nested parents, in_memory PQ, on_disk PQ,
`nvq+pq`, `4bit`); both packages open it and answer the same seeded numpy
queries. Tolerances:
  * query results: ids equal up to score ties, scores within rtol 1e-5 /
    atol 1e-6;
  * read-back: rows bit for bit for fp32 and on_disk segments, within
    1e-6 for NVQ segments (decoded rows);
  * MMR: the same selections (the inputs have no near-ties), and the
    greedy loops of both packages select the same over the port's
    similarity matrix;
  * parse errors: the same exception type and message.
The port's own fault fixes (a merge that swaps the segment set during an
exact, radial or script scan; an on_disk row store a merge retires under
a scan) are held to expected values computed with numpy.
"""

import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.api import config as jconfig
from opensearch_jvector_tpu.api.mapping import (
    parse_knn_vector_mapping as jparse_mapping,
)
from opensearch_jvector_tpu.index.index import VectorIndex as JIndex
from opensearch_jvector_tpu.index.scheduler import ForceMergesOnlyMergePolicy
from opensearch_jvector_tpu.ops.distances import SimilarityFunction as JSim
from opensearch_jvector_tpu.query import knn as jknn
from opensearch_jvector_tpu.query import mmr as jmmr
from opensearch_jvector_tpu.query.builder import KnnQuery as JQuery
from opensearch_jvector_tpu.query.builder import parse_knn_query as jparse
from opensearch_jvector_tpu_torch.api import config as tconfig
from opensearch_jvector_tpu_torch.api.mapping import parse_knn_vector_mapping
from opensearch_jvector_tpu_torch.api.stats import Counter, StatsRegistry
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.scheduler import (
    ForceMergesOnlyMergePolicy as TForceOnly,
)
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.query import exact as exact_mod
from opensearch_jvector_tpu_torch.query import knn
from opensearch_jvector_tpu_torch.query import mmr
from opensearch_jvector_tpu_torch.query.builder import KnnQuery, parse_knn_query
from opensearch_jvector_tpu_torch.utils.native_store import PagedVectorStore

torch.set_num_threads(2)

D, PER, Q, K = 16, 300, 4, 10
CFG = dict(dim=D, m=12, ef_construction=48, num_pq_subspaces=8,
           min_batch_size_for_quantization=256)
# segment kinds of the mixed directory, in segment order; kind i holds doc
# ids [i * PER, (i + 1) * PER)
KINDS = {
    "pq_nested": {},
    "pq": {},
    "on_disk": dict(mode="on_disk"),
    "nvq": dict(quantization_type="nvq+pq"),
    "4bit": dict(quantization_type="4bit"),
}
PARENT_BASE = 100_000  # nested children of kind 0: parent PARENT_BASE + id//3
RTOL, ATOL = 1e-5, 1e-6


def assert_same_up_to_ties(ids_a, s_a, ids_b, s_b):
    """Scores within RTOL/ATOL; ids differ only where the score is tied."""
    assert ids_a.shape == ids_b.shape
    np.testing.assert_allclose(s_a, s_b, rtol=RTOL, atol=ATOL)
    fin = np.where(np.isfinite(s_a), s_a, 0.0)
    tol = ATOL + RTOL * np.abs(fin)
    for r in range(ids_a.shape[0]):
        for j in np.nonzero(ids_a[r] != ids_b[r])[0]:
            tied = np.abs(fin[r] - fin[r, j]) <= 2 * tol[r, j]
            tied[j] = False
            assert tied.any(), (r, j, ids_a[r], ids_b[r])


def assert_same_result(jres, tres):
    assert_same_up_to_ties(np.asarray(jres.doc_ids), np.asarray(jres.scores),
                           tres.doc_ids, tres.scores)


def _latent(rng, n):
    a = rng.standard_normal((8, D)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(8)
    return _latent(rng, PER * len(KINDS)), _latent(rng, Q)


def _jax_index(root, rows, ids, parents=None, **extra):
    idx = JIndex(root, jconfig.DiskAnnConfig(**{**CFG, **extra}),
                 merge_policy=ForceMergesOnlyMergePolicy())
    idx.add_batch(ids, rows, parent_ids=parents)
    idx.flush()
    idx.close()
    return root


@pytest.fixture(scope="module")
def mixed_dir(corpus, tmp_path_factory):
    """One index directory, written by the JAX package, whose five
    segments are of the kinds in KINDS (each built alone, then gathered
    under one commits.json)."""
    rows = corpus[0]
    root = tmp_path_factory.mktemp("mixed")
    names = []
    for i, (kind, extra) in enumerate(KINDS.items()):
        ids = np.arange(i * PER, (i + 1) * PER)
        parents = PARENT_BASE + ids // 3 if kind == "pq_nested" else None
        part = _jax_index(tmp_path_factory.mktemp(kind), rows[ids], ids,
                          parents, **extra)
        (seg,) = json.loads((part / "commits.json").read_text())["segments"]
        name = f"seg_{i:06d}_{PER}"
        shutil.copytree(part / seg, root / name)
        names.append(name)
    (root / "commits.json").write_text(json.dumps({
        "config": jconfig.DiskAnnConfig(**CFG).to_meta(),
        "segments": names, "segment_deletes": {}}))
    return root


@pytest.fixture(scope="module")
def both(mixed_dir):
    j = JIndex(mixed_dir, merge_policy=ForceMergesOnlyMergePolicy())
    t = VectorIndex(mixed_dir, device="cpu", merge_policy=TForceOnly())
    yield j, t
    t.close()


@pytest.fixture(scope="module")
def bytes_dir(tmp_path_factory):
    """Byte-valued rows (integers 0..255) for the hamming space, doc ids
    0..PER-1: also the `vector_source` field of the MMR test."""
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 256, (PER, D)).astype(np.float32)
    return _jax_index(tmp_path_factory.mktemp("bytes"), rows,
                      np.arange(PER)), rows


def _queries(both_pair, *args, **kw):
    j, t = both_pair
    return (jknn.execute_knn_query(j, JQuery(*args, **kw)),
            knn.execute_knn_query(t, KnnQuery(*args, **kw)))


# -- ANN, filters, rescore, nested -------------------------------------------

@pytest.mark.parametrize("k", [1, K])
def test_ann_matches(both, corpus, k):
    jres, tres = _queries(both, corpus[1], k=k)
    assert_same_result(jres, tres)
    assert tres.doc_ids.shape == (Q, k) and (tres.doc_ids >= 0).all()


def _filter_ids():
    """40 ids spread over every segment (at or below k * overquery = 50:
    the exact fallback)."""
    return np.arange(7, PER * len(KINDS), PER * len(KINDS) // 40)[:40]


@pytest.mark.parametrize("as_mask", [False, True], ids=["ids", "mask"])
def test_exact_fallback_matches(both, corpus, as_mask, monkeypatch):
    ids = _filter_ids()
    flt = ids
    if as_mask:
        flt = np.zeros(PER * len(KINDS) + 5, bool)
        flt[ids] = True
    calls = []
    real = exact_mod.exact_search_segment
    monkeypatch.setattr(exact_mod, "exact_search_segment",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jres, tres = _queries(both, corpus[1], k=K, filter_docs=flt)
    assert len(calls) == len(KINDS)  # the fallback scanned every segment
    assert_same_result(jres, tres)
    assert np.isin(tres.doc_ids, ids).all()


def test_broad_filter_takes_ann(both, corpus):
    flt = np.arange(0, PER * len(KINDS), 2)  # 750 ids > k * overquery
    j, t = both
    before = t.stats.get(Counter.KNN_QUERY_WITH_FILTER_COUNT)
    # expanded: the hits are the filtered docs themselves, not parents
    jres, tres = _queries(both, corpus[1], k=K, filter_docs=flt,
                          expand_nested_docs=True)
    assert_same_result(jres, tres)
    assert np.isin(tres.doc_ids, flt).all()
    # the reader counts each query once per segment it searches
    assert (t.stats.get(Counter.KNN_QUERY_WITH_FILTER_COUNT) - before
            == Q * len(KINDS))


@pytest.mark.parametrize("oversample", [1.0, 3.0])
def test_rescore_matches(both, corpus, oversample):
    from opensearch_jvector_tpu.query.builder import Rescore as JRescore
    from opensearch_jvector_tpu_torch.query.builder import Rescore

    j, t = both
    # expanded, so that the hits are docs with rows (not nested parents)
    jres = jknn.execute_knn_query(j, JQuery(corpus[1], k=K,
                                            rescore=JRescore(oversample),
                                            expand_nested_docs=True))
    tres = knn.execute_knn_query(t, KnnQuery(corpus[1], k=K,
                                             rescore=Rescore(oversample),
                                             expand_nested_docs=True))
    assert_same_result(jres, tres)
    # every score is the doc's exact fp32 score over its stored row
    vecs, found = t.get_vectors(tres.doc_ids.reshape(-1))
    assert found.all()
    d2 = ((vecs.reshape(Q, K, D) - corpus[1][:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(tres.scores, 1.0 / (1.0 + d2), rtol=1e-5)


@pytest.mark.parametrize("expand", [False, True], ids=["collapse", "expand"])
def test_nested_matches(both, corpus, expand):
    # queries near the nested segment's rows
    q = corpus[0][[5, 50, 100, 200]] + 0.01
    jres, tres = _queries(both, q, k=K, expand_nested_docs=expand)
    assert_same_result(jres, tres)
    parents = tres.doc_ids >= PARENT_BASE
    if expand:
        assert not parents.any()
    else:
        assert parents.any()
        for row in tres.doc_ids:  # distinct parents after the collapse
            row = row[row >= 0]
            assert len(set(row.tolist())) == row.size


# -- radial -------------------------------------------------------------------

@pytest.fixture(scope="module")
def radial_dirs(corpus, tmp_path_factory):
    """Per similarity: both packages over one JAX-written index (the
    euclidean one is the mixed directory)."""
    out = {}
    for simf in (JSim.COSINE, JSim.DOT_PRODUCT):
        root = tmp_path_factory.mktemp(f"radial_{simf.name}")
        _jax_index(root, corpus[0][:PER], np.arange(PER), similarity=simf)
        out[simf.name] = root
    return out


def _radial_floor(rows, q, simf, quantile=0.95):
    """A score floor between two scores of query 0 (none ties it)."""
    if simf == "EUCLIDEAN":
        s = 1.0 / (1.0 + ((rows - q) ** 2).sum(-1))
    elif simf == "DOT_PRODUCT":
        s = (1.0 + rows @ q) / 2.0
    else:
        s = (1.0 + (rows / np.linalg.norm(rows, axis=1, keepdims=True))
             @ (q / np.linalg.norm(q))) / 2.0
    s = np.sort(s)
    i = int(quantile * s.size)
    return float((s[i] + s[i + 1]) / 2.0)


@pytest.mark.parametrize("kind", ["min_score", "max_distance"])
@pytest.mark.parametrize("simf", ["EUCLIDEAN", "COSINE", "DOT_PRODUCT"])
def test_radial_matches(both, radial_dirs, corpus, simf, kind):
    if simf == "EUCLIDEAN":
        pair, rows = both, corpus[0]
    else:
        root = radial_dirs[simf]
        pair = (JIndex(root, merge_policy=ForceMergesOnlyMergePolicy()),
                VectorIndex(root, device="cpu", merge_policy=TForceOnly()))
        rows = corpus[0][:PER]
    q = corpus[1][0]
    floor = _radial_floor(rows, q, simf)  # engine score space
    if kind == "min_score":
        if simf == "DOT_PRODUCT":  # the reference's piecewise score
            dot = 2.0 * floor - 1.0
            arg = 1.0 + dot if dot >= 0 else 1.0 / (1.0 - dot)
        else:
            arg = floor
        kw = dict(min_score=arg)
    else:
        arg = {"EUCLIDEAN": 1.0 / floor - 1.0, "COSINE": 2.0 - 2.0 * floor,
               "DOT_PRODUCT": 1.0 - 2.0 * floor}[simf]
        kw = dict(max_distance=arg)
    jres, tres = _queries(pair, q, **kw)
    assert_same_result(jres, tres)
    assert tres.doc_ids.shape[1] > 0
    assert (tres.scores[tres.doc_ids >= 0] >= floor - 1e-6).all()


# -- script score -------------------------------------------------------------

@pytest.mark.parametrize("space", ["l2", "l1", "linf", "innerproduct",
                                   "cosinesimil", "hamming"])
def test_script_score_matches(both, bytes_dir, corpus, space):
    if space == "hamming":
        root, rows = bytes_dir
        j = JIndex(root, merge_policy=ForceMergesOnlyMergePolicy())
        t = VectorIndex(root, device="cpu", merge_policy=TForceOnly())
        q = rows[3].copy()
        q[:4] = 255 - q[:4]
    else:
        j, t = both
        q = corpus[1][1]
    before = t.stats.get(Counter.SCRIPT_QUERY_REQUESTS)
    jres = jknn.execute_script_score(j, space, q, k=K)
    tres = knn.execute_script_score(t, space, q, k=K)
    assert_same_result(jres, tres)
    assert t.stats.get(Counter.SCRIPT_QUERY_REQUESTS) == before + 1


def test_script_score_unknown_space_counts_an_error(both, corpus):
    j, t = both
    stats = StatsRegistry()
    t.stats, saved = stats, t.stats
    try:
        with pytest.raises(ValueError) as te:
            knn.execute_script_score(t, "l3", corpus[1][0])
    finally:
        t.stats = saved
    with pytest.raises(ValueError) as je:
        jknn.execute_script_score(j, "l3", corpus[1][0])
    assert str(te.value) == str(je.value)
    assert stats.get(Counter.SCRIPT_QUERY_ERRORS) == 1


# -- MMR ----------------------------------------------------------------------

@pytest.mark.parametrize("diversity", [0.0, 0.5, 1.0])
def test_mmr_matches(both, corpus, diversity):
    j, t = both
    jres = jmmr.mmr_search(j, corpus[1], K, jmmr.MMRParams(diversity))
    tres = mmr.mmr_search(t, corpus[1], K, mmr.MMRParams(diversity))
    np.testing.assert_array_equal(tres.doc_ids, np.asarray(jres.doc_ids))
    np.testing.assert_allclose(tres.scores, np.asarray(jres.scores),
                               rtol=RTOL, atol=ATOL)
    for row in tres.doc_ids:
        assert len(set(row.tolist())) == K


def test_mmr_vector_source_matches(both, bytes_dir, corpus):
    j, t = both
    root, _ = bytes_dir
    jsrc = JIndex(root, merge_policy=ForceMergesOnlyMergePolicy())
    tsrc = VectorIndex(root, device="cpu", merge_policy=TForceOnly())
    q = corpus[0][[10, 120, 250]] + 0.01  # near the docs the source holds
    jres = jmmr.mmr_search(j, q, 5, jmmr.MMRParams(0.5), vector_source=jsrc)
    tres = mmr.mmr_search(t, q, 5, mmr.MMRParams(0.5), vector_source=tsrc)
    np.testing.assert_array_equal(tres.doc_ids, np.asarray(jres.doc_ids))
    ids = tres.doc_ids[tres.doc_ids >= 0]
    assert (ids < PER).all()  # hits the source lacks are excluded


@pytest.mark.parametrize("diversity", [0.0, 0.3, 0.7, 1.0])
def test_mmr_greedy_loops_agree_on_one_matrix(corpus, diversity,
                                              monkeypatch):
    """Both packages' greedy selection over the port's similarity matrix
    (so float near-ties between the two matrices cannot flip it)."""
    rng = np.random.default_rng(int(diversity * 10))
    vecs = corpus[0][rng.choice(PER, 30, replace=False)]
    rel = np.sort(rng.uniform(0.2, 0.9, 30))[::-1].astype(np.float32)
    rel[[4, 17]] = -np.inf  # hits without a vector
    simf = SimilarityFunction.EUCLIDEAN
    sims = torch.as_tensor(vecs)
    from opensearch_jvector_tpu_torch.ops.distances import pairwise_scores

    port_sims = pairwise_scores(sims, sims, simf).numpy()
    got = mmr.mmr_rerank(torch.as_tensor(vecs), rel, 10, diversity, simf)
    monkeypatch.setattr(jmmr, "pairwise_scores", lambda a, b, s: port_sims)
    want = jmmr.mmr_rerank(vecs, rel, 10, diversity, JSim.EUCLIDEAN)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, mmr.mmr_select(port_sims, rel, 10, diversity))


# -- read side ----------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_get_vectors_matches(both, corpus, kind):
    j, t = both
    i = list(KINDS).index(kind)
    ids = np.array([i * PER, i * PER + 7, i * PER + PER - 1, -1, 99_999,
                    (i + 1) % len(KINDS) * PER + 3])
    # op by op: XLA's compiled NVQ decode fuses multiply-adds (the port's
    # decode is bit for bit with the reference run operator by operator)
    with jax.disable_jit(kind == "nvq"):
        jv, jf = j.get_vectors(ids)
    tv, tf = t.get_vectors(ids)
    np.testing.assert_array_equal(tf, np.asarray(jf))
    assert tf.tolist() == [True, True, True, False, False, True]
    if kind == "nvq":
        np.testing.assert_allclose(tv[:3], np.asarray(jv)[:3], rtol=0,
                                   atol=1e-6)
    else:  # fp32 rows, in memory or in the on_disk row file
        np.testing.assert_array_equal(tv[:3], corpus[0][ids[:3]])
        np.testing.assert_array_equal(tv[:3], np.asarray(jv)[:3])
    assert (tv[~tf] == 0).all()


def test_get_vector_parents_and_nesting(both, corpus):
    j, t = both
    np.testing.assert_array_equal(t.get_vector(PER + 4), corpus[0][PER + 4])
    assert t.get_vector(10**7) is None and j.get_vector(10**7) is None
    ids = np.array([[0, 1, 5], [PER, -1, 2 * PER]])
    np.testing.assert_array_equal(t.parents_of(ids),
                                  np.asarray(j.parents_of(ids)))
    assert t.parents_of(ids).tolist() == [
        [PARENT_BASE, PARENT_BASE, PARENT_BASE + 1], [-1, -1, -1]]
    assert t.has_nested() == j.has_nested() is True


def test_ords_for_docs_matches(both):
    j, t = both
    ids = np.array([[0, 3, PER - 1], [PER, -5, 7]])
    for name in t.segment_names:
        got = t._reader(name).seg.ords_for_docs(ids)
        np.testing.assert_array_equal(
            got, j._reader(name).seg.ords_for_docs(ids))
        assert got.shape == ids.shape


# -- the port's own fault fixes -----------------------------------------------

@pytest.fixture
def port_index(corpus, tmp_path):
    """Three in_memory segments written by the port, a tenth of the docs
    deleted."""
    idx = VectorIndex(tmp_path / "p", tconfig.DiskAnnConfig(**CFG),
                      device="cpu", merge_policy=TForceOnly())
    for s in range(3):
        ids = np.arange(s * PER, (s + 1) * PER)
        idx.add_batch(ids, corpus[0][ids])
        idx.flush()
    dead = np.arange(0, 3 * PER, 10)
    idx.delete(dead)
    yield idx, dead
    idx.close()


def _numpy_top(rows, live, q, k, floor=None):
    """Exact euclidean top-k (or all above `floor`) over the live ids."""
    s = 1.0 / (1.0 + ((rows[live] - q) ** 2).sum(-1))
    order = np.argsort(-s, kind="stable")
    if floor is not None:
        order = order[s[order] >= floor]
    else:
        order = order[:k]
    return live[order][None, :], s[order][None, :].astype(np.float32)


@pytest.mark.parametrize("path", ["exact", "radial", "script"])
def test_a_merge_during_a_scan_brings_no_deleted_doc_back(
        port_index, corpus, path, monkeypatch):
    """The set and its tombstones are one snapshot: a merge that swaps the
    segment set after the first segment's scan (and clears the old names'
    tombstones, folded into its output) changes nothing."""
    idx, dead = port_index
    rows, q = corpus[0], corpus[1][0]
    live = np.setdiff1d(np.arange(3 * PER), dead)
    real = exact_mod._segment_fp32
    merged = []

    def scan_then_merge(seg):
        out = real(seg)
        if not merged:
            merged.append(idx.force_merge())
        return out

    monkeypatch.setattr(exact_mod, "_segment_fp32", scan_then_merge)
    if path == "exact":
        flt = np.arange(0, 3 * PER, 15)[:45]  # a third of them deleted
        res = knn.execute_knn_query(idx, KnnQuery(q, k=K, filter_docs=flt))
        want = _numpy_top(rows, np.intersect1d(live, flt), q, K)
    elif path == "radial":
        floor = _radial_floor(rows, q, "EUCLIDEAN", 0.9)
        res = knn.execute_knn_query(idx, KnnQuery(q, min_score=floor))
        want = _numpy_top(rows, live, q, None, floor)
    else:
        res = knn.execute_script_score(idx, "l2", q, k=K)
        want = _numpy_top(rows, live, q, K)
    assert merged and idx.segment_names == merged
    assert not np.isin(res.doc_ids, dead).any()
    assert_same_up_to_ties(want[0], want[1], res.doc_ids, res.scores)


def test_merge_under_an_on_disk_scan_keeps_the_row_store_open(
        corpus, tmp_path, monkeypatch):
    """An on_disk exact scan pages each segment's whole row file; a merge
    that retires the segment mid-read must not close its row store until
    the scan lets go of it."""
    idx = VectorIndex(tmp_path / "d",
                      tconfig.DiskAnnConfig(**CFG, mode="on_disk"),
                      device="cpu", merge_policy=TForceOnly())
    for s in range(2):
        ids = np.arange(s * PER, (s + 1) * PER)
        idx.add_batch(ids, corpus[0][ids])
        idx.flush()
    old = {n: idx._reader(n).seg.row_store for n in idx.segment_names}
    real = PagedVectorStore.gather
    merged = []

    def gather_after_a_merge(store, ids):
        if not merged and store in old.values():
            merged.append(idx.force_merge())
            assert store.num_rows == PER  # still open
        return real(store, ids)

    monkeypatch.setattr(PagedVectorStore, "gather", gather_after_a_merge)
    q = corpus[1][2]
    flt = np.arange(3, 2 * PER, 13)
    res = knn.execute_knn_query(idx, KnnQuery(q, k=K, filter_docs=flt))
    want = _numpy_top(corpus[0], flt, q, K)
    assert merged and idx.segment_names == merged
    assert_same_up_to_ties(want[0], want[1], res.doc_ids, res.scores)
    # the retired readers closed their stores once the scan let go
    assert all(s._handle is None and s._mm is None for s in old.values())
    idx.close()


# -- parsing ------------------------------------------------------------------

V = [0.5] * 4
KNN_BODIES = [
    {"vector": V, "k": 5},
    {"vector": V, "k": 3, "filter": [1, 2], "expand_nested_docs": True,
     "ignore_unmapped": True, "rescore": {"oversample_factor": 4.0},
     "method_parameters": {"ef_search": 64, "overquery_factor": 3,
                           "advanced.threshold": 0.1,
                           "advanced.rerank_floor": 0.2,
                           "advanced.use_pruning": True}},
    {"vector": [V, V], "k": 2, "rescore": True},
    {"vector": V, "min_score": 0.5},
    {"vector": V, "max_distance": 2.0, "rescore": False},
    {"k": 5},
    {"vector": V, "k": 0},
    {"vector": V, "k": 10_001},
    {"vector": V},
    {"vector": V, "k": 5, "min_score": 0.3},
    {"vector": V, "k": 5, "bogus": 1},
    {"vector": V, "k": 5, "method_parameters": {"nope": 1}},
    {"vector": V, "k": 5, "method_parameters": {"overquery_factor": 0}},
    {"vector": V, "k": 5, "method_parameters": {"ef_search": 0}},
    {"vector": V, "k": 5, "rescore": {"oversample_factor": 0.5}},
    {"vector": V, "k": 5, "rescore": "yes"},
    {"vector": [[V]], "k": 5},
]


def _outcome(fn, body):
    try:
        out = fn(body)
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__, str(e))
    fields = {}
    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        if isinstance(v, np.ndarray):
            v = (v.dtype.str, v.tolist())
        elif dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        fields[f.name] = v
    return ("ok", fields)


@pytest.mark.parametrize("body", KNN_BODIES, ids=range(len(KNN_BODIES)))
def test_parse_knn_query_matches(body):
    assert _outcome(parse_knn_query, body) == _outcome(jparse, body)


MAPPINGS = [
    {"type": "knn_vector", "dimension": 16},
    {"type": "knn_vector", "dimension": 32, "space_type": "cosinesimil",
     "mode": "on_disk", "data_type": "float",
     "method": {"name": "disk_ann", "engine": "jvector_tpu", "parameters": {
         "m": 24, "ef_construction": 64, "advanced.alpha": 1.3,
         "advanced.neighbor_overflow": 1.5,
         "advanced.hierarchy_enabled": True,
         "advanced.min_batch_size_for_quantization": 512,
         "advanced.num_pq_subspaces": 8,
         "advanced.quantization_type": "pq",
         "advanced.nvq.num_subvectors": 4,
         "advanced.leading_segment_merge_disabled": True,
         "advanced.pq_anisotropic_threshold": 0.3}}},
    {"type": "knn_vector", "dimension": 48, "space_type": "innerproduct",
     "compression_level": "x16"},
    {"type": "knn_vector", "dimension": 16, "space_type": "undefined"},
    {"type": "dense_vector", "dimension": 16},
    {"type": "knn_vector"},
    {"type": "knn_vector", "dimension": 16, "space_type": "l1"},
    {"type": "knn_vector", "dimension": 16, "space_type": "l9"},
    {"type": "knn_vector", "dimension": 16, "mode": "on_tape"},
    {"type": "knn_vector", "dimension": 16, "data_type": "byte"},
    {"type": "knn_vector", "dimension": 16, "data_type": "half"},
    {"type": "knn_vector", "dimension": 16, "compression_level": "x2"},
    {"type": "knn_vector", "dimension": 16, "compression_level": "x3"},
    {"type": "knn_vector", "dimension": 16, "method": {"name": "ivf"}},
    {"type": "knn_vector", "dimension": 16, "method": {"engine": "faiss"}},
    {"type": "knn_vector", "dimension": 16,
     "method": {"parameters": {"m": 8, "lists": 4}}},
    {"type": "knn_vector", "dimension": 0},
]


def _mapping_outcome(fn, body):
    try:
        config, extras = fn(body)
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return ("error", type(e).__name__, str(e))
    return ("ok", config.to_meta(), extras)


@pytest.mark.parametrize("body", MAPPINGS, ids=range(len(MAPPINGS)))
def test_parse_knn_vector_mapping_matches(body):
    assert (_mapping_outcome(parse_knn_vector_mapping, body)
            == _mapping_outcome(jparse_mapping, body))
