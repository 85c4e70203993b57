"""Port parity for the slice as a whole: VectorIndex add -> flush -> search.

Index directories cross between the packages in both directions: the JAX
package writes, the PyTorch package opens and searches (scan tier and beam
tier), and the other way round. Segment files written by either package
are byte-identical for the same state. The committed BWC fixtures open
and search in the port, and every quantization, anisotropic and hierarchy
option of the config builds and searches (the per-mode parity is in
test_torch_quantizers.py and test_torch_hierarchy.py).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.api import config as jconfig
from opensearch_jvector_tpu.api.settings import GLOBAL_SETTINGS as JSETTINGS
from opensearch_jvector_tpu.index import segment as jsegment
from opensearch_jvector_tpu.index.index import VectorIndex as JIndex
from opensearch_jvector_tpu.index.scheduler import ForceMergesOnlyMergePolicy
from opensearch_jvector_tpu_torch.api import config as tconfig
from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
from opensearch_jvector_tpu_torch.index import segment as tsegment
from opensearch_jvector_tpu_torch.index.index import VectorIndex, resolve_device
from opensearch_jvector_tpu_torch.index.reader import SegmentReader
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.utils.ground_truth import (
    ground_truth_topk,
    recall_at_k,
)

torch.set_num_threads(2)

FIXTURES = Path(__file__).parent / "fixtures"
D, PER_FLUSH, FLUSHES, Q, K = 16, 600, 2, 24, 10
CFG = dict(dim=D, m=12, ef_construction=48, num_pq_subspaces=8,
           min_batch_size_for_quantization=256)
SETTING = "index.knn.advanced.scan_tier_max_codes"


def assert_same_up_to_ties(ids_a, s_a, ids_b, s_b, tol=1e-5):
    """Scores agree; doc ids differ only where the score is tied."""
    np.testing.assert_allclose(s_a, s_b, rtol=tol, atol=tol)
    for r in range(ids_a.shape[0]):
        for j in np.nonzero(ids_a[r] != ids_b[r])[0]:
            tied = np.abs(s_a[r] - s_a[r, j]) <= tol
            tied[j] = False
            assert tied.any(), (r, j, ids_a[r], ids_b[r])


def _assert_same_results(a, b):
    assert_same_up_to_ties(a.doc_ids, a.scores, b.doc_ids, b.scores)
    assert (a.visited, a.expanded, a.reranked) == (
        b.visited, b.expanded, b.reranked)


def _latent(rng, n):
    a = rng.standard_normal((8, D)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return _latent(rng, PER_FLUSH * FLUSHES), _latent(rng, Q)


def _fill(index, vectors):
    for f in range(FLUSHES):
        lo = f * PER_FLUSH
        index.add_batch(np.arange(lo, lo + PER_FLUSH),
                        vectors[lo: lo + PER_FLUSH])
        index.flush()


@pytest.fixture(scope="module")
def jax_dir(corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_index")
    idx = JIndex(root, jconfig.DiskAnnConfig(**CFG),
                 merge_policy=ForceMergesOnlyMergePolicy())
    _fill(idx, corpus[0])
    idx.close()
    return root


@pytest.fixture(scope="module")
def port_dir(corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp("port_index")
    idx = VectorIndex(root, tconfig.DiskAnnConfig(**CFG), device="cpu")
    _fill(idx, corpus[0])
    idx.close()
    return root


@pytest.fixture
def beam_tier():
    """Both packages route every segment to the beam tier."""
    GLOBAL_SETTINGS.put(SETTING, 0)
    JSETTINGS.put(SETTING, 0)
    try:
        yield
    finally:
        GLOBAL_SETTINGS.put(SETTING, -1)
        JSETTINGS.put(SETTING, -1)


def _both(root):
    return (JIndex(root, merge_policy=ForceMergesOnlyMergePolicy()),
            VectorIndex(root, device="cpu"))


def test_port_opens_jax_index_scan_tier(corpus, jax_dir):
    jidx, tidx = _both(jax_dir)
    assert tidx.segment_names == jidx.segment_names
    assert all(tidx._reader(n).seg.pqv is not None
               for n in tidx.segment_names)
    sc = tconfig.SearchConfig(k=K)
    _assert_same_results(jidx.search(corpus[1], jconfig.SearchConfig(k=K)),
                         tidx.search(corpus[1], sc))


def test_port_opens_jax_index_beam_tier(corpus, jax_dir, beam_tier):
    jidx, tidx = _both(jax_dir)
    got = tidx.search(corpus[1], tconfig.SearchConfig(k=K))
    assert got.expanded > 0  # really the beam tier
    _assert_same_results(
        jidx.search(corpus[1], jconfig.SearchConfig(k=K)), got)


def test_jax_opens_port_index(corpus, port_dir):
    jidx, tidx = _both(port_dir)
    assert jidx.segment_names == tidx.segment_names
    _assert_same_results(jidx.search(corpus[1], jconfig.SearchConfig(k=K)),
                         tidx.search(corpus[1], tconfig.SearchConfig(k=K)))


def test_jax_opens_port_index_beam_tier(corpus, port_dir, beam_tier):
    jidx, tidx = _both(port_dir)
    _assert_same_results(jidx.search(corpus[1], jconfig.SearchConfig(k=K)),
                         tidx.search(corpus[1], tconfig.SearchConfig(k=K)))


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


def test_segment_bytes_identical_both_ways(jax_dir, port_dir, tmp_path):
    """Rewriting a segment read from the other package reproduces its
    files byte for byte."""
    jname = JIndex(jax_dir).segment_names[0]
    seg = tsegment.read_segment(jax_dir / jname, "cpu")
    tsegment.write_segment(tmp_path / "t", seg)
    assert _files(tmp_path / "t" / jname) == _files(jax_dir / jname)

    tname = VectorIndex(port_dir, device="cpu").segment_names[0]
    jseg = jsegment.read_segment(port_dir / tname)
    jsegment.write_segment(tmp_path / "j", jseg)
    assert _files(tmp_path / "j" / tname) == _files(port_dir / tname)


@pytest.mark.parametrize("beam", [False, True], ids=["scan", "beam"])
def test_port_end_to_end_recall(corpus, port_dir, beam):
    vectors, queries = corpus
    if beam:
        GLOBAL_SETTINGS.put(SETTING, 0)
    try:
        res = VectorIndex(port_dir, device="cpu").search(
            queries, tconfig.SearchConfig(k=K))
    finally:
        GLOBAL_SETTINGS.put(SETTING, -1)
    truth = ground_truth_topk(torch.from_numpy(queries),
                              torch.from_numpy(vectors), K,
                              SimilarityFunction.EUCLIDEAN)
    assert recall_at_k(res.doc_ids, truth, K) >= 0.95
    assert np.isfinite(res.scores).all() and res.doc_ids.shape == (Q, K)


def test_jax_deletes_are_honoured(corpus, jax_dir, tmp_path):
    """Tombstones committed by the reference mask docs in the port."""
    root = tmp_path / "idx"
    shutil.copytree(jax_dir, root)
    jidx = JIndex(root, merge_policy=ForceMergesOnlyMergePolicy())
    queries = corpus[0][:4]
    jidx.delete([0, 1, 2, 3])
    res = VectorIndex(root, device="cpu").search(queries,
                                                 tconfig.SearchConfig(k=K))
    assert not np.isin(res.doc_ids, [0, 1, 2, 3]).any()
    _assert_same_results(jidx.search(queries, jconfig.SearchConfig(k=K)),
                         res)


@pytest.mark.parametrize("beam", [False, True], ids=["scan", "beam"])
def test_reader_masks_follow_changing_tombstones(beam, corpus, port_dir):
    """A reader keeps its device masks between searches and rebuilds them
    when the tombstones change: each search equals a fresh reader's."""
    name = VectorIndex(port_dir, device="cpu").segment_names[0]
    reader = SegmentReader.open(port_dir / name, "cpu")
    queries, sc = corpus[0][:4], tconfig.SearchConfig(k=K)
    GLOBAL_SETTINGS.put(SETTING, 0 if beam else -1)
    try:
        for dead in (set(), {0, 1, 2, 3}, {2}, set()):
            got = reader.search(queries, sc, deleted_docs=dead)
            want = SegmentReader.open(port_dir / name, "cpu").search(
                queries, sc, deleted_docs=dead)
            _assert_same_results(want, got)
            assert not np.isin(got.doc_ids, list(dead)).any()
            assert np.isin(list({0, 1, 2, 3} - dead), got.doc_ids).all()
    finally:
        GLOBAL_SETTINGS.put(SETTING, -1)


def test_reflush_supersedes_earlier_copy(tmp_path):
    rng = np.random.default_rng(1)
    v = _latent(rng, 300)
    idx = VectorIndex(tmp_path, tconfig.DiskAnnConfig(**CFG), device="cpu")
    idx.add_batch(np.arange(300), v)
    idx.flush()
    far = v[:1] + 100.0
    idx.add(7, far[0])
    idx.flush()
    res = idx.search(np.concatenate([far, v[7:8]]), tconfig.SearchConfig(k=3))
    assert res.doc_ids[0, 0] == 7
    assert 7 not in res.doc_ids[1].tolist()
    reopened = JIndex(tmp_path, merge_policy=ForceMergesOnlyMergePolicy())
    assert reopened.deleted_docs_for(idx.segment_names[0]) == {7}


def test_bwc_v1_fixture_opens_and_searches():
    seg_dir = FIXTURES / "bwc_v1_segment_root" / "v1seg"
    v = np.load(FIXTURES / "bwc_v1_vectors.npy")
    assert tsegment.check_integrity(seg_dir)
    seg = tsegment.read_segment(seg_dir, "cpu")
    assert seg.docmap.num_ordinals == 50 and seg.capacity() >= 50
    np.testing.assert_array_equal(seg.vectors[:50].numpy(), v)
    res = SegmentReader(seg).search(v[:4], tconfig.SearchConfig(
        k=3, ef_search=32))
    assert (res.doc_ids[np.arange(4), 0] == np.arange(4)).all()


def test_bwc_v2_scalar_fixture_names_its_roadmap_item():
    """The fixture's ROADMAP item ("Other quantizers") is done: the scalar
    segment opens and searches."""
    seg_dir = FIXTURES / "bwc_v2_segment_root" / "v2seg"
    v = np.load(FIXTURES / "bwc_v2_vectors.npy")
    assert tsegment.check_integrity(seg_dir)
    seg = tsegment.read_segment(seg_dir, "cpu")
    assert seg.quantization_type in ("1bit", "2bit", "4bit")
    assert seg.scalar_codes.shape[0] == seg.capacity()
    res = SegmentReader(seg).search(v[:4], tconfig.SearchConfig(
        k=3, ef_search=32))
    assert (res.doc_ids[np.arange(4), 0] == np.arange(4)).all()
    assert res.expanded > 0 and res.reranked > 0  # Hamming beam, fp32 rerank


@pytest.mark.parametrize("kw", [
    dict(quantization_type="nvq+pq"),
    dict(quantization_type="1bit"),
    dict(hierarchy_enabled=True),
    dict(pq_anisotropic_threshold=0.5,
         similarity=SimilarityFunction.DOT_PRODUCT),
], ids=["nvq", "1bit", "hierarchy", "aniso"])
def test_unported_configs_raise(kw, corpus, tmp_path):
    """No config is unported any more and none raises: each option that
    the config accepts flushes, reopens and finds a stored row as its own
    nearest neighbour."""
    vectors = corpus[0][:PER_FLUSH]
    idx = VectorIndex(tmp_path, tconfig.DiskAnnConfig(**{**CFG, **kw}),
                      device="cpu")
    idx.add_batch(np.arange(PER_FLUSH), vectors)
    name = idx.flush()
    seg = idx._reader(name).seg
    assert seg.quantization_type == kw.get("quantization_type", "pq")
    assert (seg.graph.upper_adjacency is not None) == bool(
        kw.get("hierarchy_enabled"))
    assert (seg.pqv is not None and seg.pqv.pq.aniso_eta is not None) == (
        "pq_anisotropic_threshold" in kw)
    idx.close()
    sc = tconfig.SearchConfig(k=3, overquery_factor=20)
    res = VectorIndex(tmp_path, device="cpu").search(vectors[:8], sc)
    if kw.get("similarity") is None:
        assert (res.doc_ids[:, 0] == np.arange(8)).all()
    else:  # inner product: a longer row can outscore the query's own
        truth = ground_truth_topk(torch.from_numpy(vectors[:8]),
                                  torch.from_numpy(vectors), 3,
                                  kw["similarity"])
        assert recall_at_k(res.doc_ids, truth, 3) >= 0.9


def test_absent_cuda_device_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")


@pytest.mark.parametrize("quant", ["none", "pq"])
def test_flat_segments_cross_both_ways(quant, corpus, tmp_path):
    """Graph-less ('flat') segments serve through the scan tier: exact fp32
    rows without quantization, the ADC scan with PQ."""
    vectors, queries = corpus
    cfg = dict(CFG, index_type="flat", quantization_type=quant)
    jidx = JIndex(tmp_path / "j", jconfig.DiskAnnConfig(**cfg),
                  merge_policy=ForceMergesOnlyMergePolicy())
    tidx = VectorIndex(tmp_path / "t", tconfig.DiskAnnConfig(**cfg),
                       device="cpu")
    for idx in (jidx, tidx):
        idx.add_batch(np.arange(PER_FLUSH), vectors[:PER_FLUSH])
        idx.flush()
    for root in (tmp_path / "j", tmp_path / "t"):
        a, b = _both(root)
        _assert_same_results(
            a.search(queries, jconfig.SearchConfig(k=K)),
            b.search(queries, tconfig.SearchConfig(k=K)))


def test_segment_from_numpy_matches_jax_reader(corpus, jax_dir):
    """The numpy route for whole segments: the JAX segment's arrays become
    a port Segment that searches like the JAX reader."""
    from opensearch_jvector_tpu.index.reader import SegmentReader as JReader
    from opensearch_jvector_tpu_torch.convert import segment_from_numpy

    name = JIndex(jax_dir).segment_names[0]
    js = jsegment.read_segment(jax_dir / name)
    seg = segment_from_numpy(
        name, js.config.to_meta(), np.asarray(js.graph.adjacency),
        np.asarray(js.graph.degrees), np.asarray(js.graph.live),
        np.asarray(js.graph.entry), js.docmap.ord_to_doc,
        vectors=np.asarray(js.vectors),
        codebooks=np.asarray(js.pqv.pq.codebooks),
        center=np.asarray(js.pqv.pq.center), codes=np.asarray(js.pqv.codes),
        device="cpu")
    _assert_same_results(
        JReader(js).search(corpus[1], jconfig.SearchConfig(k=K)),
        SegmentReader(seg).search(corpus[1], tconfig.SearchConfig(k=K)))


@pytest.mark.parametrize("simf", [SimilarityFunction.DOT_PRODUCT,
                                  SimilarityFunction.COSINE],
                         ids=lambda s: s.name)
def test_other_similarities_cross(simf, corpus, tmp_path, beam_tier):
    """Dot-product and cosine PQ segments: the JAX package writes, the port
    opens; both tiers agree (beam via the fixture, scan via the setting)."""
    vectors, queries = corpus
    cfg = dict(CFG, similarity=jconfig.SimilarityFunction(simf.value))
    jidx = JIndex(tmp_path, jconfig.DiskAnnConfig(**cfg),
                  merge_policy=ForceMergesOnlyMergePolicy())
    jidx.add_batch(np.arange(PER_FLUSH), vectors[:PER_FLUSH])
    jidx.flush()
    tidx = VectorIndex(tmp_path, device="cpu")
    assert tidx.config.similarity is simf
    for bound in (0, -1):  # beam tier, then scan tier
        GLOBAL_SETTINGS.put(SETTING, bound)
        JSETTINGS.put(SETTING, bound)
        _assert_same_results(
            jidx.search(queries, jconfig.SearchConfig(k=K)),
            tidx.search(queries, tconfig.SearchConfig(k=K)))


@pytest.mark.parametrize("beam", [False, True], ids=["scan", "beam"])
def test_accept_docs_filter_matches(beam, corpus, jax_dir, request):
    if beam:
        request.getfixturevalue("beam_tier")
    jidx, tidx = _both(jax_dir)
    accept = np.arange(0, PER_FLUSH * FLUSHES, 3)
    got = tidx.search(corpus[1], tconfig.SearchConfig(k=K),
                      accept_docs=accept)
    assert np.isin(got.doc_ids[got.doc_ids >= 0], accept).all()
    _assert_same_results(
        jidx.search(corpus[1], jconfig.SearchConfig(k=K), accept_docs=accept),
        got)


def test_sort_map_remaps_doc_ids(corpus, tmp_path):
    vectors, _ = corpus
    n = 300
    smap = np.arange(n)[::-1].copy()  # old doc id -> new doc id
    idx = VectorIndex(tmp_path, tconfig.DiskAnnConfig(**CFG), device="cpu")
    idx.add_batch(np.arange(n), vectors[:n])
    idx.flush(sort_map=smap)
    res = idx.search(vectors[:4], tconfig.SearchConfig(k=1))
    np.testing.assert_array_equal(res.doc_ids[:, 0], smap[:4])
    jres = JIndex(tmp_path).search(vectors[:4], jconfig.SearchConfig(k=1))
    np.testing.assert_array_equal(jres.doc_ids[:, 0], smap[:4])
    with pytest.raises(tconfig.ValidationError):
        idx.add_batch(np.arange(n), vectors[:n])
        idx.flush(sort_map=smap[:10])
