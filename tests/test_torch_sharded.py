"""Port parity for sharded search: `parallel/sharded.py` (the mesh engine
over a device list), `parallel/distributed.py` (`ShardedVectorIndex`), the
REST service's `number_of_shards` and `mesh`, gRPC over a sharded index,
and the dry run (`parallel/dryrun.py`).

The JAX package's `ShardedVectorIndex` writes 3-shard directories of five
kinds (PQ, `nvq+pq`, `1bit`, fp32, on_disk PQ), each searched by it on a
3-device slice of the virtual CPU mesh after one flush (G = 1) and after a
second flush and five deletes (G = 2). The port opens each directory with
a mesh of ["cpu"] * 3 and answers the same 16 queries: doc ids equal up to
score ties, scores within rtol 1e-5 / atol 1e-6, and the visited,
expanded and reranked counters equal (16 queries: the JAX package pads no
batch). The on_disk kind runs the approx-only phase and the paged rerank
on both sides; the approximate phases are also held to each other alone.
A directory the port writes is read by the JAX package the same way.
The query layer (exact fallback, radial, script, rescore, nested, MMR)
runs over both packages' sharded indexes on one directory.

The port's own behaviour is held to expected values: mesh against host
fan-out recall within 0.05; the reject reasons and the compaction that
brings an over-cap shard back; the partial restack (only the changed
shard is gathered again); `homogenize_pq`'s per-shard cache; a merge
swapped in during a mesh search (no deleted doc comes back, and no row
store is gathered from after it was closed).
"""

import contextlib
import http.client
import json
import shutil
import threading

import grpc
import jax
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.api.config import DiskAnnConfig as JConfig
from opensearch_jvector_tpu.api.config import SearchConfig as JSearch
from opensearch_jvector_tpu.parallel import sharded as jsharded
from opensearch_jvector_tpu.parallel.distributed import (
    ShardedVectorIndex as JSharded,
)
from opensearch_jvector_tpu.query import knn as jknn
from opensearch_jvector_tpu.query import mmr as jmmr
from opensearch_jvector_tpu.query.builder import KnnQuery as JQuery
from opensearch_jvector_tpu.query.builder import Rescore as JRescore
from opensearch_jvector_tpu.service.http import KnnService as JService
from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig, SearchConfig
from opensearch_jvector_tpu_torch.api.stats import Counter
from opensearch_jvector_tpu_torch.grpc import knn_query_pb2 as pb
from opensearch_jvector_tpu_torch.grpc.server import KnnGrpcService, search_stub
from opensearch_jvector_tpu_torch.index.scheduler import (
    ForceMergesOnlyMergePolicy,
    TieredMergePolicy,
)
from opensearch_jvector_tpu_torch.models import pq as tpq
from opensearch_jvector_tpu_torch.models.searcher import SearchParams
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.parallel import sharded
from opensearch_jvector_tpu_torch.parallel.distributed import ShardedVectorIndex
from opensearch_jvector_tpu_torch.parallel.dryrun import dryrun
from opensearch_jvector_tpu_torch.query import knn
from opensearch_jvector_tpu_torch.query import mmr
from opensearch_jvector_tpu_torch.query.builder import KnnQuery, Rescore
from opensearch_jvector_tpu_torch.service.http import KnnService
from opensearch_jvector_tpu_torch.utils.ground_truth import (
    ground_truth_topk,
    recall_at_k,
)
from opensearch_jvector_tpu_torch.utils.native_store import PagedVectorStore

torch.set_num_threads(2)

D, S, N, Q, K = 16, 3, 1200, 16, 10
RTOL, ATOL = 1e-5, 1e-6
BASE = dict(dim=D, m=8, ef_construction=32, num_pq_subspaces=8,
            min_batch_size_for_quantization=64)
KINDS = {
    "pq": dict(quantization_type="pq"),
    "nvq": dict(quantization_type="nvq+pq"),
    "1bit": dict(quantization_type="1bit"),
    "fp32": dict(quantization_type="none"),
    "on_disk": dict(quantization_type="pq", mode="on_disk"),
}
SC = dict(k=K, ef_search=48)
DEAD = [3, 4, 5, 700, 701]
CPU_MESH = ["cpu"] * S
REJECTS = [c.value for c in Counter if c.name.startswith("KNN_MESH_REJECT")]


def _latent(rng, n):
    a = rng.standard_normal((8, D)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return _latent(rng, N), _latent(rng, Q)


def assert_same_up_to_ties(ids_a, s_a, ids_b, s_b):
    """Scores within RTOL/ATOL; ids differ only where the score is tied."""
    ids_a, s_a = np.asarray(ids_a), np.asarray(s_a)
    assert ids_a.shape == ids_b.shape
    np.testing.assert_allclose(s_a, s_b, rtol=RTOL, atol=ATOL)
    fin = np.where(np.isfinite(s_a), s_a, 0.0)
    tol = ATOL + RTOL * np.abs(fin)
    for r in range(ids_a.shape[0]):
        for j in np.nonzero(ids_a[r] != ids_b[r])[0]:
            tied = np.abs(fin[r] - fin[r, j]) <= 2 * tol[r, j]
            tied[j] = False
            assert tied.any(), (r, j, ids_a[r], ids_b[r])


def assert_same_result(jres, tres, counters=True):
    assert_same_up_to_ties(jres.doc_ids, jres.scores, tres.doc_ids,
                           tres.scores)
    if counters:
        assert ((jres.visited, jres.expanded, jres.reranked)
                == (tres.visited, tres.expanded, tres.reranked))


def _jmesh():
    return jsharded.make_mesh(jax.devices()[:S])


def _port(root, mesh=CPU_MESH, **kw):
    return ShardedVectorIndex(root, device="cpu", mesh=mesh, **kw)


def _no_rejects(idx):
    stats = idx.stats()
    assert not any(stats[r] for r in REJECTS), stats


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory, corpus):
    """kind -> {G: (directory, the JAX package's mesh answer)}."""
    v, q = corpus
    out = {}
    for kind, kw in KINDS.items():
        root = tmp_path_factory.mktemp(kind)
        j = JSharded(root / "g2", JConfig(**BASE, **kw), n_shards=S,
                     mesh=_jmesh())
        j.add_batch(np.arange(600), v[:600])
        j.flush()
        first = j.search(q, JSearch(**SC))
        shutil.copytree(root / "g2", root / "g1")
        j.add_batch(np.arange(600, N), v[600:])
        j.flush()
        j.delete(DEAD)
        second = j.search(q, JSearch(**SC))
        assert j._mesh_state is not None and j._mesh_state.n_segments == 2
        j.close()
        out[kind] = {1: (root / "g1", first), 2: (root / "g2", second)}
    return out


# -- (a) JAX-written shards, the port's mesh search ------------------------

@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_written_shards_search_the_same(jax_dirs, corpus, kind, g):
    root, jres = jax_dirs[kind][g]
    idx = _port(root)
    tres = idx.search(corpus[1], SearchConfig(**SC))
    assert_same_result(jres, tres)
    state = idx._mesh_state
    assert state.n_segments == g and state.approx_only == (kind == "on_disk")
    stats = idx.stats()
    assert stats["knn_mesh_restack_count"] == S
    assert stats["knn_query_count"] == S * Q
    _no_rejects(idx)
    assert not np.isin(tres.doc_ids, DEAD).any()
    idx.close()


def test_approx_phase_matches(jax_dirs, corpus):
    """The on_disk approx-only phase alone: the same candidate docs (up to
    ties of the approximate score) and approximate scores."""
    root, _ = jax_dirs["on_disk"][2]
    j = JSharded(root, mesh=_jmesh())
    jlists, _ = j._mesh_ready_segments()
    jstate = jsharded.stack_engine_state(jlists)
    t = _port(root)
    with contextlib.ExitStack() as pins:
        readers, _, reject = t._mesh_ready_readers(pins)
        assert reject is None
        tstate = sharded.stack_engine_state(
            [[r.seg for r in rs] for rs in readers], t.mesh)
        params = SearchParams(k=K, ef_search=48)
        tdocs, tlocs, tsc, tctr = sharded.sharded_engine_search_approx(
            t.mesh, tstate, torch.from_numpy(corpus[1]), params,
            SimilarityFunction.EUCLIDEAN)
    from opensearch_jvector_tpu.models.searcher import SearchParams as JP
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction as JS
    jdocs, jlocs, jsc, jctr = jsharded.sharded_engine_search_approx(
        j.mesh, jstate, corpus[1], JP(k=K, ef_search=48), JS.EUCLIDEAN)
    assert_same_up_to_ties(jdocs, jsc, tdocs.numpy(), tsc.numpy())
    np.testing.assert_array_equal(np.asarray(jctr)[:, :2], tctr.numpy()[:, :2])
    # each locator addresses its doc: shard * (G * n) + slot * n + ordinal
    g_n, n = tstate.n_segments, tstate.n_local
    locs, docs = tlocs.numpy(), tdocs.numpy()
    ok = locs >= 0
    got = [tstate.ord_to_doc[loc // (g_n * n)][loc // n % g_n][loc % n].item()
           for loc in locs[ok]]
    np.testing.assert_array_equal(got, docs[ok])
    j.close()
    t.close()


def test_port_written_shards_read_by_jax(tmp_path, corpus):
    v, q = corpus
    t = _port(tmp_path, config=DiskAnnConfig(**BASE, quantization_type="pq"),
              n_shards=S)
    for lo, hi in ((0, 600), (600, N)):
        t.add_batch(np.arange(lo, hi), v[lo:hi])
        t.flush()
    t.delete(DEAD)
    tres = t.search(q, SearchConfig(**SC))
    t.close()
    j = JSharded(tmp_path, mesh=_jmesh())
    assert j.n_shards == S
    jres = j.search(q, JSearch(**SC))
    assert j._mesh_state is not None
    assert_same_result(jres, tres)
    j.close()


# -- (b) the query layer over a sharded index ---------------------------------

@pytest.fixture(scope="module")
def nested_dir(tmp_path_factory, corpus):
    """A JAX-written 3-shard PQ index of 900 docs whose docs 0-299 are
    nested children of parents 10,000 + id // 3 (routed by the parent);
    every shard holds >= 256 rows, so all train 256-entry codebooks and
    stack for the mesh."""
    root = tmp_path_factory.mktemp("nested")
    v = corpus[0]
    j = JSharded(root, JConfig(**BASE, quantization_type="pq"), n_shards=S)
    ids = np.arange(900)
    j.add_batch(ids, v[:900],
                parent_ids=np.where(ids < 300, 10_000 + ids // 3, -1))
    j.flush()
    j.delete([7, 400])
    j.close()
    return root


QUERY_KINDS = ["exact", "radial", "script", "rescore", "nested", "mmr"]


@pytest.mark.parametrize("what", QUERY_KINDS)
@pytest.mark.parametrize("mesh", [False, True], ids=["host", "mesh"])
def test_query_layer_over_shards_matches(nested_dir, corpus, what, mesh):
    q = corpus[0][[5, 50, 100, 450]] + 0.01
    j = JSharded(nested_dir, mesh=_jmesh() if mesh else None)
    t = _port(nested_dir, mesh=CPU_MESH if mesh else None)
    if what == "exact":  # 30 ids: the filtered exact fallback
        flt = np.arange(1, 900, 30)
        jres = jknn.execute_knn_query(j, JQuery(q, k=K, filter_docs=flt,
                                                expand_nested_docs=True))
        tres = knn.execute_knn_query(t, KnnQuery(q, k=K, filter_docs=flt,
                                                 expand_nested_docs=True))
        assert np.isin(tres.doc_ids[tres.doc_ids >= 0], flt).all()
    elif what == "radial":
        jres = jknn.execute_knn_query(j, JQuery(q, min_score=0.5))
        tres = knn.execute_knn_query(t, KnnQuery(q, min_score=0.5))
        assert (tres.doc_ids >= 0).sum() > 0
    elif what == "script":
        jres = jknn.execute_script_score(j, "l2", q[0], k=K)
        tres = knn.execute_script_score(t, "l2", q[0], k=K)
        assert t.stats.get(Counter.SCRIPT_QUERY_REQUESTS) == 1
    elif what == "rescore":
        jres = jknn.execute_knn_query(j, JQuery(q, k=K, rescore=JRescore(2.0),
                                                expand_nested_docs=True))
        tres = knn.execute_knn_query(t, KnnQuery(q, k=K, rescore=Rescore(2.0),
                                                 expand_nested_docs=True))
    elif what == "nested":
        assert t.has_nested()
        jres = jknn.execute_knn_query(j, JQuery(q, k=K))
        tres = knn.execute_knn_query(t, KnnQuery(q, k=K))
        row = tres.doc_ids[0][tres.doc_ids[0] >= 0]
        assert (row >= 10_000).any() and len(set(row.tolist())) == row.size
    else:
        jres = jmmr.mmr_search(j, q, K, jmmr.MMRParams(0.5))
        tres = mmr.mmr_search(t, q, K, mmr.MMRParams(0.5))
    assert_same_result(jres, tres, counters=False)
    assert not np.isin(tres.doc_ids, [7, 400]).any()
    if mesh and what in ("rescore", "nested", "mmr"):  # ANN first
        assert t._mesh_state is not None
        _no_rejects(t)
    j.close()
    t.close()


def test_read_side_broadcasts(nested_dir, corpus):
    t = _port(nested_dir, mesh=None)
    ids = np.array([0, 1, 7, 299, 300, 899, 5000])
    vecs, found = t.get_vectors(ids)
    np.testing.assert_array_equal(found, [True, True, False, True, True,
                                          True, False])
    np.testing.assert_array_equal(vecs[found], corpus[0][ids[found]])
    np.testing.assert_array_equal(t.parents_of(ids),
                                  [10_000, 10_000, 10_002, 10_099, -1, -1,
                                   -1])
    names = t.segment_names
    assert len(names) == S and all("::" in n for n in names)
    assert [n for n, _ in t.snapshot()] == names
    assert t.doc_count() == 898 and t.has_deletes
    t.close()


# -- (c) the port's own behaviour -------------------------------------------------

def _pq_index(root, mesh=CPU_MESH, **kw):
    return _port(root, config=DiskAnnConfig(**BASE, quantization_type="pq"),
                 n_shards=S, mesh=mesh, **kw)


def test_mesh_recall_within_the_host_fan_out(tmp_path, corpus):
    v, q = corpus
    idx = _pq_index(tmp_path)
    for lo, hi in ((0, 600), (600, N)):
        idx.add_batch(np.arange(lo, hi), v[lo:hi])
        idx.flush()
    idx.delete(DEAD)
    live = np.setdiff1d(np.arange(N), DEAD)
    truth = live[ground_truth_topk(torch.from_numpy(q),
                                   torch.from_numpy(v[live]), K,
                                   SimilarityFunction.EUCLIDEAN)]
    sc = SearchConfig(**SC)
    mesh_rec = recall_at_k(idx.search(q, sc).doc_ids, truth, K)
    assert idx._mesh_state is not None
    idx.attach_mesh(None)
    host = idx.search(q, sc)
    host_rec = recall_at_k(host.doc_ids, truth, K)
    assert mesh_rec >= 0.9 and abs(mesh_rec - host_rec) <= 0.05
    # the mesh counts a query once a shard, the host loop once a segment
    assert idx.stats()["knn_query_count"] == S * Q + 2 * S * Q
    idx.close()


def _reject_empty(idx, v):
    idx.add_batch(np.arange(0, 300, S), v[:300:S])  # shard 0 only
    idx.flush()


def _reject_buffered(idx, v):
    idx.add_batch(np.arange(300), v[:300])
    idx.flush()
    idx.add(1000, v[1000])


def _reject_stack_shape(idx, v):
    idx.add_batch(np.arange(300), v[:300])
    idx.flush()


@pytest.mark.parametrize("reason,setup,cfg", [
    ("empty_shard", _reject_empty, {}),
    ("buffered_docs", _reject_buffered, {}),
    ("stack_shape", _reject_stack_shape, dict(index_type="flat")),
], ids=["empty_shard", "buffered_docs", "stack_shape"])
def test_rejects_count_their_reason(tmp_path, corpus, reason, setup, cfg):
    v, q = corpus
    idx = _port(tmp_path, config=DiskAnnConfig(**BASE, **cfg), n_shards=S)
    setup(idx, v)
    res = idx.search(q, SearchConfig(**SC))
    assert (res.doc_ids >= 0).any()  # the host fan-out answered
    stats = idx.stats()
    assert stats[f"knn_mesh_reject_{reason}"] == 1
    assert sum(stats[r] for r in REJECTS) == 1
    assert idx._mesh_state is None and stats["knn_mesh_restack_count"] == 0
    idx.close()


def _more(n, seed):
    """n more rows of the corpus's kind (a flush of >= 256 rows a shard
    trains 256-entry codebooks, the shape every stacked segment needs)."""
    return _latent(np.random.default_rng(seed), n)


def test_segment_count_reject_compacts_back_onto_the_mesh(tmp_path, corpus):
    _, q = corpus
    idx = _pq_index(tmp_path, merge_policy=TieredMergePolicy(
        max_segments=8, merge_factor=8))
    cap = ShardedVectorIndex.MESH_MAX_SEGMENTS
    per = 256 * S
    rows = _more((cap + 1) * per, 3)
    for f in range(cap + 1):
        idx.add_batch(np.arange(f * per, (f + 1) * per),
                      rows[f * per: (f + 1) * per])
        idx.flush()
    sc = SearchConfig(**SC)
    idx.search(q, sc)
    assert idx.stats()["knn_mesh_reject_segment_count"] == 1
    idx.await_merges(timeout=120)  # every shard compacted to the cap
    assert all(len(s.segment_names) <= cap for s in idx.shards)
    idx.search(q, sc)
    assert idx._mesh_state is not None
    assert idx.stats()["knn_mesh_restack_count"] == S
    idx.close()


def test_partial_restack_gathers_only_the_changed_shard(tmp_path, corpus):
    v, q = corpus
    idx = _pq_index(tmp_path)
    idx.add_batch(np.arange(N), v)
    idx.flush()
    sc = SearchConfig(**SC)
    idx.search(q, sc)
    before = idx._mesh_state
    # 300 docs routed to shard 0 only: a second segment there, G 1 -> 2
    idx.add_batch(np.arange(N, N + 900, S), _more(300, 4))
    idx.flush()
    res = idx.search(q, sc)
    state = idx._mesh_state
    assert state.n_segments == 2 and state.n_local == before.n_local
    stats = idx.stats()
    assert stats["knn_mesh_restack_count"] == 2 * S
    assert stats["knn_mesh_restack_partial_count"] == S
    # the unchanged shards kept their first slot and got an empty second
    for s in (1, 2):
        assert torch.equal(state.adjacency[s][0], before.adjacency[s][0])
        assert not state.live[s][1].any()
    # a fresh full stack of the same segments answers the same
    lists = [[idx.shards[s]._reader(n).seg for n in idx.shards[s].segment_names]
             for s in range(S)]
    fresh = sharded.stack_engine_state(lists, idx.mesh)
    params = SearchParams(k=K, ef_search=48)
    a = sharded.sharded_engine_search(idx.mesh, state, torch.from_numpy(q),
                                      params, SimilarityFunction.EUCLIDEAN)
    b = sharded.sharded_engine_search(idx.mesh, fresh, torch.from_numpy(q),
                                      params, SimilarityFunction.EUCLIDEAN)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(res.doc_ids, a[0].numpy())
    idx.close()


def test_homogenize_pq_caches_per_shard(tmp_path, corpus):
    """A small fp32 flush beside PQ segments rides synthetic codes of the
    donor's codebooks; its name repeats in every shard, and each shard's
    cache entry encodes that shard's own rows."""
    v, q = corpus
    idx = _pq_index(tmp_path)
    idx.add_batch(np.arange(600), v[:600])
    idx.flush()
    idx.add_batch(np.arange(600, 690), v[600:690])  # 30 a shard < 64
    idx.flush()
    res = idx.search(q, SearchConfig(**SC))
    _no_rejects(idx)
    small = [s.segment_names[1] for s in idx.shards]
    assert len(set(small)) == 1
    cache = idx._synth_pq_cache
    assert sorted(cache) == [(s, small[0]) for s in range(S)]
    for s in range(S):
        seg = idx.shards[s]._reader(small[s]).seg
        assert seg.pqv is None
        pqv = cache[(s, small[s])]
        np.testing.assert_array_equal(
            pqv.codes.numpy(),
            tpq.encode(pqv.pq, seg.vectors, SimilarityFunction.EUCLIDEAN)
            .numpy())
    codes = [cache[(s, small[s])].codes[:30] for s in range(S)]
    assert not torch.equal(codes[0], codes[1])
    truth = ground_truth_topk(torch.from_numpy(q), torch.from_numpy(v[:690]),
                              K, SimilarityFunction.EUCLIDEAN)
    assert recall_at_k(res.doc_ids, truth, K) >= 0.9
    idx.close()


def test_a_merge_swapped_in_during_a_mesh_search(tmp_path, corpus,
                                                 monkeypatch):
    """on_disk shards: the search snapshots shard 0's names and
    tombstones, then a force_merge of shard 0 swaps its set (folding the
    tombstones) before the accept masks and the paged rerank run."""
    v, q = corpus
    idx = _port(tmp_path, config=DiskAnnConfig(
        **BASE, quantization_type="pq", mode="on_disk"), n_shards=S,
        merge_policy=ForceMergesOnlyMergePolicy())
    for lo, hi in ((0, 600), (600, N)):
        idx.add_batch(np.arange(lo, hi), v[lo:hi])
        idx.flush()
    dead = np.arange(0, N, S)[::4]  # shard 0's docs, every fourth
    idx.delete(dead)
    events = []
    for name in ("gather", "close"):
        real = getattr(PagedVectorStore, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            events.append((_name, id(self)))
            return _real(self, *a, **kw)

        monkeypatch.setattr(PagedVectorStore, name, spy)
    real_homog = sharded.homogenize_pq
    merged = []

    def merge_first(lists, *a, **kw):
        if not merged:
            merged.append(idx.shards[0].force_merge())
        return real_homog(lists, *a, **kw)

    monkeypatch.setattr(sharded, "homogenize_pq", merge_first)
    # queries at the deleted docs' own rows
    res = idx.search(v[dead[:Q]], SearchConfig(**SC))
    assert merged and idx.shards[0].segment_names == merged
    assert not np.isin(res.doc_ids, dead).any()
    closed = set()
    for what, store in events:
        if what == "close":
            closed.add(store)
        else:
            assert store not in closed  # never gathered after its close
    assert closed  # the retired stores closed, after the search
    res2 = idx.search(v[dead[:Q]], SearchConfig(**SC))
    assert not np.isin(res2.doc_ids, dead).any()
    idx.close()


def test_cuda_devices_without_a_card_raise(tmp_path):
    if torch.cuda.is_available():
        assert sharded.make_mesh(["cuda:0"] * 2)[1].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedVectorIndex(tmp_path, DiskAnnConfig(dim=D), device="cuda")
    for fn in (lambda: sharded.make_mesh(["cuda:0"] * 2),
               lambda: sharded.make_mesh(None),
               lambda: dryrun(["cuda:0"] * 4)):
        with pytest.raises(RuntimeError):
            fn()


def test_dryrun_on_a_cpu_mesh():
    dryrun(["cpu"] * 4)


def test_simple_sharded_search_matches(corpus):
    """`build_sharded` + the simple `sharded_search` (the dry run's path):
    the port's round-robin shard graphs, searched by both packages'
    `sharded_search`, give the same global ordinals up to score ties, and
    the ordinals map back through the global ids to the exact neighbours."""
    from opensearch_jvector_tpu.models.searcher import SearchParams as JP
    from opensearch_jvector_tpu.ops.distances import SimilarityFunction as JS
    from opensearch_jvector_tpu_torch.models.builder import GraphIndexBuilder

    v, q = corpus[0][:1000], corpus[1]
    euclid = SimilarityFunction.EUCLIDEAN
    adj, live, ent, vecs, gids = sharded.build_sharded(
        v, S, lambda: GraphIndexBuilder(D, max_degree=8, beam_width=32),
        euclid, device="cpu")
    n_local = -(-1000 // S)
    assert adj.shape[:2] == (S, n_local) and gids.shape == (S, n_local)
    assert int(live.sum()) == 1000
    np.testing.assert_array_equal(vecs[live].numpy(), v[gids[live.numpy()]])
    params = SearchParams(k=K, ef_search=48)
    tids, tsc = sharded.sharded_search(CPU_MESH, adj, live, ent, vecs,
                                       torch.from_numpy(q), params, euclid)
    jids, jsc = jsharded.sharded_search(
        _jmesh(), adj.numpy(), live.numpy(), ent.numpy().astype(np.int32),
        vecs.numpy(), q, JP(k=K, ef_search=48), JS.EUCLIDEAN)
    assert_same_up_to_ties(np.asarray(jids), np.asarray(jsc), tids.numpy(),
                           tsc.numpy())
    rows = gids.reshape(-1)[tids.numpy()]
    truth = ground_truth_topk(torch.from_numpy(q), torch.from_numpy(v), K,
                              euclid)
    assert recall_at_k(rows, truth, K) >= 0.9


# -- (d) REST and gRPC ---------------------------------------------------------

PARAMS = {"m": 8, "ef_construction": 32, "advanced.num_pq_subspaces": 8,
          "advanced.min_batch_size_for_quantization": 64}
MAPPING = {"properties": {"vec": {
    "type": "knn_vector", "dimension": D, "space_type": "l2",
    "method": {"name": "disk_ann", "engine": "jvector",
               "parameters": PARAMS}}}}
SHARDED = {"settings": {"index": {"number_of_shards": S}},
           "mappings": MAPPING}


def _req(svc, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", svc.port, timeout=300)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    data = json.loads(r.read())
    conn.close()
    return r.status, data


def _hits(body):
    return [(h["_id"], h["_score"]) for h in body["hits"]["hits"]]


@pytest.mark.parametrize("mesh", [False, True], ids=["host", "mesh"])
def test_service_serves_sharded_indexes_as_the_jax_service(tmp_path, corpus,
                                                           mesh):
    """The JAX service builds /shardy over REST; the port's service
    attaches a copy of its directory through PUT; both answer alike."""
    v, q = corpus
    j = JService(tmp_path / "j", mesh=_jmesh() if mesh else None)
    j.start()
    assert _req(j, "PUT", "/shardy", SHARDED)[1]["shards"] == S
    docs = [{"_id": i, "vec": v[i].tolist()} for i in range(900)]
    _req(j, "POST", "/shardy/_bulk", {"docs": docs})
    _req(j, "POST", "/shardy/_flush")
    _req(j, "DELETE", "/shardy/_doc/17")
    shutil.copytree(tmp_path / "j" / "shardy", tmp_path / "t" / "shardy")
    t = KnnService(tmp_path / "t", device="cpu",
                   mesh=CPU_MESH if mesh else None)
    t.start()
    try:
        def same(method, path, body=None):
            a, b = _req(j, method, path, body), _req(t, method, path, body)
            assert a == b, (method, path, a, b)
            return b[1]

        assert _req(t, "PUT", "/shardy", SHARDED)[1]["shards"] == S
        assert same("GET", "/shardy/_count")["count"] == 899
        got = same("GET", "/shardy")
        assert got["shardy"]["settings"]["index"]["number_of_shards"] == S
        bodies = [
            {"size": K, "query": {"knn": {"vec": {"vector": q[0].tolist(),
                                                  "k": K}}}},
            {"size": K, "query": {"knn": {"vec": {
                "vector": q[1].tolist(), "k": K,
                "rescore": {"oversample_factor": 2.0}}}}},
            {"size": 3, "query": {"script_score": {"script": {
                "source": "knn_score", "lang": "knn",
                "params": {"field": "vec", "space_type": "l2",
                           "query_value": v[17].tolist()}}}}},
        ]
        for body in bodies:
            (sa, a), (sb, b) = (_req(s, "POST", "/shardy/_search", body)
                                for s in (j, t))
            assert sa == sb == 200
            ia, sca = zip(*_hits(a))
            ib, scb = zip(*_hits(b))
            assert_same_up_to_ties(np.array([ia]), np.array([sca]),
                                   np.array([ib]), np.array([scb]))
            assert 17 not in ib
        idx = t.manager.get("shardy")["vec"]
        assert isinstance(idx, ShardedVectorIndex)
        assert (idx._mesh_state is not None) == mesh
        st, stats = _req(t, "GET", "/_plugins/_knn/stats")
        snap = stats["nodes"]["local"]
        assert snap["knn_mesh_restack_count"] == (S if mesh else 0)
        assert snap["knn_query_count"] >= 2 * S
        assert snap["script_query_requests"] >= 1
    finally:
        for svc in (j, t):
            svc.stop()
        t.manager.close()


def test_service_attaches_a_sharded_directory_and_drops_a_wrong_mesh(
        tmp_path, corpus):
    v, q = corpus
    t = KnnService(tmp_path, device="cpu", mesh=CPU_MESH)
    t.start()
    _req(t, "PUT", "/shardy", SHARDED)
    _req(t, "POST", "/shardy/_bulk",
         {"docs": [{"_id": i, "vec": v[i].tolist()} for i in range(300)]})
    _req(t, "POST", "/shardy/_flush")
    t.stop()
    t.manager.close()
    # a service whose mesh has 2 devices: the 3-shard index keeps none;
    # the PUT attaches the directory (its own shard count)
    t2 = KnnService(tmp_path, device="cpu", mesh=["cpu"] * 2)
    t2.start()
    try:
        st, out = _req(t2, "PUT", "/shardy", {"mappings": MAPPING})
        assert st == 200
        assert _req(t2, "GET", "/shardy/_count")[1]["count"] == 300
        idx = t2.manager.get("shardy")["vec"]
        assert idx.n_shards == S and idx.mesh is None
        st, out = _req(t2, "POST", "/shardy/_search", {"size": 1, "query": {
            "knn": {"vec": {"vector": v[42].tolist(), "k": 1}}}})
        assert out["hits"]["hits"][0]["_id"] == 42
    finally:
        t2.stop()
        t2.manager.close()


def test_grpc_serves_a_sharded_index(tmp_path, corpus):
    v, q = corpus
    t = KnnService(tmp_path, device="cpu", mesh=CPU_MESH)
    t.manager.create("shardy", MAPPING, {"index": {"number_of_shards": S}})
    idx = t.manager.get("shardy")["vec"]
    idx.add_batch(np.arange(600), v[:600])
    idx.flush()
    svc = KnnGrpcService(t.manager)
    svc.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{svc.port}")
    try:
        search = search_stub(channel)
        for i in (5, 250):
            req = pb.SearchRequest(index="shardy", query=pb.QueryContainer(
                knn=pb.KnnQuery(field="vec", k=K,
                                vector=[float(x) for x in v[i]])))
            resp = search(req)
            res = knn.execute_knn_query(idx, KnnQuery(v[i], k=K))
            assert [h.id for h in resp.hits] == res.doc_ids[0].tolist()
            np.testing.assert_array_equal([h.score for h in resp.hits],
                                          res.scores[0])
            assert resp.hits[0].id == i and resp.visited == res.visited > 0
        assert idx._mesh_state is not None
    finally:
        channel.close()
        svc.stop()
        t.manager.close()


def test_concurrent_mesh_searches_and_merges(tmp_path, corpus):
    """Searches on four threads while every shard is force-merged in turn:
    the (state, names) pair stays matched, answers stay valid."""
    v, q = corpus
    idx = _pq_index(tmp_path, merge_policy=ForceMergesOnlyMergePolicy())
    for lo, hi in ((0, 600), (600, N)):
        idx.add_batch(np.arange(lo, hi), v[lo:hi])
        idx.flush()
    idx.delete(DEAD)
    sc = SearchConfig(**SC)
    want = idx.search(q, sc)
    errors, stop = [], threading.Event()

    def searcher():
        while not stop.is_set():
            try:
                res = idx.search(q, sc)
                ids = res.doc_ids
                assert ids.max() < N and not np.isin(ids, DEAD).any()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=searcher) for _ in range(4)]
    for th in threads:
        th.start()
    try:
        for s in range(S):
            idx.shards[s].force_merge()
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=120)
    assert not errors, errors[0]
    res = idx.search(q, sc)
    assert idx._mesh_state.n_segments == 1
    truth = np.setdiff1d(np.arange(N), DEAD)
    assert np.isin(res.doc_ids, truth).all()
    assert recall_at_k(res.doc_ids, want.doc_ids, K) >= 0.8
    idx.close()
