"""Port parity for deletes and merges.

The same seeded numpy inputs go through the JAX package and the PyTorch
package. Tolerances:
  * merge policies pick the same segment names for the same sizes (exact);
  * `refine_pq` from the same codebooks and rows: codebooks allclose at
    rtol 1e-4 / atol 1e-5, re-encoded codes equal on >= 99.5 % of entries;
  * `with_capacity` and `mark_deleted` are exact;
  * one index directory with deletes and updates, merged by each package:
    merged segment name, `ord_to_doc`, `ord_to_parent` and `live`
    array-equal, `live_doc_ids` / `doc_count` equal, recall@10 against
    exact ground truth over the live rows within 0.03 of each other and
    >= 0.90, and each package opens the other's merged segment;
  * `add_nodes` onto one JAX-built graph in both packages: recall@10
    within 0.03 and >= 0.90, plus structural invariants (degree <= cap, no
    self-loop, no duplicate, no dead neighbour after `cleanup`, every live
    node reachable from the entry);
  * the merge edge cases, update semantics and crash recovery of the JAX
    package's own tests, run on the port;
  * on_disk merges: `rows.f32` byte-equal to the live rows in order.
Every wait on a background merge has a timeout, so a hang fails.
"""

import collections
import json
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.api import config as jconfig
from opensearch_jvector_tpu.api.settings import GLOBAL_SETTINGS as JSETTINGS
from opensearch_jvector_tpu.index import scheduler as jscheduler
from opensearch_jvector_tpu.index import segment as jsegment
from opensearch_jvector_tpu.index.index import VectorIndex as JIndex
from opensearch_jvector_tpu.models import builder as jbuilder
from opensearch_jvector_tpu.models import pq as jpq
from opensearch_jvector_tpu.ops.distances import SimilarityFunction as JSim
from opensearch_jvector_tpu_torch.api import config as tconfig
from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
from opensearch_jvector_tpu_torch.api.stats import Counter, StatsRegistry
from opensearch_jvector_tpu_torch.convert import graph_from_numpy, pq_from_numpy
from opensearch_jvector_tpu_torch.index import merge as tmerge
from opensearch_jvector_tpu_torch.index import scheduler as tscheduler
from opensearch_jvector_tpu_torch.index import segment as tsegment
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.reader import SegmentReader
from opensearch_jvector_tpu_torch.models import builder as tbuilder
from opensearch_jvector_tpu_torch.models import pq as tpq
from opensearch_jvector_tpu_torch.models import searcher as tsearcher
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.utils.ground_truth import (
    ground_truth_topk,
    recall_at_k,
)

torch.set_num_threads(2)

DIM = 16
WAIT = 300.0  # seconds a test waits for one background merge
SCAN_SETTING = "index.knn.advanced.scan_tier_max_codes"
EUCLID = SimilarityFunction.EUCLIDEAN


def _cfg(mod=tconfig, **kw):
    base = dict(dim=DIM, m=8, ef_construction=32, quantization_type="none")
    base.update(kw)
    return mod.DiskAnnConfig(**base)


def _pq_cfg(mod=tconfig, **kw):
    return _cfg(mod, quantization_type="pq", num_pq_subspaces=4,
                min_batch_size_for_quantization=128, **kw)


def _vectors(n, seed=0, dim=DIM):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(
        np.float32)


def _latent(rng, n, dim=DIM):
    a = rng.standard_normal((8, dim)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, dim))).astype(np.float32)


def _index(root, cfg=None, policy=None, **kw):
    return VectorIndex(root, cfg, device="cpu", merge_policy=policy, **kw)


def _pinned(root, cfg=None):
    """A port index whose merges happen only on force_merge."""
    return _index(root, cfg, tscheduler.ForceMergesOnlyMergePolicy())


def _truth(queries, corpus, k):
    return ground_truth_topk(torch.from_numpy(queries),
                             torch.from_numpy(corpus), k, EUCLID)


@pytest.fixture
def beam_tier():
    """Both packages route every segment to the beam tier."""
    GLOBAL_SETTINGS.put(SCAN_SETTING, 0)
    JSETTINGS.put(SCAN_SETTING, 0)
    try:
        yield
    finally:
        GLOBAL_SETTINGS.put(SCAN_SETTING, -1)
        JSETTINGS.put(SCAN_SETTING, -1)


# -- (a) merge policies and the scheduler -------------------------------------

SIZES = [
    [("a", 5), ("b", 3), ("c", 9)],
    [("a", 5), ("b", 3), ("c", 9), ("d", 1), ("e", 7)],
    [("s%d" % i, (7 * i) % 11) for i in range(9)],
    [("x", 4), ("y", 4), ("z", 4), ("w", 4), ("v", 4), ("u", 4)],
]


@pytest.mark.parametrize("kw", [{}, dict(max_segments=2, merge_factor=3),
                                dict(max_segments=1, merge_factor=1)],
                         ids=["default", "2x3", "1x1"])
def test_tiered_policy_picks_the_same_names(kw):
    for sizes in SIZES:
        assert (tscheduler.TieredMergePolicy(**kw).select(sizes)
                == jscheduler.TieredMergePolicy(**kw).select(sizes))
    assert tscheduler.TieredMergePolicy() == tscheduler.TieredMergePolicy(
        max_segments=4, merge_factor=4)


def test_force_merges_only_policy_selects_nothing():
    for sizes in SIZES:
        assert tscheduler.ForceMergesOnlyMergePolicy().select(sizes) is None
        assert jscheduler.ForceMergesOnlyMergePolicy().select(sizes) is None
    assert tscheduler.ForceMergesOnlyMergePolicy.auto is False
    assert tscheduler.MergePolicy.auto is True


def test_scheduler_reraises_a_failed_merge():
    sched = tscheduler.MergeScheduler()

    def boom():
        raise KeyError("merge failed")

    sched.submit(boom)
    sched.submit(lambda: None)
    with pytest.raises(KeyError, match="merge failed"):
        sched.await_all(timeout=WAIT)
    sched.await_all(timeout=WAIT)  # the failure is reported once
    assert sched.in_flight == 0


# -- (b) refine_pq --------------------------------------------------------------

@pytest.mark.parametrize("simf", list(SimilarityFunction),
                         ids=lambda s: s.name)
def test_refine_pq_matches_jax(simf):
    rng = np.random.default_rng(3)
    base, merged = _latent(rng, 400), _latent(rng, 900) + 0.3
    jsim = JSim(simf.value)
    jlead = jpq.train_pq(jnp.asarray(base), jsim, num_subspaces=4)
    want = jpq.refine_pq(jlead, jnp.asarray(merged), jsim)
    lead = pq_from_numpy(np.asarray(jlead.codebooks),
                         np.asarray(jlead.center), device="cpu")
    got = tpq.refine_pq(lead, torch.from_numpy(merged), simf)
    np.testing.assert_allclose(got.codebooks.numpy(),
                               np.asarray(want.codebooks),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.center.numpy(), np.asarray(want.center),
                               rtol=1e-4, atol=1e-5)
    assert not np.allclose(got.codebooks.numpy(),
                           np.asarray(jlead.codebooks), atol=1e-3)
    jcodes = np.asarray(jpq.encode(want, jnp.asarray(merged), jsim))
    codes = tpq.encode(got, torch.from_numpy(merged), simf).numpy()
    assert (codes == jcodes).mean() >= 0.995


def test_refine_pq_host_corpus_samples_like_jax():
    """More rows than `max_train`: both take the reference's draw. The
    port's host (numpy) corpus is sampled BEFORE centering, so it is held
    to the JAX function on the same sample."""
    rng = np.random.default_rng(4)
    base, merged = _latent(rng, 300), _latent(rng, 700)
    jlead = jpq.train_pq(jnp.asarray(base), JSim.EUCLIDEAN, num_subspaces=4)
    lead = pq_from_numpy(np.asarray(jlead.codebooks),
                         np.asarray(jlead.center), device="cpu")
    sel = np.sort(np.random.default_rng(0).choice(700, 256, replace=False))
    want = jpq.refine_pq(jlead, jnp.asarray(merged[sel]), JSim.EUCLIDEAN)
    got = tpq.refine_pq(lead, merged, EUCLID, max_train=256)
    np.testing.assert_allclose(got.codebooks.numpy(),
                               np.asarray(want.codebooks),
                               rtol=1e-4, atol=1e-5)
    # a tensor corpus centers on ALL rows, then samples: the JAX rule
    want_t = jpq.refine_pq(jlead, jnp.asarray(merged), JSim.EUCLIDEAN,
                           max_train=256)
    got_t = tpq.refine_pq(lead, torch.from_numpy(merged), EUCLID,
                          max_train=256)
    np.testing.assert_allclose(got_t.codebooks.numpy(),
                               np.asarray(want_t.codebooks),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_t.center.numpy(), merged.mean(0),
                               rtol=1e-4, atol=1e-5)


# -- (c) graph state -------------------------------------------------------------

N0, N1, DEG = 600, 400, 12


@pytest.fixture(scope="module")
def graph_corpus():
    rng = np.random.default_rng(0)
    return _latent(rng, N0 + N1), _latent(rng, 24)


@pytest.fixture(scope="module")
def jax_graph(graph_corpus):
    """A JAX-built graph over the first N0 rows, with room for N1 more."""
    return jbuilder.GraphIndexBuilder(
        dim=DIM, max_degree=DEG, beam_width=48, batch_size=256,
    ).build(jnp.asarray(graph_corpus[0][:N0]), JSim.EUCLIDEAN, capacity=1024)


def _port_graph(jg):
    return graph_from_numpy(np.asarray(jg.adjacency), np.asarray(jg.degrees),
                            np.asarray(jg.live), np.asarray(jg.entry),
                            device="cpu")


def _graph_arrays(g):
    if isinstance(g, tbuilder.VamanaGraph):
        return (g.adjacency.numpy(), g.degrees.numpy(), g.live.numpy(),
                int(g.entry))
    return (np.asarray(g.adjacency), np.asarray(g.degrees),
            np.asarray(g.live), int(g.entry))


def test_with_capacity_matches_jax(jax_graph):
    g = _port_graph(jax_graph)
    assert g.with_capacity(512) is g  # never shrinks
    for a, b in zip(_graph_arrays(g.with_capacity(4096)),
                    _graph_arrays(jax_graph.with_capacity(4096))):
        np.testing.assert_array_equal(a, b)
    up = torch.full((g.capacity, 3), 7, dtype=torch.int32)
    grown = tbuilder.VamanaGraph(g.adjacency, g.degrees, g.live, g.entry,
                                 upper_adjacency=up).with_capacity(2048)
    assert grown.upper_adjacency.shape == (2048, 3)
    assert (grown.upper_adjacency[g.capacity:] == -1).all()


def test_mark_deleted_matches_jax(jax_graph):
    dead = np.random.default_rng(1).choice(N0, 40, replace=False)
    g = _port_graph(jax_graph)
    got = tbuilder.GraphIndexBuilder.mark_deleted(g, dead)
    want = jbuilder.GraphIndexBuilder.mark_deleted(jax_graph, dead)
    for a, b in zip(_graph_arrays(got), _graph_arrays(want)):
        np.testing.assert_array_equal(a, b)
    assert bool(g.live[torch.from_numpy(dead)].all())  # input untouched


# -- (e) add_nodes, cleanup, refine_graph ----------------------------------------

def _check_invariants(graph, live_ids, deg_cap=DEG):
    adj, deg, live, entry = _graph_arrays(graph)
    assert sorted(np.nonzero(live)[0]) == sorted(live_ids)
    assert (deg <= deg_cap).all()
    for i in np.nonzero(live)[0]:
        row = adj[i][adj[i] >= 0]
        assert i not in row  # no self-loop
        assert np.unique(row).size == row.size  # no duplicate neighbour
        assert live[row].all()  # no dead neighbour
        assert (adj[i, deg[i]:] == -1).all() and row.size == deg[i]
    assert live[entry]
    seen = {entry}
    todo = collections.deque([entry])
    while todo:
        for j in adj[todo.popleft()]:
            if j >= 0 and live[j] and j not in seen:
                seen.add(int(j))
                todo.append(int(j))
    assert len(seen) == len(live_ids)  # all reachable from the entry


def _graph_recall(graph, vectors, queries, live_ids):
    """recall@10 of the port's beam search over `graph` against exact
    ground truth over the live rows."""
    adj, deg, live, entry = _graph_arrays(graph)
    g = graph_from_numpy(adj, deg, live, entry, device="cpu")
    rows = torch.zeros((g.capacity, DIM))
    rows[: vectors.shape[0]] = torch.from_numpy(vectors)
    res = tsearcher.search(
        g.adjacency, g.live, g.entry, torch.from_numpy(queries),
        tsearcher.SearchParams(k=10, ef_search=48), EUCLID, vectors=rows)
    live_ids = np.asarray(live_ids)
    truth = live_ids[_truth(queries, vectors[live_ids], 10)]
    return recall_at_k(res.ids.numpy(), truth, 10)


@pytest.mark.parametrize("tombstones", [False, True],
                         ids=["clean", "tombstones"])
def test_add_nodes_onto_jax_graph_within_band_of_jax(tombstones, graph_corpus,
                                                     jax_graph):
    vectors, queries = graph_corpus
    new_ids = np.arange(N0, N0 + N1)
    jg, g = jax_graph, _port_graph(jax_graph)
    dead = np.empty(0, np.int64)
    if tombstones:
        dead = np.random.default_rng(2).choice(N0, 60, replace=False)
        dead = dead[dead != int(jax_graph.entry)]
        jg = jbuilder.GraphIndexBuilder.mark_deleted(jg, dead)
        g = tbuilder.GraphIndexBuilder.mark_deleted(g, dead)
    live_ids = np.setdiff1d(np.arange(N0 + N1), dead)
    kw = dict(dim=DIM, max_degree=DEG, beam_width=48, batch_size=256)
    jb = jbuilder.GraphIndexBuilder(**kw)
    jout = jb.cleanup(
        jb.add_nodes(jg, jnp.asarray(vectors), new_ids, JSim.EUCLIDEAN),
        jnp.asarray(vectors), JSim.EUCLIDEAN)
    tb = tbuilder.GraphIndexBuilder(**kw)
    before = [t.clone() for t in (g.adjacency, g.degrees, g.live)]
    added = tb.add_nodes(g, torch.from_numpy(vectors), new_ids, EUCLID)
    assert tb._has_tombstones is tombstones
    for t, b in zip((g.adjacency, g.degrees, g.live), before):
        assert torch.equal(t, b)  # the input graph is left as it was
    assert bool(added.live[torch.from_numpy(new_ids)].all())
    out = tb.cleanup(added, torch.from_numpy(vectors), EUCLID)
    _check_invariants(out, live_ids)
    j_rec = _graph_recall(jout, vectors, queries, live_ids)
    t_rec = _graph_recall(out, vectors, queries, live_ids)
    assert abs(t_rec - j_rec) <= 0.03 and t_rec >= 0.90, (t_rec, j_rec)


def test_delta_chunks_are_full_rounds_then_the_remainder():
    b = tbuilder.GraphIndexBuilder(dim=DIM, batch_size=256)
    assert b._delta_chunks(0) == []
    assert b._delta_chunks(100) == [100]
    assert b._delta_chunks(512) == [256, 256]
    assert b._delta_chunks(700) == [256, 256, 188]


def test_cleanup_replaces_a_dead_entry(graph_corpus, jax_graph):
    """The entry dies: cleanup picks the live node nearest the live mean
    (the reference's rule), splices and keeps everything reachable."""
    vectors, _ = graph_corpus
    g = _port_graph(jax_graph)
    dead = np.unique(np.concatenate(
        [[g.entry], g.adjacency[g.entry].numpy()[:4]]))
    dead = dead[dead >= 0]
    marked = tbuilder.GraphIndexBuilder.mark_deleted(g, dead)
    jmarked = jbuilder.GraphIndexBuilder.mark_deleted(jax_graph, dead)
    kw = dict(dim=DIM, max_degree=DEG, beam_width=48, batch_size=256)
    out = tbuilder.GraphIndexBuilder(**kw).cleanup(
        tbuilder.VamanaGraph(marked.adjacency.clone(), marked.degrees,
                             marked.live, marked.entry),
        torch.from_numpy(vectors[:N0]), EUCLID)
    jout = jbuilder.GraphIndexBuilder(**kw).cleanup(
        jmarked, jnp.asarray(vectors[:N0]), JSim.EUCLIDEAN)
    assert out.entry == int(jout.entry) and out.entry not in dead
    _check_invariants(out, np.setdiff1d(np.arange(N0), dead))


def test_refine_graph_keeps_invariants_and_recall(graph_corpus):
    vectors, queries = graph_corpus
    v = torch.from_numpy(vectors[:N0])
    kw = dict(dim=DIM, max_degree=DEG, beam_width=48, batch_size=256)
    plain = tbuilder.GraphIndexBuilder(**kw).build(v, EUCLID)
    refined = tbuilder.GraphIndexBuilder(refine_passes=1, **kw).build(
        v, EUCLID)
    _check_invariants(refined, np.arange(N0))
    assert not torch.equal(plain.adjacency, refined.adjacency)
    r_plain = _graph_recall(plain, vectors[:N0], queries, np.arange(N0))
    r_ref = _graph_recall(refined, vectors[:N0], queries, np.arange(N0))
    assert r_ref >= r_plain - 0.02 and r_ref >= 0.90, (r_ref, r_plain)


# -- (d) one directory, merged by each package -----------------------------------

K = 10
SHARED = dict(dim=DIM, m=8, ef_construction=32, num_pq_subspaces=4,
              min_batch_size_for_quantization=128)


def _shared_dir(writer, root):
    """Three flushes with nested rows, deletes and updates, written by one
    package -> (doc id -> newest vector, deleted ids)."""
    rng = np.random.default_rng(7)
    v = _latent(rng, 900)
    if writer == "jax":
        idx = JIndex(root, jconfig.DiskAnnConfig(**SHARED),
                     merge_policy=jscheduler.ForceMergesOnlyMergePolicy())
    else:
        idx = _pinned(root, tconfig.DiskAnnConfig(**SHARED))
    newest = {}
    parents = np.where(np.arange(400) % 7 == 0, 5000 + np.arange(400), -1)
    idx.add_batch(np.arange(400), v[:400], parent_ids=parents)
    idx.flush()
    idx.add_batch(np.arange(400, 700), v[400:700])
    idx.flush()
    idx.delete(np.arange(10, 60))  # before the third flush: scoped to 1-2
    # the third flush re-adds 20 deleted docs and updates 20 live ones
    ids3 = np.concatenate([np.arange(700, 860), np.arange(40, 60),
                           np.arange(300, 320)])
    idx.add_batch(ids3, v[700:900] + 0.01)
    idx.flush()
    idx.delete([400, 401, 702])
    idx.close()
    for i in range(700):
        newest[i] = v[i]
    for d, row in zip(ids3, v[700:900] + 0.01):
        newest[int(d)] = row
    dead = (set(range(10, 40)) | {400, 401, 702})
    return {d: r for d, r in newest.items() if d not in dead}


def _merged_recall(idx, sc, queries, live):
    ids = np.array(sorted(live))
    corpus = np.stack([live[int(i)] for i in ids])
    res = idx.search(queries, sc)
    assert np.isin(res.doc_ids, ids).all()  # nothing deleted or superseded
    return recall_at_k(res.doc_ids, ids[_truth(queries, corpus, K)], K)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_same_directory_merged_by_each_package(writer, tmp_path, beam_tier):
    live = _shared_dir(writer, tmp_path / "src")
    shutil.copytree(tmp_path / "src", tmp_path / "by_jax")
    shutil.copytree(tmp_path / "src", tmp_path / "by_port")
    jidx = JIndex(tmp_path / "by_jax",
                  merge_policy=jscheduler.ForceMergesOnlyMergePolicy())
    tidx = _pinned(tmp_path / "by_port")
    assert jidx.has_deletes and tidx.has_deletes
    assert jidx.doc_count() == tidx.doc_count() == len(live)
    jname, tname = jidx.force_merge(), tidx.force_merge()
    assert jname == tname == "merged_3segs_m1"
    assert jidx.segment_names == tidx.segment_names == [tname]
    assert not jidx.has_deletes and not tidx.has_deletes
    assert jidx.doc_count() == tidx.doc_count() == len(live)
    np.testing.assert_array_equal(jidx.live_doc_ids(), tidx.live_doc_ids())
    np.testing.assert_array_equal(tidx.live_doc_ids(), sorted(live))

    # each package opens the other's merged segment
    from_jax = tsegment.read_segment(tmp_path / "by_jax" / jname, "cpu")
    from_port = tsegment.read_segment(tmp_path / "by_port" / tname, "cpu")
    by_jax_reader = jsegment.read_segment(tmp_path / "by_port" / tname)
    assert by_jax_reader.docmap.num_ordinals == from_port.docmap.num_ordinals
    np.testing.assert_array_equal(from_jax.docmap.ord_to_doc,
                                  from_port.docmap.ord_to_doc)
    np.testing.assert_array_equal(from_jax.docmap.ord_to_parent,
                                  from_port.docmap.ord_to_parent)
    assert (from_port.docmap.ord_to_parent >= 0).any()
    np.testing.assert_array_equal(from_jax.graph.live.numpy(),
                                  from_port.graph.live.numpy())
    assert from_jax.capacity() == from_port.capacity()
    assert from_jax.pqv is not None and from_port.pqv is not None
    # the incremental merge kept the lead's ordinals (holes stay -1)
    assert from_port.docmap.num_ordinals > from_port.live_count()
    _check_invariants(from_port.graph,
                      np.nonzero(from_port.graph.live.numpy())[0], deg_cap=8)

    queries = _latent(np.random.default_rng(8), 24)
    j_rec = _merged_recall(jidx, jconfig.SearchConfig(k=K), queries, live)
    t_rec = _merged_recall(tidx, tconfig.SearchConfig(k=K), queries, live)
    assert abs(j_rec - t_rec) <= 0.03 and min(j_rec, t_rec) >= 0.90, (
        j_rec, t_rec)
    # and each searches the other's merged directory
    cross = _merged_recall(_pinned(tmp_path / "by_jax"),
                           tconfig.SearchConfig(k=K), queries, live)
    assert abs(cross - j_rec) <= 0.03 and cross >= 0.90


def test_fifth_flush_starts_a_background_merge_of_four_in_both(tmp_path):
    """The default policy: 4 equal segments stay, the fifth flush hands
    the four smallest to the merge pool, in both packages alike."""
    v = _vectors(500, seed=9)
    jidx = JIndex(tmp_path / "j", _cfg(jconfig))
    tidx = VectorIndex(tmp_path / "t", _cfg(), device="cpu")
    assert type(tidx.merge_policy) is tscheduler.TieredMergePolicy
    for f in range(5):
        for idx in (jidx, tidx):
            idx.add_batch(np.arange(f * 100, (f + 1) * 100),
                          v[f * 100: (f + 1) * 100])
            idx.flush()
            if f < 4:
                assert idx.merge_scheduler.in_flight == 0
                assert len(idx.segment_names) == f + 1
    jidx.merge_scheduler.await_all(timeout=WAIT)
    tidx.await_merges(timeout=WAIT)
    assert jidx.segment_names == tidx.segment_names == [
        "merged_4segs_m1", "seg_000004_100"]
    assert jidx.doc_count() == tidx.doc_count() == 500
    res = tidx.search(v[:8], tconfig.SearchConfig(k=1))
    np.testing.assert_array_equal(res.doc_ids[:, 0], np.arange(8))
    jidx.close()
    tidx.close()


# -- (f) the JAX package's merge edge cases, on the port --------------------------

def _add_each(idx, v, lo, hi):
    for i in range(lo, hi):
        idx.add(i, v[i % v.shape[0]])


def test_merge_with_everything_deleted(tmp_path):
    idx = _index(tmp_path, _cfg())
    v = _vectors(200)
    _add_each(idx, v, 0, 200)
    idx.flush()
    idx.delete(list(range(200)))
    idx.force_merge()
    assert idx.doc_count() == 0 and not idx.has_deletes
    res = idx.search(_vectors(2, seed=1), tconfig.SearchConfig(k=5,
                                                               ef_search=32))
    assert (res.doc_ids == -1).all()
    _add_each(idx, v, 200, 260)  # the index keeps working after new ingest
    idx.flush()
    res = idx.search(v[7], tconfig.SearchConfig(k=3, ef_search=32))
    assert (res.doc_ids[0] >= 200).all()


def test_merge_mixed_deleted_segments(tmp_path):
    idx = _index(tmp_path, _cfg())
    v = _vectors(400, seed=2)
    idx.add_batch(np.arange(200), v[:200])
    idx.flush()
    idx.add_batch(np.arange(200, 400), v[200:])
    idx.flush()
    idx.delete(list(range(0, 200)))  # first segment fully dead
    idx.force_merge()
    assert len(idx.segment_names) == 1
    assert idx.doc_count() == 200
    res = idx.search(v[250], tconfig.SearchConfig(k=3, ef_search=32))
    assert res.doc_ids[0][0] == 250


def test_nvq_merge_is_not_ported(tmp_path):
    """NVQ merges are ported (the name dates from when they raised). An
    NVQ merge always rebuilds: the rows are decoded from the
    sources' NVQ bytes, and NVQ and its auxiliary PQ are recomputed over
    them, as the reference's merge does."""
    cfg = _cfg(quantization_type="nvq+pq", num_pq_subspaces=4,
               min_batch_size_for_quantization=128)
    idx = _pinned(tmp_path, cfg)
    v = _latent(np.random.default_rng(5), 500)
    idx.add_batch(np.arange(300), v[:300])
    idx.flush()
    idx.add_batch(np.arange(300, 500), v[300:])
    idx.flush()
    idx.delete(np.arange(0, 50))
    name = idx.force_merge()
    seg = idx._reader(name).seg
    assert seg.quantization_type == "nvq+pq" and seg.vectors is None
    assert seg.docmap.num_ordinals == 450  # a rebuild compacts the ordinals
    assert seg.nvq.bytes_.shape == (seg.capacity(), DIM)
    assert seg.pqv.codes.shape[0] == seg.capacity()
    rec = seg.nvq.decode()[:450].numpy()
    assert np.mean((rec - v[50:]) ** 2) < 1e-3 * np.mean(v ** 2)
    res = idx.search(v[60:68], tconfig.SearchConfig(k=3))
    assert (res.doc_ids[:, 0] == np.arange(60, 68)).all()
    assert not np.isin(res.doc_ids, np.arange(50)).any()


def _two_flushes(tmp_path, cfg, first, second, seed):
    idx = _pinned(tmp_path, cfg)
    v = _vectors(first + second, seed=seed)
    idx.add_batch(np.arange(first), v[:first])
    idx.flush()
    idx.add_batch(np.arange(first, first + second), v[first:])
    idx.flush()
    return idx, v


def test_leading_merge_disabled_forces_rebuild(tmp_path):
    idx, v = _two_flushes(
        tmp_path, _pq_cfg(leading_segment_merge_disabled=True), 500, 100, 4)
    idx.delete([3, 4])
    idx.force_merge()
    seg = tsegment.read_segment(tmp_path / idx.segment_names[0], "cpu")
    # a full rebuild compacts: used ordinals == live count
    assert seg.docmap.num_ordinals == seg.live_count() == 598
    res = idx.search(v[550], tconfig.SearchConfig(k=3, ef_search=48))
    assert res.doc_ids[0][0] == 550


def test_incremental_merge_keeps_capacity_structure(tmp_path):
    idx, v = _two_flushes(tmp_path, _pq_cfg(), 500, 100, 5)
    lead = tsegment.read_segment(tmp_path / idx.segment_names[0], "cpu")
    idx.delete([3, 4])
    idx.force_merge()
    seg = tsegment.read_segment(tmp_path / idx.segment_names[0], "cpu")
    # incremental path: the lead's 500 used ordinals + 100 appended, the
    # lead's holes kept and its rows where they were
    assert seg.docmap.num_ordinals == 600 and seg.live_count() == 598
    assert seg.capacity() == 1024 and lead.capacity() == 512
    np.testing.assert_array_equal(seg.docmap.ord_to_doc[[3, 4]], [-1, -1])
    assert torch.equal(seg.vectors[:500], lead.vectors[:500])
    assert seg.pqv is not None and seg.pqv.codes.shape[0] == 1024
    res = idx.search(v[550], tconfig.SearchConfig(k=3, ef_search=48))
    assert res.doc_ids[0][0] == 550


def test_incremental_merge_fills_the_leads_padded_tail(tmp_path):
    """New ordinals start at the lead's used count, inside its capacity
    padding while there is room: rows, codes and graph share them."""
    idx, v = _two_flushes(tmp_path, _pq_cfg(), 300, 150, 6)
    idx.force_merge()
    seg = tsegment.read_segment(tmp_path / idx.segment_names[0], "cpu")
    assert seg.capacity() == 512 and seg.docmap.num_ordinals == 450
    np.testing.assert_array_equal(seg.docmap.ord_to_doc, np.arange(450))
    np.testing.assert_array_equal(seg.vectors[:450].numpy(), v)
    assert bool(seg.graph.live[:450].all())
    assert not bool(seg.graph.live[450:].any())
    assert (seg.graph.adjacency[450:] == -1).all()
    # every row's code is the nearest centroid of that row
    want = tpq.encode(seg.pqv.pq, seg.vectors[:450], EUCLID)
    assert torch.equal(seg.pqv.codes[:450], want)
    assert (seg.pqv.codes[450:] == 0).all()


def test_mixed_quantization_merge_reuses_leading_codebooks(tmp_path):
    """A PQ segment merged with a below-min-batch fp32 segment: the lead's
    codebooks are reused + refined and every row is PQ-encoded."""
    cfg = _pq_cfg()
    cfg = tconfig.DiskAnnConfig(**{**cfg.__dict__,
                                   "min_batch_size_for_quantization": 256})
    idx, v = _two_flushes(tmp_path, cfg, 300, 100, 21)
    segs = [tsegment.read_segment(tmp_path / n, "cpu")
            for n in idx.segment_names]
    assert [s.pqv is not None for s in segs] == [True, False]
    idx.force_merge()
    seg = tsegment.read_segment(tmp_path / idx.segment_names[0], "cpu")
    assert seg.pqv is not None
    assert seg.docmap.num_ordinals == 400  # appended, not compacted
    # refined from the lead's codebooks: close to them, not equal
    delta = (seg.pqv.pq.codebooks - segs[0].pqv.pq.codebooks).abs()
    assert 0 < float(delta.max()) and float(delta.mean()) < 0.2
    res = idx.search(v[350], tconfig.SearchConfig(k=3, ef_search=48))
    assert res.doc_ids[0][0] == 350


def test_mixed_quantization_merge_trains_when_leading_fp32(tmp_path):
    """Two below-min-batch fp32 segments whose merged size crosses the
    minimum batch: the merge trains fresh codebooks."""
    cfg = _pq_cfg()
    cfg = tconfig.DiskAnnConfig(**{**cfg.__dict__,
                                   "min_batch_size_for_quantization": 256})
    idx, v = _two_flushes(tmp_path, cfg, 200, 200, 22)
    segs = [tsegment.read_segment(tmp_path / n, "cpu")
            for n in idx.segment_names]
    assert all(s.pqv is None for s in segs)
    idx.force_merge()
    seg = tsegment.read_segment(tmp_path / idx.segment_names[0], "cpu")
    assert seg.pqv is not None  # 400 >= 256: trained on merge
    res = idx.search(v[123], tconfig.SearchConfig(k=3, ef_search=48))
    assert res.doc_ids[0][0] == 123


def test_low_density_leading_forces_compacting_rebuild(tmp_path):
    """Deleting most of the lead trips the density < 0.4 guard: a full
    rebuild whose ordinal space is compacted to the live docs."""
    idx, v = _two_flushes(tmp_path, _cfg(), 400, 100, 23)
    idx.delete(list(range(0, 300)))  # lead density 100/400 = 0.25
    idx.force_merge()
    seg = tsegment.read_segment(tmp_path / idx.segment_names[0], "cpu")
    assert seg.docmap.num_ordinals == 200 and seg.live_count() == 200
    assert idx.doc_count() == 200
    truth = _truth(v[:8], v[300:], 5)
    res = idx.search(v[:8], tconfig.SearchConfig(k=5, ef_search=64))
    assert recall_at_k(res.doc_ids, truth + 300, 5) >= 0.85


def test_repeated_merge_delete_cycles(tmp_path):
    """Churn: repeated (ingest -> delete -> force_merge) cycles keep the
    doc count exact and recall high."""
    idx = _pinned(tmp_path, _cfg())
    rng = np.random.default_rng(24)
    alive: dict[int, np.ndarray] = {}
    next_id = 0
    for _ in range(3):
        vecs = rng.standard_normal((150, DIM)).astype(np.float32)
        idx.add_batch(np.arange(next_id, next_id + 150), vecs)
        for row in vecs:
            alive[next_id] = row
            next_id += 1
        idx.flush()
        doomed = rng.choice(sorted(alive), size=40, replace=False)
        idx.delete([int(d) for d in doomed])
        for d in doomed:
            del alive[int(d)]
        idx.force_merge()
        assert len(idx.segment_names) == 1
        assert idx.doc_count() == len(alive)
    ids = np.array(sorted(alive))
    np.testing.assert_array_equal(idx.live_doc_ids(), ids)
    corpus = np.stack([alive[int(i)] for i in ids])
    q = rng.standard_normal((8, DIM)).astype(np.float32)
    res = idx.search(q, tconfig.SearchConfig(k=10, ef_search=64))
    assert recall_at_k(res.doc_ids, ids[_truth(q, corpus, 10)], 10) >= 0.85
    seg = tsegment.read_segment(tmp_path / idx.segment_names[0], "cpu")
    _check_invariants(seg.graph, np.nonzero(seg.graph.live.numpy())[0],
                      deg_cap=8)


def test_sorted_flush_then_merge_keeps_mapping(tmp_path):
    """Index sorting at flush (sort_map) composes with a later merge."""
    idx = _pinned(tmp_path, _cfg())
    v = _vectors(100, seed=25)
    idx.add_batch(np.arange(100), v)
    idx.flush(sort_map=np.arange(100)[::-1].copy())  # doc i -> doc 99-i
    idx.add_batch(np.arange(100, 150), v[:50] + 2.0)
    idx.flush()
    idx.force_merge()
    # v[i] now lives at doc id 99-i
    res = idx.search(v[30], tconfig.SearchConfig(k=3, ef_search=48))
    assert res.doc_ids[0][0] == 69
    seg = tsegment.read_segment(tmp_path / idx.segment_names[0], "cpu")
    o = int(np.nonzero(seg.docmap.ord_to_doc == 69)[0][0])
    np.testing.assert_allclose(seg.vectors[o].numpy(), v[30], rtol=1e-6)


def test_tiered_policy_background_merge_concurrent_with_ingest(tmp_path):
    """Background merges run on the merge pool while ingest and search
    continue; deletes racing a merge stay masked either way."""
    idx = _index(tmp_path, _cfg(),
                 tscheduler.TieredMergePolicy(max_segments=2, merge_factor=3))
    v = _vectors(600, seed=11)
    for chunk in range(6):
        idx.add_batch(np.arange(chunk * 100, (chunk + 1) * 100),
                      v[chunk * 100: (chunk + 1) * 100])
        idx.flush()
        # searches are served from a stable snapshot mid-merge
        res = idx.search(v[:4], tconfig.SearchConfig(k=3, ef_search=32))
        assert (res.doc_ids[np.arange(4), 0] == np.arange(4)).all()
    idx.await_merges(timeout=WAIT)
    assert len(idx.segment_names) < 6  # compaction actually happened
    assert idx.doc_count() == 600
    assert idx.stats.get(Counter.KNN_MERGE_COUNT) >= 1

    q = _vectors(8, seed=12)
    res = idx.search(q, tconfig.SearchConfig(k=10, ef_search=64))
    assert recall_at_k(res.doc_ids, _truth(q, v, 10), 10) >= 0.85

    idx.delete([5, 6])
    idx.add_batch(np.arange(600, 700), v[:100] + 1.0)
    idx.flush()
    idx.await_merges(timeout=WAIT)
    res = idx.search(v[5], tconfig.SearchConfig(k=5, ef_search=32))
    assert 5 not in res.doc_ids[0].tolist()
    assert idx.doc_count() == 698
    idx.close()
    assert idx._pins == {} and idx._retired == set()


def test_force_merges_only_policy_never_auto_merges(tmp_path):
    idx = _pinned(tmp_path, _cfg())
    v = _vectors(300, seed=13)
    for chunk in range(6):
        idx.add_batch(np.arange(chunk * 50, (chunk + 1) * 50),
                      v[chunk * 50: (chunk + 1) * 50])
        idx.flush()
    assert idx.maybe_merge() is None and idx.compact_to(2) is None
    idx.await_merges(timeout=WAIT)
    assert len(idx.segment_names) == 6  # untouched until force_merge
    idx.force_merge()
    assert len(idx.segment_names) == 1


def test_default_policy_background_compaction(tmp_path):
    """The default policy compacts in the background: a churn of small
    flushes never accumulates segments without bound."""
    idx = VectorIndex(tmp_path, _cfg(), device="cpu")
    assert getattr(idx.merge_policy, "auto", False)
    v = _vectors(400, seed=17)
    for chunk in range(8):
        idx.add_batch(np.arange(chunk * 50, (chunk + 1) * 50),
                      v[chunk * 50: (chunk + 1) * 50])
        idx.flush()
    idx.await_merges(timeout=WAIT)
    assert len(idx.segment_names) <= idx.merge_policy.max_segments + 1
    assert idx.doc_count() == 400
    res = idx.search(v[:8], tconfig.SearchConfig(k=5, ef_search=64))
    assert recall_at_k(res.doc_ids, _truth(v[:8], v, 5), 5) >= 0.85
    idx.close()


def test_compact_to_merges_the_smallest(tmp_path):
    idx = _index(tmp_path, _cfg(),
                 tscheduler.TieredMergePolicy(max_segments=8))
    v = _vectors(330, seed=18)
    lo = 0
    for count in (100, 40, 90, 30, 70):
        idx.add_batch(np.arange(lo, lo + count), v[lo: lo + count])
        idx.flush()
        lo += count
    assert idx.compact_to(5) is None and idx.compact_to(0) is None
    fut = idx.compact_to(3)  # the 3 smallest -> one: 5 segments become 3
    assert fut.result(timeout=WAIT) == "merged_3segs_m1"
    assert idx.segment_names == ["seg_000000_100", "seg_000002_90",
                                 "merged_3segs_m1"]
    assert idx.doc_count() == 330
    idx.close()


# -- update semantics and crash recovery ------------------------------------------

def test_delete_then_readd_still_fresh(tmp_path):
    v = _vectors(50, seed=2)
    idx = _index(tmp_path, _cfg())
    idx.add_batch(np.arange(50), v)
    idx.flush()
    idx.delete([9])
    assert idx.doc_count() == 49 and idx.has_deletes
    idx.add(9, v[9])
    idx.flush()
    assert idx.doc_count() == 50
    res = idx.search(v[9], tconfig.SearchConfig(k=1, ef_search=32))
    assert int(res.doc_ids[0, 0]) == 9
    idx.force_merge()  # the tombstone folds; the later copy stays live
    assert idx.doc_count() == 50 and not idx.has_deletes
    res = idx.search(v[9], tconfig.SearchConfig(k=1, ef_search=32))
    assert int(res.doc_ids[0, 0]) == 9
    idx.close()


def test_update_survives_merge(tmp_path):
    v = _vectors(80, seed=3)
    idx = _pinned(tmp_path, _cfg())
    idx.add_batch(np.arange(80), v)
    idx.flush()
    news = {d: (v[d] - 7.0).astype(np.float32) for d in (3, 44, 61)}
    for d, nv in news.items():
        idx.add(d, nv)
    idx.flush()
    idx.force_merge()
    assert len(idx.segment_names) == 1
    assert idx.doc_count() == 80
    seg = tsegment.read_segment(tmp_path / idx.segment_names[0], "cpu")
    for d, nv in news.items():
        (o,) = np.nonzero(seg.docmap.ord_to_doc == d)[0]  # one copy left
        np.testing.assert_allclose(seg.vectors[o].numpy(), nv, rtol=1e-6)
        res = idx.search(nv, tconfig.SearchConfig(k=1, ef_search=48))
        assert int(res.doc_ids[0, 0]) == d
    idx.close()


def test_reopen_preserves_scoped_deletes_across_merge(tmp_path):
    """Tombstones committed per segment survive reopen and fold correctly
    even when the merge happens only after a second reopen."""
    idx = _index(tmp_path, _cfg())
    v = _vectors(100, seed=2)
    idx.add_batch(np.arange(100), v)
    idx.flush()
    idx.delete([10, 11])
    del idx

    mid = _index(tmp_path)
    assert mid.doc_count() == 98
    del mid

    idx3 = _index(tmp_path)
    idx3.force_merge()
    assert idx3.doc_count() == 98
    state = json.loads((tmp_path / "commits.json").read_text())
    assert state.get("segment_deletes", {}) == {}  # folded away
    res = idx3.search(v[10], tconfig.SearchConfig(k=5, ef_search=32))
    assert not np.isin(res.doc_ids, [10, 11]).any()
    # the JAX package reads the same commit
    assert JIndex(tmp_path).doc_count() == 98


def test_delete_drops_buffered_docs(tmp_path):
    idx = _index(tmp_path, _cfg())
    v = _vectors(60, seed=5)
    idx.add_batch(np.arange(40), v[:40])
    idx.add_batch(np.arange(40, 60), v[40:])
    assert idx.writer.num_buffered() == 60
    idx.delete([1, 2, 45])
    assert idx.writer.num_buffered() == 57
    assert idx.writer.delete_buffered(np.arange(40, 60)) == 19  # a whole block
    assert idx.writer.num_buffered() == 38
    idx.flush()
    np.testing.assert_array_equal(
        idx.live_doc_ids(), np.setdiff1d(np.arange(40), [1, 2]))
    assert not idx.has_deletes


def test_deletes_racing_a_flush_land_on_its_segment(tmp_path, monkeypatch):
    """A delete that arrives after the flush snapshotted the buffer is
    scoped to the new segment at its commit, through the sort map."""
    idx = _pinned(tmp_path, _cfg())
    v = _vectors(50, seed=6)
    idx.add_batch(np.arange(50), v)
    flush = idx.writer.flush

    def flush_then_delete(**kw):
        path = flush(**kw)
        idx.delete([7, 999])  # pre-sort id 7 -> doc 42; 999 is nowhere
        return path

    monkeypatch.setattr(idx.writer, "flush", flush_then_delete)
    name = idx.flush(sort_map=np.arange(50)[::-1].copy())
    assert idx.deleted_docs_for(name) == {42}
    assert idx.doc_count() == 49
    res = idx.search(v[7], tconfig.SearchConfig(k=3, ef_search=32))
    assert 42 not in res.doc_ids[0].tolist()


# -- (g) on_disk merges --------------------------------------------------------------

def _on_disk(root, index_type, policy=None):
    cfg = _pq_cfg(mode="on_disk", index_type=index_type)
    return _index(root, cfg, policy or tscheduler.ForceMergesOnlyMergePolicy())


def _spy_uploads(monkeypatch):
    """Record every host array the merge uploads whole."""
    calls = []
    real = tmerge._to_device

    def spy(rows, device):
        if not isinstance(rows, torch.Tensor):
            calls.append(rows.shape)
        return real(rows, device)

    monkeypatch.setattr(tmerge, "_to_device", spy)
    return calls


@pytest.mark.parametrize("index_type", ["flat", "vamana"])
def test_on_disk_merge_writes_live_rows_in_order(index_type, tmp_path,
                                                 monkeypatch):
    idx = _on_disk(tmp_path, index_type)
    v = _latent(np.random.default_rng(31), 700)
    idx.add_batch(np.arange(400), v[:400])
    idx.flush()
    idx.add_batch(np.arange(400, 700), v[400:])
    idx.flush()
    idx.delete([5, 6, 450])
    uploads = _spy_uploads(monkeypatch)
    name = idx.force_merge()
    seg = tsegment.read_segment(tmp_path / name, "cpu")
    assert seg.row_store is not None and seg.vectors is None
    assert tsegment.check_integrity(tmp_path / name)
    docs = seg.docmap.ord_to_doc
    stored = np.fromfile(tmp_path / name / "rows.f32", np.float32).reshape(
        -1, DIM)
    assert stored.shape[0] == docs.shape[0]
    live = docs >= 0
    assert stored[live].tobytes() == v[docs[live]].tobytes()
    if index_type == "flat":
        # concat-only: compacted, and the corpus never went to the device
        assert uploads == []
        np.testing.assert_array_equal(
            docs, np.setdiff1d(np.arange(700), [5, 6, 450]))
    else:
        # the build needs the rows on the device, as the flush's does; the
        # lead's holes keep their ordinals and their rows, the other
        # segment's dead row is dropped
        assert uploads == [(699, DIM)]
        assert docs.shape[0] == 699 and (~live).sum() == 2
        assert stored[:400].tobytes() == v[:400].tobytes()
        _check_invariants(seg.graph, np.nonzero(live)[0], deg_cap=8)
    assert idx.doc_count() == 697 and not idx.has_deletes
    q = _latent(np.random.default_rng(32), 16)
    keep = np.setdiff1d(np.arange(700), [5, 6, 450])
    res = idx.search(q, tconfig.SearchConfig(k=K, overquery_factor=20))
    assert recall_at_k(res.doc_ids, keep[_truth(q, v[keep], K)], K) >= 0.90
    seg.row_store.close()
    idx.close()
    # the JAX package opens the merged on_disk segment
    jseg = jsegment.read_segment(tmp_path / name)
    assert jseg.row_store is not None
    np.testing.assert_array_equal(jseg.docmap.ord_to_doc, docs)


def test_on_disk_merge_at_the_quantized_build_gate_raises(tmp_path,
                                                          monkeypatch):
    """At the quantized-build gate the merge charges the breaker the
    decoded-bf16 source and no fp32 rows; a refused merge raises and leaves
    the segment set as it was, an allowed one builds from the bf16 rows
    without uploading the host rows."""
    from opensearch_jvector_tpu_torch.utils.circuit_breaker import (
        BREAKER,
        CircuitBreakerException,
    )

    idx = _on_disk(tmp_path, "vamana")
    v = _latent(np.random.default_rng(33), 500)
    idx.add_batch(np.arange(300), v[:300])
    idx.flush()
    idx.add_batch(np.arange(300, 500), v[300:])
    idx.flush()
    idx.writer.quantized_build_min_capacity = 512  # merged capacity: 512
    charged = []

    class Refusing:  # the merge's breaker (segment loads keep theirs)
        estimate_segment_bytes = staticmethod(BREAKER.estimate_segment_bytes)

        def check(self, nbytes, device):
            charged.append(nbytes)
            raise CircuitBreakerException("refused")

    monkeypatch.setattr(tmerge, "BREAKER", Refusing())
    with pytest.raises(CircuitBreakerException):
        idx.force_merge()
    assert len(idx.segment_names) == 2 and idx._merging == set()
    cfg = idx.config
    assert charged == [BREAKER.estimate_segment_bytes(
        512 + 256, DIM, cfg.m, cfg.neighbor_overflow, cfg.num_pq_subspaces,
        keep_fp32=False) + 500 * DIM * 2]
    monkeypatch.undo()
    sources = []
    real = tbuilder.GraphIndexBuilder.cleanup
    monkeypatch.setattr(tbuilder.GraphIndexBuilder, "cleanup",
                        lambda self, g, rows, *a: sources.append(
                            rows.dtype) or real(self, g, rows, *a))
    uploads = _spy_uploads(monkeypatch)
    name = idx.force_merge()
    assert sources == [torch.bfloat16] and uploads == []
    assert idx.doc_count() == 500
    seg = idx._reader(name).seg
    assert seg.row_store is not None and seg.vectors is None
    np.testing.assert_array_equal(seg.row_store.gather(np.arange(500)),
                                  v[seg.docmap.ord_to_doc])
    idx.close()


# -- (h) names, (i) readers under a swap ----------------------------------------------

def test_merge_names_are_unique_across_a_reopen(tmp_path):
    idx = _pinned(tmp_path, _cfg())
    v = _vectors(240, seed=41)
    names = []
    for f in range(3):
        idx.add_batch(np.arange(f * 40, (f + 1) * 40), v[f * 40: (f + 1) * 40])
        idx.flush()
        if f:
            names.append(idx.force_merge())
    assert names == ["merged_2segs_m1", "merged_2segs_m2"]
    with pytest.raises(ValueError, match="collides"):
        idx.force_merge(out_name=names[0])
    assert idx._merging == set()
    idx.close()
    again = _pinned(tmp_path)
    again.add_batch(np.arange(120, 160), v[120:160])
    again.flush()
    assert again.force_merge() == "merged_2segs_m3"
    assert again.doc_count() == 160
    assert JIndex(tmp_path).doc_count() == 160
    again.close()


def _store_open(reader) -> bool:
    store = reader.seg.row_store
    return store._handle is not None or store._mm is not None


def test_search_keeps_its_reader_open_through_a_swap(tmp_path, monkeypatch):
    """A search is inside a reader while a merge swaps the segment set: the
    reader's host row store stays open until the search leaves it, the
    search answers from the set it started with, and every reader the swap
    dropped is closed afterwards."""
    idx = _on_disk(tmp_path, "flat")
    v = _latent(np.random.default_rng(51), 600)
    idx.add_batch(np.arange(300), v[:300])
    idx.flush()
    idx.add_batch(np.arange(300, 600), v[300:])
    idx.flush()
    idx.delete([0, 1])
    sc = tconfig.SearchConfig(k=K, overquery_factor=20)
    want = idx.search(v[:16], sc)  # opens both readers
    old = [idx._readers[n] for n in idx.segment_names]
    assert all(_store_open(r) for r in old)

    inside, go_on = threading.Event(), threading.Event()
    search = SegmentReader.search
    state = {}

    def held_search(self, *a, **kw):
        if not inside.is_set():  # the first segment's search waits
            inside.set()
            assert go_on.wait(WAIT)
            state["open_during"] = _store_open(self)
        return search(self, *a, **kw)

    monkeypatch.setattr(SegmentReader, "search", held_search)
    got = []
    t = threading.Thread(target=lambda: got.append(idx.search(v[:16], sc)))
    t.start()
    assert inside.wait(WAIT)
    merged = idx.force_merge()  # swaps both segments out under the search
    assert idx.segment_names == [merged]
    assert _store_open(old[0])  # in use: the swap did not close it
    assert not _store_open(old[1])  # idle: closed by the swap
    go_on.set()
    t.join(WAIT)
    assert not t.is_alive() and state["open_during"]
    # the racing search answered from its snapshot, tombstones included
    np.testing.assert_array_equal(got[0].doc_ids, want.doc_ids)
    assert not np.isin(got[0].doc_ids, [0, 1]).any()
    assert not any(_store_open(r) for r in old)
    assert idx._pins == {} and idx._retired == set()
    after = idx.search(v[:16], sc)
    np.testing.assert_array_equal(after.doc_ids[:, 0], want.doc_ids[:, 0])
    idx.close()
    assert idx._readers == {}


def test_merge_stage_timings_and_counters(tmp_path):
    stats = StatsRegistry()
    idx = _index(tmp_path, _pq_cfg(),
                 tscheduler.ForceMergesOnlyMergePolicy(), stats=stats)
    v = _vectors(500, seed=61)
    idx.add_batch(np.arange(300), v[:300])
    idx.flush()
    idx.add_batch(np.arange(300, 500), v[300:])
    idx.flush()
    idx.time_merge_stages = True
    idx.force_merge()
    assert set(idx.last_merge_timings) == {
        "materialise", "pq", "delta_inserts", "cleanup", "write"}
    assert all(t >= 0 for t in idx.last_merge_timings.values())
    assert stats.get(Counter.KNN_MERGE_COUNT) == 1
    assert stats.get(Counter.KNN_GRAPH_MERGE_TIME) >= 0
