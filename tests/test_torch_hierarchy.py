"""Port parity for the hierarchy layer (`hierarchy_enabled`) and the
searcher's per-query entry points.

The same seeded numpy inputs go through the JAX package and the PyTorch
package. Tolerances:
  * `_build_upper_layer` from the same live set and entry: the same
    members (the host draw is copied), exact; the layer's structure (base
    ordinal space, width min(16, max_degree), rows only for members,
    neighbours only among members, every member reachable from the entry
    over the layer);
  * `beam_search` with one entry per query: the ids and counters of one
    search per query with that entry, scores rtol 1e-6 (a batched product
    sums in another order than a single one);
  * a hierarchy segment written by one package and opened by the other:
    files byte-identical after a rewrite; searches return the same ids up
    to score ties, scores atol 1e-5, and the same visited / expanded /
    reranked counts and base-layer expansion counter, in_memory and
    on_disk, with the exact, PQ, NVQ and Hamming providers (the on_disk
    tier descends the layer too, but like the reference counts all its
    expansions as base-layer ones);
  * whole slice (add -> flush -> search -> delete -> force_merge ->
    reopen) with the layer on: recall@10 against exact ground truth >= 0.9
    and within 0.05 of the JAX package's on the same data.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.api import config as jconfig
from opensearch_jvector_tpu.api.settings import GLOBAL_SETTINGS as JSETTINGS
from opensearch_jvector_tpu.api.stats import Counter as JCounter
from opensearch_jvector_tpu.index import segment as jsegment
from opensearch_jvector_tpu.index.index import VectorIndex as JIndex
from opensearch_jvector_tpu.index.scheduler import ForceMergesOnlyMergePolicy
from opensearch_jvector_tpu.models import builder as jbuilder
from opensearch_jvector_tpu.ops.distances import SimilarityFunction as JSim
from opensearch_jvector_tpu_torch.api import config as tconfig
from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
from opensearch_jvector_tpu_torch.api.stats import Counter
from opensearch_jvector_tpu_torch.convert import graph_from_numpy
from opensearch_jvector_tpu_torch.index import segment as tsegment
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.scheduler import (
    ForceMergesOnlyMergePolicy as TForceOnly,
)
from opensearch_jvector_tpu_torch.models import builder as tbuilder
from opensearch_jvector_tpu_torch.models import searcher as tsearcher
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.utils.ground_truth import (
    ground_truth_topk,
    recall_at_k,
)

torch.set_num_threads(2)

SETTING = "index.knn.advanced.scan_tier_max_codes"
D, PER_FLUSH, FLUSHES, Q, K = 16, 600, 2, 24, 10
CFG = dict(dim=D, m=12, ef_construction=48, num_pq_subspaces=8,
           min_batch_size_for_quantization=256, hierarchy_enabled=True)
EUCLID = SimilarityFunction.EUCLIDEAN
MODES = {
    "none": dict(quantization_type="none"),
    "pq": {},
    "pq_on_disk": dict(mode="on_disk"),
    "nvq": dict(quantization_type="nvq+pq"),
    "4bit": dict(quantization_type="4bit"),
}


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _latent(rng, n):
    a = rng.standard_normal((8, D)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return _latent(rng, PER_FLUSH * FLUSHES), _latent(rng, Q)


# -- the layer itself ---------------------------------------------------------

def _members(upper: np.ndarray) -> np.ndarray:
    return np.nonzero((upper >= 0).any(1))[0]


@pytest.fixture(scope="module")
def jax_graph(corpus):
    """A JAX-built graph with the layer, over 700 rows with holes."""
    v = corpus[0][:700]
    b = jbuilder.GraphIndexBuilder(dim=D, max_degree=12, beam_width=48,
                                   hierarchy_enabled=True)
    g = b.build(jnp.asarray(v), JSim.EUCLIDEAN)
    g = b.mark_deleted(g, np.arange(0, 700, 9))
    return v, b.cleanup(g, jnp.asarray(v), JSim.EUCLIDEAN)


def test_upper_layer_picks_the_reference_members(jax_graph):
    v, jg = jax_graph
    live = np.asarray(jg.live)
    entry = int(jg.entry)
    b = tbuilder.GraphIndexBuilder(dim=D, max_degree=12, beam_width=48,
                                   hierarchy_enabled=True)
    rows = torch.zeros((live.shape[0], D))
    rows[:700] = _t(v)
    upper = b._build_upper_layer(rows, live, entry, EUCLID).numpy()
    want = np.asarray(jg.upper_adjacency)
    assert upper.shape == want.shape == (live.shape[0], 12)
    assert upper.dtype == np.int32
    np.testing.assert_array_equal(_members(upper), _members(want))
    members = _members(upper)
    # about 4*sqrt(n) of the live nodes, the entry among them
    assert entry in members and live[members].all()
    assert abs(members.size - min(live.sum(), max(64, int(
        4 * np.sqrt(live.sum()))))) <= 1
    # neighbours only among members, no self-loop, no duplicate
    for node in members:
        nb = upper[node][upper[node] >= 0]
        assert np.isin(nb, members).all() and node not in nb
        assert np.unique(nb).size == nb.size
    # every member is reachable from the entry over the layer
    seen, frontier = {entry}, [entry]
    while frontier:
        nxt = {int(x) for n in frontier for x in upper[n] if x >= 0} - seen
        seen |= nxt
        frontier = list(nxt)
    assert seen == set(members.tolist())


def test_upper_layer_needs_eight_live_nodes():
    b = tbuilder.GraphIndexBuilder(dim=D, max_degree=12, beam_width=48,
                                   hierarchy_enabled=True)
    v = _t(_latent(np.random.default_rng(1), 7))
    assert b.build(v, EUCLID).upper_adjacency is None
    v = _t(_latent(np.random.default_rng(1), 40))
    g = b.build(v, EUCLID)
    assert g.upper_adjacency.shape == (g.capacity, 12)
    assert _members(g.upper_adjacency.numpy()).size == 40  # min(n, 64)
    off = tbuilder.GraphIndexBuilder(dim=D, max_degree=12, beam_width=48)
    assert off.build(v, EUCLID).upper_adjacency is None


def test_upper_layer_width_follows_a_small_degree():
    b = tbuilder.GraphIndexBuilder(dim=D, max_degree=6, beam_width=32,
                                   hierarchy_enabled=True)
    g = b.build(_t(_latent(np.random.default_rng(2), 200)), EUCLID)
    assert g.upper_adjacency.shape[1] == 6


def test_layer_survives_capacity_growth_and_numpy_handover(jax_graph):
    _, jg = jax_graph
    g = graph_from_numpy(np.asarray(jg.adjacency), np.asarray(jg.degrees),
                         np.asarray(jg.live), jg.entry,
                         upper_adjacency=np.asarray(jg.upper_adjacency),
                         device="cpu")
    np.testing.assert_array_equal(g.upper_adjacency.numpy(),
                                  np.asarray(jg.upper_adjacency))
    grown = g.with_capacity(2 * g.capacity)
    assert grown.upper_adjacency.shape[0] == 2 * g.capacity
    assert (grown.upper_adjacency[g.capacity:] == -1).all()
    assert graph_from_numpy(np.asarray(jg.adjacency), np.asarray(jg.degrees),
                            np.asarray(jg.live),
                            jg.entry, device="cpu").upper_adjacency is None


# -- the searcher ---------------------------------------------------------------

def test_beam_search_takes_one_entry_per_query(jax_graph, corpus):
    v, jg = jax_graph
    g = graph_from_numpy(np.asarray(jg.adjacency), np.asarray(jg.degrees),
                         np.asarray(jg.live), jg.entry, device="cpu")
    rows = torch.zeros((g.capacity, D))
    rows[:700] = _t(v)
    queries = _t(corpus[1][:6])
    live_ids = np.nonzero(np.asarray(jg.live))[0]
    entries = torch.as_tensor(live_ids[[3, 50, 99, 3, 200, 411]])
    args = dict(accept=g.live, L=32, E=4, R=10, max_iters=12)
    score = tsearcher.ExactProvider(queries, rows, EUCLID)
    ids, scores, visited, expanded = tsearcher.beam_search(
        g.adjacency, g.live, entries, score, 6, **args)
    for i in range(6):
        one = tsearcher.ExactProvider(queries[i: i + 1], rows, EUCLID)
        ids1, scores1, visited1, expanded1 = tsearcher.beam_search(
            g.adjacency, g.live, int(entries[i]), one, 1, **args)
        assert torch.equal(ids[i], ids1[0])
        torch.testing.assert_close(scores[i], scores1[0], rtol=1e-6, atol=0)
        assert (int(visited[i]), int(expanded[i])) == (
            int(visited1[0]), int(expanded1[0]))


def test_search_counts_the_upper_layer_apart(jax_graph, corpus):
    v, jg = jax_graph
    g = graph_from_numpy(np.asarray(jg.adjacency), np.asarray(jg.degrees),
                         np.asarray(jg.live), jg.entry,
                         upper_adjacency=np.asarray(jg.upper_adjacency),
                         device="cpu")
    rows = torch.zeros((g.capacity, D))
    rows[:700] = _t(v)
    params = tsearcher.SearchParams(k=K)
    queries = _t(corpus[1])
    with_layer = tsearcher.search(g.adjacency, g.live, g.entry, queries,
                                  params, EUCLID, vectors=rows,
                                  upper_adjacency=g.upper_adjacency)
    without = tsearcher.search(g.adjacency, g.live, g.entry, queries, params,
                               EUCLID, vectors=rows)
    assert (with_layer.expanded_count
            > with_layer.expanded_base_count).all()
    assert torch.equal(without.expanded_count, without.expanded_base_count)
    assert (with_layer.reranked_count == 0).all()  # the exact provider
    truth = ground_truth_topk(queries, rows[:700][_t(np.asarray(jg.live)[:700])],
                              K, EUCLID)
    live_ids = np.nonzero(np.asarray(jg.live))[0]
    for res in (with_layer, without):
        assert recall_at_k(res.ids.numpy(), live_ids[truth], K) >= 0.95


# -- whole indexes, crossing between the packages ---------------------------------

def assert_same_up_to_ties(ids_a, s_a, ids_b, s_b, tol=1e-5):
    """Scores agree; doc ids differ only where the score is tied."""
    np.testing.assert_allclose(s_a, s_b, rtol=tol, atol=tol)
    for r in range(ids_a.shape[0]):
        for j in np.nonzero(ids_a[r] != ids_b[r])[0]:
            tied = np.abs(s_a[r] - s_a[r, j]) <= tol
            tied[j] = False
            assert tied.any(), (r, j, ids_a[r], ids_b[r])


def _fill(index, vectors):
    for f in range(FLUSHES):
        lo = f * PER_FLUSH
        index.add_batch(np.arange(lo, lo + PER_FLUSH),
                        vectors[lo: lo + PER_FLUSH])
        index.flush()


@pytest.fixture(scope="module")
def jax_dirs(corpus, tmp_path_factory):
    out = {}
    for mode, kw in MODES.items():
        root = tmp_path_factory.mktemp(f"jax_{mode}")
        idx = JIndex(root, jconfig.DiskAnnConfig(**{**CFG, **kw}),
                     merge_policy=ForceMergesOnlyMergePolicy())
        _fill(idx, corpus[0])
        idx.close()
        out[mode] = root
    return out


@pytest.fixture(scope="module")
def port_dirs(corpus, tmp_path_factory):
    out = {}
    for mode, kw in MODES.items():
        root = tmp_path_factory.mktemp(f"port_{mode}")
        idx = VectorIndex(root, tconfig.DiskAnnConfig(**{**CFG, **kw}),
                          device="cpu", merge_policy=TForceOnly())
        _fill(idx, corpus[0])
        idx.close()
        out[mode] = root
    return out


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


def _search_both(root, queries):
    """Both packages' answers and (expanded, expanded base layer) counter
    deltas over one directory."""
    jidx = JIndex(root, merge_policy=ForceMergesOnlyMergePolicy())
    tidx = VectorIndex(root, device="cpu")
    assert jidx.segment_names == tidx.segment_names
    out = []
    for idx, sc, counter in ((jidx, jconfig.SearchConfig(k=K), JCounter),
                             (tidx, tconfig.SearchConfig(k=K), Counter)):
        keys = (counter.KNN_QUERY_EXPANDED_NODES.value,
                counter.KNN_QUERY_EXPANDED_BASE_LAYER_NODES.value)
        before = idx.stats.snapshot()
        res = idx.search(queries, sc)
        after = idx.stats.snapshot()
        out.append((res, tuple(after[k] - before[k] for k in keys)))
    return out


def _assert_same(j, t):
    (jres, jcount), (tres, tcount) = j, t
    assert_same_up_to_ties(jres.doc_ids, jres.scores, tres.doc_ids,
                           tres.scores)
    assert (jres.visited, jres.expanded, jres.reranked) == (
        tres.visited, tres.expanded, tres.reranked)
    assert jcount == tcount


@pytest.mark.parametrize("mode", list(MODES))
def test_port_opens_jax_hierarchy_index(mode, corpus, jax_dirs, beam_tier):
    tidx = VectorIndex(jax_dirs[mode], device="cpu")
    for name in tidx.segment_names:
        assert tidx._reader(name).seg.graph.upper_adjacency is not None
    j, t = _search_both(jax_dirs[mode], corpus[1])
    _assert_same(j, t)
    expanded, base = t[1]
    assert t[0].expanded == expanded
    if mode == "pq_on_disk":
        assert expanded == base > 0
    else:  # the layer was descended, and counted apart
        assert expanded > base > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_jax_opens_port_hierarchy_index(mode, corpus, port_dirs, beam_tier):
    j, t = _search_both(port_dirs[mode], corpus[1])
    _assert_same(j, t)
    assert t[1][0] >= t[1][1] > 0
    assert mode == "pq_on_disk" or t[1][0] > t[1][1]


@pytest.mark.parametrize("mode", ["pq", "nvq"])
def test_hierarchy_index_on_the_scan_tier(mode, corpus, jax_dirs):
    """Below the scan bound the layer is carried but not walked."""
    j, t = _search_both(jax_dirs[mode], corpus[1])
    _assert_same(j, t)
    assert t[0].expanded == 0


def _files(d):
    """The containers of a segment directory (a reopened on_disk segment
    keeps its row file where it is: a rewrite does not copy it)."""
    return {p.name: p.read_bytes() for p in sorted(Path(d).glob("*.jvtpu"))}


@pytest.mark.parametrize("mode", ["pq", "pq_on_disk"])
def test_hierarchy_segment_bytes_identical_both_ways(mode, jax_dirs,
                                                     port_dirs, tmp_path):
    jname = JIndex(jax_dirs[mode]).segment_names[0]
    seg = tsegment.read_segment(jax_dirs[mode] / jname, "cpu")
    tsegment.write_segment(tmp_path / "t", seg)
    assert _files(tmp_path / "t" / jname) == _files(jax_dirs[mode] / jname)
    tname = VectorIndex(port_dirs[mode], device="cpu").segment_names[0]
    jseg = jsegment.read_segment(port_dirs[mode] / tname)
    assert jseg.graph.upper_adjacency is not None
    jsegment.write_segment(tmp_path / "j", jseg)
    assert _files(tmp_path / "j" / tname) == _files(port_dirs[mode] / tname)


def test_both_packages_sample_the_same_members(jax_dirs, port_dirs):
    """Same rows, same live set: where both builds settle on the same
    entry the member sets are equal, else they differ in one member."""
    for root_j, root_t in ((jax_dirs["none"], port_dirs["none"]),):
        for name in JIndex(root_j).segment_names:
            ju = np.asarray(jsegment.read_segment(
                root_j / name).graph.upper_adjacency)
            tseg = tsegment.read_segment(root_t / name, "cpu")
            tu = tseg.graph.upper_adjacency.numpy()
            diff = np.setxor1d(_members(ju), _members(tu))
            assert diff.size <= 2, diff


@pytest.mark.parametrize("mode", ["pq", "pq_on_disk", "4bit"])
def test_whole_slice_with_the_layer(mode, corpus, jax_dirs, tmp_path,
                                    beam_tier):
    vectors, queries = corpus
    cfg = tconfig.DiskAnnConfig(**{**CFG, **MODES[mode]})
    sc = tconfig.SearchConfig(k=K)
    idx = VectorIndex(tmp_path / "t", cfg, device="cpu",
                      merge_policy=TForceOnly())
    _fill(idx, vectors)
    truth = ground_truth_topk(_t(queries), _t(vectors), K, EUCLID)
    recall = recall_at_k(idx.search(queries, sc).doc_ids, truth, K)
    jrecall = recall_at_k(JIndex(jax_dirs[mode]).search(
        queries, jconfig.SearchConfig(k=K)).doc_ids, truth, K)
    floor = 0.8 if mode == "4bit" else 0.9
    assert recall >= floor and abs(recall - jrecall) <= 0.05, (recall,
                                                               jrecall)
    dead = np.arange(0, 300)
    idx.delete(dead)
    merged = idx.force_merge()
    seg = idx._reader(merged).seg
    upper = seg.graph.upper_adjacency.numpy()
    members = _members(upper)
    live = seg.graph.live.numpy()
    # the merge's cleanup rebuilt the layer over the merged live set
    assert upper.shape[0] == seg.capacity() and live[members].all()
    assert seg.graph.entry in members
    assert abs(members.size - max(64, int(4 * np.sqrt(live.sum())))) <= 1
    live_ids = np.arange(300, vectors.shape[0])
    truth = live_ids[ground_truth_topk(_t(queries), _t(vectors[live_ids]), K,
                                       EUCLID)]
    before = idx.stats.snapshot()
    after = idx.search(queries, sc)
    stats = idx.stats.snapshot()
    assert not np.isin(after.doc_ids, dead).any()
    assert recall_at_k(after.doc_ids, truth, K) >= floor - 0.05
    expanded, base = (stats[c.value] - before[c.value] for c in (
        Counter.KNN_QUERY_EXPANDED_NODES,
        Counter.KNN_QUERY_EXPANDED_BASE_LAYER_NODES))
    assert expanded >= base > 0
    assert mode == "pq_on_disk" or expanded > base
    idx.close()
    np.testing.assert_array_equal(
        VectorIndex(tmp_path / "t", device="cpu").search(queries, sc).doc_ids,
        after.doc_ids)
    jafter = JIndex(tmp_path / "t").search(queries, jconfig.SearchConfig(k=K))
    assert_same_up_to_ties(jafter.doc_ids, jafter.scores, after.doc_ids,
                           after.scores)
