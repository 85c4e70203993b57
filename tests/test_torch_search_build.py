"""Port parity: beam search and graph build of the PyTorch package against
the JAX package.

Search is compared on one JAX-built graph handed across as numpy arrays:
same ids up to score ties, same visited/expanded counters. Builds draw on
different float orders, so a port build is compared with the JAX build on
the same corpus by recall@10 within a band, plus structural invariants.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.models import builder as jbuilder
from opensearch_jvector_tpu.models import searcher as jsearcher
from opensearch_jvector_tpu.ops.distances import SimilarityFunction as JSim
from opensearch_jvector_tpu.utils.ground_truth import (
    ground_truth_topk,
    recall_at_k,
)
from opensearch_jvector_tpu_torch.convert import graph_from_numpy
from opensearch_jvector_tpu_torch.models import builder as tbuilder
from opensearch_jvector_tpu_torch.models import searcher as tsearcher
from opensearch_jvector_tpu_torch.ops import beam_kernel, prune_kernel
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction

torch.set_num_threads(2)

N, D, Q, K, DEG = 1200, 16, 24, 10, 12
SIMF = SimilarityFunction.EUCLIDEAN


def assert_same_up_to_ties(ids_a, s_a, ids_b, s_b, tol=1e-5):
    """Scores agree; ids differ only where the score is tied."""
    np.testing.assert_allclose(s_a, s_b, rtol=tol, atol=tol)
    for r in range(ids_a.shape[0]):
        for j in np.nonzero(ids_a[r] != ids_b[r])[0]:
            tied = np.abs(s_a[r] - s_a[r, j]) <= tol
            tied[j] = False
            assert tied.any(), (r, j, ids_a[r], ids_b[r])


def _latent(rng, n):
    a = rng.standard_normal((8, D)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return _latent(rng, N), _latent(rng, Q)


def _params(cls, **kw):
    return cls(k=K, ef_search=48, **kw)


@pytest.fixture(scope="module")
def jax_graph(corpus):
    vectors, _ = corpus
    return jbuilder.GraphIndexBuilder(
        dim=D, max_degree=DEG, beam_width=48, batch_size=256,
    ).build(jnp.asarray(vectors), JSim.EUCLIDEAN)


@pytest.fixture(scope="module")
def port_graph(corpus):
    vectors, _ = corpus
    return tbuilder.GraphIndexBuilder(
        dim=D, max_degree=DEG, beam_width=48, batch_size=256,
    ).build(torch.from_numpy(vectors), SIMF)


@pytest.mark.parametrize("e", [4, 16])
def test_beam_search_on_jax_graph_matches(e, corpus, jax_graph):
    vectors, queries = corpus
    jres = jsearcher.search(
        jax_graph.adjacency, jax_graph.live, jax_graph.entry,
        jnp.asarray(queries), _params(jsearcher.SearchParams,
                                      expansions_per_iter=e),
        JSim.EUCLIDEAN, vectors=jnp.asarray(vectors),
    )
    g = graph_from_numpy(np.asarray(jax_graph.adjacency),
                         np.asarray(jax_graph.degrees),
                         np.asarray(jax_graph.live),
                         np.asarray(jax_graph.entry), device="cpu")
    cap = g.capacity
    tvec = torch.zeros((cap, D))
    tvec[:N] = torch.from_numpy(vectors)
    tres = tsearcher.search(
        g.adjacency, g.live, g.entry, torch.from_numpy(queries),
        _params(tsearcher.SearchParams, expansions_per_iter=e), SIMF,
        vectors=tvec,
    )
    assert_same_up_to_ties(np.asarray(jres.ids), np.asarray(jres.scores),
                           tres.ids.numpy(), tres.scores.numpy())
    np.testing.assert_array_equal(tres.visited_count.numpy(),
                                  np.asarray(jres.visited_count))
    np.testing.assert_array_equal(tres.expanded_count.numpy(),
                                  np.asarray(jres.expanded_count))


def test_accept_mask_and_threshold_match(corpus, jax_graph):
    vectors, queries = corpus
    cap = int(jax_graph.capacity)
    accept = np.random.default_rng(1).random(cap) < 0.5
    thr = 0.5
    jres = jsearcher.search(
        jax_graph.adjacency, jax_graph.live, jax_graph.entry,
        jnp.asarray(queries), _params(jsearcher.SearchParams, threshold=thr),
        JSim.EUCLIDEAN, vectors=jnp.asarray(vectors),
        accept=jnp.asarray(accept),
    )
    g = graph_from_numpy(np.asarray(jax_graph.adjacency),
                         np.asarray(jax_graph.degrees),
                         np.asarray(jax_graph.live),
                         np.asarray(jax_graph.entry), device="cpu")
    tvec = torch.zeros((cap, D))
    tvec[:N] = torch.from_numpy(vectors)
    tres = tsearcher.search(
        g.adjacency, g.live, g.entry, torch.from_numpy(queries),
        _params(tsearcher.SearchParams, threshold=thr), SIMF, vectors=tvec,
        accept=torch.from_numpy(accept),
    )
    ids = tres.ids.numpy()
    assert accept[ids[ids >= 0]].all()
    assert (tres.scores.numpy()[ids >= 0] >= thr).all()
    assert_same_up_to_ties(np.asarray(jres.ids), np.asarray(jres.scores),
                           ids, tres.scores.numpy())


def test_new_neighbor_dedup_matches_pairwise_masks():
    """The sort-based dedup equals the reference's pairwise formulation."""
    rng = np.random.default_rng(2)
    pool = rng.integers(-1, 30, size=(5, 9))
    visited = rng.integers(-1, 30, size=(5, 7))
    nb = rng.integers(-1, 30, size=(5, 20))
    got = beam_kernel._new_neighbors(torch.from_numpy(nb),
                                     torch.from_numpy(pool),
                                     torch.from_numpy(visited)).numpy()
    for r in range(5):
        for j in range(20):
            x = nb[r, j]
            want = (x >= 0 and x not in pool[r] and x not in visited[r]
                    and x not in nb[r, :j])
            assert got[r, j] == want


def test_robust_prune_matches_jax():
    rng = np.random.default_rng(3)
    b, c = 6, 40
    pv = rng.standard_normal((b, D)).astype(np.float32)
    cv = rng.standard_normal((b, c, D)).astype(np.float32)
    ids = rng.integers(-1, 60, size=(b, c)).astype(np.int32)
    pids = np.arange(100, 100 + b, dtype=np.int32)
    ids[0, 3] = pids[0]  # a self-candidate must be masked
    for simf in SimilarityFunction:
        jsc = np.asarray(jsearcher.batched_candidate_scores(
            jnp.asarray(pv), jnp.asarray(cv), JSim(simf.value)))
        jsc = np.where(ids >= 0, jsc, -np.inf).astype(np.float32)
        want = np.asarray(jbuilder.robust_prune_batch(
            jnp.asarray(pv), jnp.asarray(ids), jnp.asarray(cv),
            jnp.asarray(jsc), 1.2, 8, simf.value,
            point_ids=jnp.asarray(pids)))
        got = prune_kernel.robust_prune_reference(
            torch.from_numpy(pv), torch.from_numpy(ids).long(),
            torch.from_numpy(cv), torch.from_numpy(jsc), 1.2, 8, simf,
            point_ids=torch.from_numpy(pids).long()).numpy()
        np.testing.assert_array_equal(got, want)


def _recall(graph_ids, vectors, queries):
    truth = ground_truth_topk(jnp.asarray(queries), jnp.asarray(vectors), K,
                              JSim.EUCLIDEAN)
    return recall_at_k(graph_ids, truth, K)


def test_port_build_recall_within_band_of_jax_build(corpus, jax_graph,
                                                    port_graph):
    vectors, queries = corpus
    jres = jsearcher.search(
        jax_graph.adjacency, jax_graph.live, jax_graph.entry,
        jnp.asarray(queries), _params(jsearcher.SearchParams),
        JSim.EUCLIDEAN, vectors=jnp.asarray(vectors))
    cap = port_graph.capacity
    tvec = torch.zeros((cap, D))
    tvec[:N] = torch.from_numpy(vectors)
    tres = tsearcher.search(
        port_graph.adjacency, port_graph.live, port_graph.entry,
        torch.from_numpy(queries), _params(tsearcher.SearchParams), SIMF,
        vectors=tvec)
    j_rec = _recall(np.asarray(jres.ids), vectors, queries)
    t_rec = _recall(tres.ids.numpy(), vectors, queries)
    assert t_rec >= j_rec - 0.02, (t_rec, j_rec)
    assert t_rec >= 0.9


def _check_invariants(graph, n):
    adj = graph.adjacency.numpy()
    deg = graph.degrees.numpy()
    live = graph.live.numpy()
    assert live[:n].all() and not live[n:].any()
    assert (deg <= DEG).all()
    for i in range(graph.capacity):
        row = adj[i][adj[i] >= 0]
        assert i not in row  # no self-loops
        assert np.unique(row).size == row.size  # no duplicate neighbour
        assert live[row].all()
        assert (adj[i, deg[i]:] == -1).all() and row.size == deg[i]
    seen = {graph.entry}
    todo = collections.deque([graph.entry])
    while todo:
        for j in adj[todo.popleft()]:
            if j >= 0 and j not in seen:
                seen.add(int(j))
                todo.append(int(j))
    assert len(seen) == n  # every live node reachable from the entry


def test_port_build_invariants(port_graph):
    _check_invariants(port_graph, N)


def test_cleanup_splices_out_tombstones(corpus, port_graph):
    """Tombstoned nodes are spliced out of every live row (2-hop repair in
    float32), degrees stay bounded and the rest stays reachable."""
    vectors, queries = corpus
    dead = np.random.default_rng(4).choice(N, 100, replace=False)
    dead = dead[dead != port_graph.entry]
    live = port_graph.live.clone()
    live[torch.from_numpy(dead)] = False
    g = tbuilder.VamanaGraph(
        adjacency=port_graph.adjacency.clone(),
        degrees=port_graph.degrees.clone(), live=live,
        entry=port_graph.entry)
    b = tbuilder.GraphIndexBuilder(dim=D, max_degree=DEG, beam_width=48,
                                   batch_size=256)
    out = b.cleanup(g, torch.from_numpy(vectors), SIMF)
    adj = out.adjacency.numpy()
    keep = out.live.numpy()
    assert not np.isin(adj[keep], dead).any()
    assert (out.degrees.numpy() <= DEG).all()
    tvec = torch.zeros((out.capacity, D))
    tvec[:N] = torch.from_numpy(vectors)
    res = tsearcher.search(out.adjacency, out.live, out.entry,
                           torch.from_numpy(queries),
                           _params(tsearcher.SearchParams), SIMF,
                           vectors=tvec)
    assert not np.isin(res.ids.numpy(), dead).any()


def test_orphans_are_linked_from_nearest_reachable():
    """Two far-apart clusters with no edges between them: cleanup links
    the unreachable island so every live node is reachable."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((40, D)).astype(np.float32)
    v = np.concatenate([a, a + 50.0])
    b = tbuilder.GraphIndexBuilder(dim=D, max_degree=DEG, beam_width=16,
                                   batch_size=64)
    g = b.build(torch.from_numpy(v[:40]), SIMF, capacity=128)
    adj = g.adjacency.clone()
    live = g.live.clone()
    # second island: a copy of the first graph's rows, shifted by 40
    rows = adj[:40].clone()
    adj[40:80] = torch.where(rows >= 0, rows + 40, rows)
    live[40:80] = True
    g2 = tbuilder.VamanaGraph(adjacency=adj,
                              degrees=torch.cat([g.degrees[:40],
                                                 g.degrees[:40],
                                                 g.degrees[80:]]),
                              live=live, entry=g.entry)
    out = b.cleanup(g2, torch.from_numpy(v), SIMF)
    reach = tbuilder._reachable(out.adjacency, out.live, out.entry)
    assert bool(reach[:80].all())
