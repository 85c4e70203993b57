"""The graph build's two loops on the CPU: the beam walk and the robust prune.

Both run as CUDA kernels on a card (`ops/beam_kernel.py`,
`ops/prune_kernel.py`, held against their plain versions in
`tests/test_torch_cuda.py`); here their plain versions are held against
the JAX package on the same seeded numpy inputs, the row providers against
the closures they replaced, the shared-memory sizing against every shape
the callers reach, and the wrappers' CPU route against the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.models import builder as jbuilder
from opensearch_jvector_tpu.models import searcher as jsearcher
from opensearch_jvector_tpu.ops.distances import SimilarityFunction as JSim
from opensearch_jvector_tpu_torch.convert import graph_from_numpy
from opensearch_jvector_tpu_torch.models import searcher as tsearcher
from opensearch_jvector_tpu_torch.ops import beam_kernel, prune_kernel
from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    batched_candidate_scores,
)

torch.set_num_threads(2)

N, D, Q, DEG = 1200, 16, 24, 12
SIMFS = list(SimilarityFunction)


def _latent(rng, n, d=D):
    a = rng.standard_normal((8, d)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return _latent(rng, N), _latent(rng, Q)


@pytest.fixture(scope="module")
def jax_graph(corpus):
    vectors, _ = corpus
    return jbuilder.GraphIndexBuilder(
        dim=D, max_degree=DEG, beam_width=48, batch_size=256,
    ).build(jnp.asarray(vectors), JSim.EUCLIDEAN)


def _same_up_to_ties(ids_a, s_a, ids_b, s_b, tol):
    """Scores agree within tol; ids differ only where the score is tied."""
    np.testing.assert_allclose(s_a, s_b, rtol=tol, atol=tol)
    for r in range(ids_a.shape[0]):
        for j in np.nonzero(ids_a[r] != ids_b[r])[0]:
            tied = np.abs(s_a[r] - s_a[r, j]) <= tol
            tied[j] = False
            assert tied.any(), (r, j, ids_a[r], ids_b[r])


# -- the plain walk against the JAX package ------------------------------------

@pytest.mark.parametrize("per_query", [False, True],
                         ids=["shared_entry", "per_query_entry"])
@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
@pytest.mark.parametrize("rows", ["exact", "pq_decoded"])
def test_plain_walk_matches_jax(rows, simf, per_query, corpus, jax_graph):
    """The port's walk (the kernel's plain version) on a JAX-built graph:
    the same results and counters as the JAX `beam_search`, fp32 rows to
    1e-5, bf16 decoded rows (bf16 queries, float32 sums) to 1e-4."""
    vectors, queries = corpus
    adj = np.asarray(jax_graph.adjacency)
    live = np.asarray(jax_graph.live)
    cap = adj.shape[0]
    rows_np = np.zeros((cap, D), np.float32)
    rows_np[:N] = vectors
    if per_query:
        entry = np.random.default_rng(5).choice(np.nonzero(live)[0], Q)
    else:
        entry = int(jax_graph.entry)
    kw = dict(L=40, E=4, R=20, max_iters=14)
    if rows == "exact":
        qstate, ctx = jnp.asarray(queries), {"vectors": jnp.asarray(rows_np)}
        trows = torch.from_numpy(rows_np)
        prov = tsearcher.ExactProvider(torch.from_numpy(queries), trows, simf)
        tol = 1e-5
    else:
        dec = jnp.asarray(rows_np).astype(jnp.bfloat16)
        qstate, ctx = jnp.asarray(queries).astype(jnp.bfloat16), {
            "vectors": dec}
        trows = torch.from_numpy(rows_np).bfloat16()
        prov = tsearcher.PQDecodedProvider(torch.from_numpy(queries), trows,
                                           simf)
        tol = 1e-4
    j_ids, j_scores, j_vis, j_exp = jsearcher.beam_search(
        jnp.asarray(adj), jnp.asarray(live), jnp.asarray(entry), qstate, ctx,
        jnp.asarray(live), jsearcher.make_exact_provider(simf.value), **kw)
    g = graph_from_numpy(adj, np.asarray(jax_graph.degrees), live,
                         int(jax_graph.entry), device="cpu")
    t_entry = torch.as_tensor(entry) if per_query else entry
    t_ids, t_scores, t_vis, t_exp = tsearcher.beam_search(
        g.adjacency, g.live, t_entry, prov, Q, g.live, **kw)
    _same_up_to_ties(np.asarray(j_ids), np.asarray(j_scores),
                     t_ids.numpy(), t_scores.numpy(), tol)
    np.testing.assert_array_equal(t_vis.numpy(), np.asarray(j_vis))
    np.testing.assert_array_equal(t_exp.numpy(), np.asarray(j_exp))


# -- the plain prune against the JAX package -----------------------------------

def _prune_inputs(c, simf, seed, b=48, d=24):
    """b points and c candidates each, near the point, with -1 pads,
    repeated ids, a pair of duplicated vectors and the point itself."""
    rng = np.random.default_rng(seed)
    corpus = _latent(rng, 600, d)
    corpus[11] = corpus[12]  # duplicated vectors
    if simf is SimilarityFunction.DOT_PRODUCT:
        corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    pids = rng.choice(600, b, replace=False)
    d2 = ((corpus[pids, None, :] - corpus[None, :, :]) ** 2).sum(-1)
    ids = np.argsort(d2, axis=1, kind="stable")[:, :c].astype(np.int32)
    ids[:, -4:] = -1
    ids[:, 5] = ids[:, 2]  # a repeated id
    ids[::3, 7] = pids[::3]  # the point itself, past its own first slot
    ids[::4, 8], ids[::4, 9] = 11, 12
    pv = corpus[pids]
    cv = corpus[np.maximum(ids, 0)]
    return corpus, pv, ids, cv, pids.astype(np.int32)


@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
@pytest.mark.parametrize("c", [132, 70, 128])
def test_plain_prune_matches_jax(c, simf):
    """`robust_prune_reference` against the JAX `robust_prune_batch` at the
    builder's widths (insert round 132, overflow 70, splice 128): the JAX
    selections are runs of the rule on the port's distances except through
    comparisons within `dcc_error_bound` of equality (the two packages sum
    the distances in different float32 orders; `selection_margins` share
    <= 1), the port's own run has margin 0, and most rows are equal."""
    corpus, pv, ids, cv, pids = _prune_inputs(c, simf, seed=c + simf.value)
    sc = np.asarray(jsearcher.batched_candidate_scores(
        jnp.asarray(pv), jnp.asarray(cv), JSim(simf.value)))
    sc = np.where(ids >= 0, sc, -np.inf).astype(np.float32)
    want = np.array(jbuilder.robust_prune_batch(
        jnp.asarray(pv), jnp.asarray(ids), jnp.asarray(cv), jnp.asarray(sc),
        1.2, 32, simf.value, point_ids=jnp.asarray(pids)))
    ids_t, sc_t = torch.from_numpy(ids).long(), torch.from_numpy(sc)
    pids_t = torch.from_numpy(pids).long()
    got = prune_kernel.robust_prune_reference(
        torch.from_numpy(pv), ids_t, torch.from_numpy(cv), sc_t, 1.2, 32,
        simf, point_ids=pids_t)
    rows = torch.from_numpy(corpus)
    margin, share, _ = prune_kernel.selection_margins(
        rows, ids_t, sc_t, 1.2, simf, pids_t, torch.from_numpy(want))
    assert float(share.max()) <= 1.0, float(share.max())
    own, own_share, _ = prune_kernel.selection_margins(
        rows, ids_t, sc_t, 1.2, simf, pids_t, got)
    assert float(own.max()) == 0.0 and float(own_share.max()) == 0.0
    got = got.numpy()
    same = (got == want).all(1)
    assert bool((margin[torch.from_numpy(~same)] > 0).all())
    assert same.mean() >= 0.9
    assert not (got == pids[:, None]).any()
    for row in got:  # first occurrences only
        sel = row[row >= 0]
        assert sel.size == np.unique(sel).size


def test_prune_keeps_duplicate_vectors_selectable():
    """The strict inequality: a candidate whose vector equals the point's
    (distance 0 from the point) is never pruned by another such candidate,
    in the plain version and in the wrapper's CPU route."""
    rng = np.random.default_rng(4)
    corpus = _latent(rng, 50, 8)
    corpus[1:4] = corpus[0]
    rows = torch.from_numpy(corpus)
    ids = torch.arange(1, 20).long()[None, :]
    sc = batched_candidate_scores(rows[:1], rows[ids], SimilarityFunction.
                                  EUCLIDEAN)
    got = prune_kernel.robust_prune(rows, ids, sc, 1.2, 8,
                                    SimilarityFunction.EUCLIDEAN,
                                    point_ids=torch.tensor([0]))
    assert {1, 2, 3} <= set(got[0].tolist())


@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_selection_margins_catch_a_wrong_selection(simf):
    """The check the kernel is held to separates: a selection taken out of
    the rule's order, a candidate the rule prunes far from any tie, a
    repeat or an id that is not a candidate each fail it; the plain run
    passes with margin 0 and counts the distances its steps compute."""
    corpus, _, ids, _, pids = _prune_inputs(132, simf, seed=5)
    rows = torch.from_numpy(corpus)
    ids_t, pids_t = torch.from_numpy(ids).long(), torch.from_numpy(pids).long()
    sc = batched_candidate_scores(rows[pids_t], rows[ids_t.clamp(min=0)],
                                  simf)
    sc = torch.where(ids_t >= 0, sc, float("-inf"))
    plain = prune_kernel.robust_prune_reference(
        None, ids_t, rows[ids_t.clamp(min=0)], sc, 1.2, 32, simf,
        point_ids=pids_t)
    margin, share, pairs = prune_kernel.selection_margins(
        rows, ids_t, sc, 1.2, simf, pids_t, plain)
    assert float(margin.max()) == 0.0 and bool((pairs > 0).all())
    k = (plain >= 0).sum(1)
    assert int(k.min()) >= 3
    swapped = plain.clone()
    swapped[:, [0, 1]] = swapped[:, [1, 0]]  # out of the rule's order
    repeat = plain.clone()
    repeat[:, 2] = repeat[:, 1]
    stranger = plain.clone()
    stranger[:, 1] = 599  # not among the candidates
    pruned = plain.clone()  # a candidate the rule pruned, far from a tie
    d_p = prune_kernel._score_to_dist(sc, simf)
    for r in range(ids.shape[0]):
        chosen = set(plain[r].tolist())
        order = torch.argsort(d_p[r]).tolist()
        cand = [ids[r, j] for j in order if ids[r, j] >= 0
                and ids[r, j] not in chosen and ids[r, j] != pids[r]]
        pruned[r, int(k[r]) - 1] = int(cand[-1])
    for bad in (swapped, repeat, stranger, pruned):
        _, s, _ = prune_kernel.selection_margins(rows, ids_t, sc, 1.2, simf,
                                                 pids_t, bad)
        assert bool((s > 1.0).all()), s


# -- the row providers -------------------------------------------------------------

def _closure_exact(queries, vectors, simf):
    """The exact provider as a closure, as it was before it became an
    object."""
    def score(ids):
        return batched_candidate_scores(queries, vectors[ids.clamp(min=0)],
                                        simf)
    return score


def _closure_pq_decoded(queries, decoded, simf):
    """The decoded-cache provider as a closure, as it was before it became an
    object."""
    dt = decoded.dtype

    def cast(x):
        return x.to(dt).float()

    def sq(x):
        return cast(torch.sum(x * x, -1, keepdim=True))

    def unit(x):
        return x * cast(torch.rsqrt(sq(x) + 1e-30))

    q = cast(queries)
    if simf is SimilarityFunction.COSINE:
        q = unit(q)
    q2 = sq(q)

    def score(ids):
        c = decoded[ids.clamp(min=0)].float()
        if simf is SimilarityFunction.COSINE:
            c = unit(c)
        dot = torch.bmm(c, q.unsqueeze(-1)).squeeze(-1)
        if simf is SimilarityFunction.EUCLIDEAN:
            return 1.0 / (1.0 + torch.clamp(
                q2 + sq(c).squeeze(-1) - 2.0 * dot, min=0.0))
        return (1.0 + dot) / 2.0
    return score


@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
@pytest.mark.parametrize("kind", ["exact", "pq_decoded", "pq_decoded_f32"])
def test_provider_objects_score_as_the_closures(kind, simf, corpus):
    """Bit for bit, -1 ids included; the prepared queries are the ones
    the formula uses."""
    vectors, queries = corpus
    q = torch.from_numpy(queries)
    rows = torch.from_numpy(vectors)
    ids = torch.as_tensor(np.random.default_rng(1).integers(-1, N, (Q, 37)))
    if kind == "exact":
        obj = tsearcher.ExactProvider(q, rows, simf)
        ref = _closure_exact(q, rows, simf)
    else:
        if kind == "pq_decoded":
            rows = rows.bfloat16()
        obj = tsearcher.PQDecodedProvider(q, rows, simf)
        ref = _closure_pq_decoded(q, rows, simf)
    assert isinstance(obj, tsearcher.RowProvider)
    assert obj.rounded == (kind == "pq_decoded")
    assert torch.equal(obj(ids), ref(ids))
    pq, pq2 = obj.prepared()
    assert pq.shape == (Q, D) and pq2.shape == (Q,)
    if simf is SimilarityFunction.COSINE:
        np.testing.assert_allclose(torch.linalg.vector_norm(pq, dim=1),
                                   1.0, atol=1e-2)


# -- the error bounds --------------------------------------------------------------

@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_kernel_error_bound_covers_a_float64_score(simf):
    """The stated score bound holds for the plain float32 score against the
    same formula in float64 (one summation order less than the bound
    covers), at d = 128 and d = 960."""
    for d in (128, 960):
        rng = np.random.default_rng(d)
        rows = torch.from_numpy(_latent(rng, 500, d))
        q = torch.from_numpy(_latent(rng, 16, d))
        ids = torch.as_tensor(rng.integers(0, 500, (16, 64)))
        prov = tsearcher.ExactProvider(q, rows, simf)
        exact = batched_candidate_scores(q.double(), rows.double()[ids], simf)
        err = (prov(ids).double() - exact).abs()
        assert bool((err <= beam_kernel.kernel_error_bound(prov, ids)).all())


@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_dcc_error_bound_covers_float64_distances(simf):
    from opensearch_jvector_tpu_torch.ops.distances import pairwise_scores

    rng = np.random.default_rng(7)
    v = torch.from_numpy(_latent(rng, 8 * 70, 128)).reshape(8, 70, 128)
    d32 = prune_kernel._score_to_dist(pairwise_scores(v, v, simf), simf)
    d64 = prune_kernel._score_to_dist(
        pairwise_scores(v.double(), v.double(), simf), simf)
    bound = prune_kernel.dcc_error_bound(v, d32, simf)
    assert bool(((d32.double() - d64).abs() <= bound).all())


def test_walk_reports_exact_ties_as_near():
    """Duplicated rows tie exactly at the pick and merge boundaries: the
    plain walk reports those queries, and its pool is the same with and
    without the report."""
    rng = np.random.default_rng(9)
    base = _latent(rng, 200, 8)
    rows = torch.from_numpy(np.concatenate([base, base]))  # every row twice
    n = rows.shape[0]
    near_ids = torch.cdist(rows, rows).topk(9, largest=False).indices[:, 1:]
    adj = near_ids.to(torch.int32).contiguous()
    q = torch.from_numpy(_latent(rng, 12, 8))
    prov = tsearcher.ExactProvider(q, rows, SimilarityFunction.EUCLIDEAN)
    plain = beam_kernel.beam_search_reference(adj, 0, prov, 12, 8, 2, 10)
    *pool, near, bound = beam_kernel.beam_search_reference(
        adj, 0, prov, 12, 8, 2, 10,
        tie_bound=lambda i: beam_kernel.kernel_error_bound(prov, i))
    assert all(torch.equal(a, b) for a, b in zip(plain, pool))
    assert bool(near.any()) and bound.shape == (12, 8)
    assert int(plain[0].max()) < n


# -- shared-memory sizing ------------------------------------------------------

# (L, E, M, max_iters, d) of every caller: the insert rounds (ef 100, E 8,
# cap_deg 38: degree 32 x overflow 1.2), add_nodes / refine_graph (the same
# rounds), the hierarchy descent (16, 4, upper degree 16, 8), the in_memory
# beam tier at ef 100 and 200 (E 16), the mesh engine (the same), the
# on_disk beam segments up to k x overquery^2 = 4,000 at overquery 20 (250
# iterations), degree 48's cap_deg 57, GIST's d = 960
CALLER_SHAPES = [
    (100, 8, 38, 21, 128), (100, 8, 57, 21, 960), (16, 4, 16, 8, 128),
    (16, 4, 16, 8, 960), (100, 16, 38, 8, 128), (200, 16, 38, 13, 128),
    (200, 16, 57, 13, 960), (250, 16, 38, 16, 128),
    (1000, 16, 57, 63, 960), (4000, 16, 38, 250, 128),
    (4000, 16, 57, 250, 960),
]


@pytest.mark.parametrize("shape", CALLER_SHAPES, ids=str)
def test_beam_smem_fits_every_caller_shape(shape):
    need, ws = beam_kernel.beam_plan(*shape)
    assert need == beam_kernel.beam_smem_bytes(*shape)
    assert need <= beam_kernel.SMEM_LIMIT and ws == 0


def test_beam_smem_raises_past_the_limit():
    """Past a block's shared memory the state moves to a device-memory
    workspace (k = 1,000 at overquery 10; m = 512's adjacency); only a
    shape past the kernel's 32-bit indexing raises."""
    assert beam_kernel.beam_smem_bytes(4000, 16, 57, 250) <= 232448
    for shape in [(6000, 16, 57, 375, 960), (100, 64, 400, 21, 128),
                  (10_000, 16, 38, 633, 128), (1000, 16, 614, 63, 16_000)]:
        need, ws = beam_kernel.beam_plan(*shape)
        assert need == 0 and ws == beam_kernel.beam_smem_bytes(*shape)
        assert ws > beam_kernel.SMEM_LIMIT
    with pytest.raises(ValueError, match="L=300000000, E=16, M=57"):
        beam_kernel.beam_plan(300_000_000, 16, 57, 21, 128)


# (C, d): the insert round at ef_construction 100, 256 and 10,000 (the
# config's largest) with m = 32 and 512, the overflow prune, the bootstrap
# block, dim 16,000 (the config's largest)
PRUNE_WIDTHS = [(132, 128), (288, 128), (544, 960), (10_032, 128),
                (10_512, 16_000), (70, 128), (100, 960)]


@pytest.mark.parametrize("shape", PRUNE_WIDTHS, ids=str)
def test_prune_smem_covers_the_builder_widths(shape):
    """Every width the builder reaches at the config's limits fits a
    block's shared memory; past it the kernel takes a workspace."""
    assert prune_kernel.prune_smem_bytes(*shape) <= prune_kernel.SMEM_LIMIT
    assert prune_kernel.prune_smem_bytes(20_000, 16_000) > (
        prune_kernel.SMEM_LIMIT)


def test_the_searcher_reaches_its_widest_shape_within_the_limit():
    """The on_disk reader's widest beam (k = 10 at overquery 20 asks for
    k x overquery candidates, searched with R = k x overquery^2) fits."""
    params = tsearcher.SearchParams(k=10 * 20, ef_search=100,
                                    overquery_factor=20,
                                    expansions_per_iter=16)
    r = params.k * params.overquery_factor
    assert r == 4000
    need, ws = beam_kernel.beam_plan(max(params.ef_search, r), 16, 57,
                                     params.resolved_iters(), 960)
    assert 0 < need <= beam_kernel.SMEM_LIMIT and ws == 0


# -- the wrappers on the CPU -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_beam_wrapper_on_cpu_runs_the_plain_walk(dtype, corpus, jax_graph):
    vectors, queries = corpus
    g = graph_from_numpy(np.asarray(jax_graph.adjacency),
                         np.asarray(jax_graph.degrees),
                         np.asarray(jax_graph.live), int(jax_graph.entry),
                         device="cpu")
    rows = torch.zeros((g.capacity, D))
    rows[:N] = torch.from_numpy(vectors)
    q = torch.from_numpy(queries)
    prov = (tsearcher.ExactProvider(q, rows, SimilarityFunction.COSINE)
            if dtype == "f32" else tsearcher.PQDecodedProvider(
                q, rows.bfloat16(), SimilarityFunction.EUCLIDEAN))
    before = beam_kernel.beam_search.launches
    got = beam_kernel.beam_search(g.adjacency, g.entry, prov, Q, 32, 8, 10)
    want = beam_kernel.beam_search_reference(g.adjacency, g.entry, prov, Q,
                                             32, 8, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert beam_kernel.beam_search.launches == before == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prune_wrapper_on_cpu_runs_the_plain_prune(dtype):
    corpus, _, ids, _, pids = _prune_inputs(132, SimilarityFunction.EUCLIDEAN,
                                            seed=3)
    rows = torch.from_numpy(corpus).to(dtype)
    ids_t = torch.from_numpy(ids).long()
    sc = batched_candidate_scores(rows[torch.from_numpy(pids).long()].float(),
                                  rows[ids_t.clamp(min=0)].float(),
                                  SimilarityFunction.EUCLIDEAN)
    sc = torch.where(ids_t >= 0, sc, float("-inf"))
    before = prune_kernel.robust_prune.launches
    got = prune_kernel.robust_prune(rows, ids_t, sc, 1.2, 32,
                                    SimilarityFunction.EUCLIDEAN,
                                    point_ids=torch.from_numpy(pids).long())
    want = prune_kernel.robust_prune_reference(
        None, ids_t, rows[ids_t.clamp(min=0)].float(), sc, 1.2, 32,
        SimilarityFunction.EUCLIDEAN,
        point_ids=torch.from_numpy(pids).long())
    assert torch.equal(got, want)
    assert prune_kernel.robust_prune.launches == before == 0
