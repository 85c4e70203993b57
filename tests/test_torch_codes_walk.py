"""The walk over PQ codes on the CPU: the `pq` provider object, the plain
version of the kernel's ADC-table scoring and its error bound, the
shared-memory sizing with the table, and the CPU route.

On a card the walk of a `CodesProvider` is one launch of
`csrc/beam_search.cu` (held against the plain walk in
`tests/test_torch_cuda.py`); here the provider is held bit for bit to the
closure it replaced, the table scoring (`beam_kernel.codes_table_scores`)
to the provider within `beam_kernel.codes_error_bound`, that bound to a
float64 score, a walk scored by the table to the provider's walk wherever
the plain walk reports no near tie, and the wrapper's CPU route to the
plain walk, steps reported.
"""

import numpy as np
import pytest
import torch

from opensearch_jvector_tpu_torch.api.stats import Counter, StatsRegistry
from opensearch_jvector_tpu_torch.models import pq as tpq
from opensearch_jvector_tpu_torch.models import searcher as tsearcher
from opensearch_jvector_tpu_torch.ops import beam_kernel
from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    batched_candidate_scores,
    pairwise_sqdist,
)

torch.set_num_threads(2)

N, D, Q, M, DEG = 3000, 96, 48, 48, 24
SIMFS = list(SimilarityFunction)


def _latent(rng, n, d=D):
    a = rng.standard_normal((12, d)) / np.sqrt(12)
    return (rng.standard_normal((n, 12)) @ a
            + 0.05 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    """Rows, queries and a navigable graph over the rows: each row's
    DEG - 4 nearest rows, two random links and two -1 slots."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_latent(rng, N))
    near = torch.topk(pairwise_sqdist(x, x), DEG - 3,
                      largest=False).indices[:, 1:]
    rand = torch.from_numpy(rng.integers(0, N, (N, 2)))
    adj = torch.cat([near, rand, torch.full((N, 2), -1)], 1)
    return x, torch.from_numpy(_latent(rng, Q)), adj.to(torch.int32)


@pytest.fixture(scope="module")
def quantized(corpus):
    """simf -> (codes, codebooks, center) of a PQ48 trained on the rows."""
    x, _, _ = corpus
    out = {}
    for simf in SIMFS:
        pq = tpq.train_pq(x, simf, M)
        out[simf] = (tpq.encode(pq, x, simf), pq.codebooks, pq.center)
    return out


def _closure(queries, codes, codebooks, center, simf):
    """The `pq` provider as a closure, as it was before it became an
    object."""
    q = queries if center is None else queries - center
    score_simf = simf
    if simf is SimilarityFunction.COSINE:
        q = q * torch.rsqrt(torch.sum(q * q, -1, keepdim=True) + 1e-30)
        score_simf = SimilarityFunction.DOT_PRODUCT
    sub = torch.arange(codebooks.shape[0], device=codes.device)

    def score(ids):
        c = codes[ids.clamp(min=0)].long()
        dec = codebooks[sub, c].reshape(*ids.shape, -1)
        return batched_candidate_scores(q, dec, score_simf)

    return score


@pytest.mark.parametrize("centered", [False, True],
                         ids=["no_center", "center"])
@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_codes_provider_scores_as_the_closure(simf, centered, corpus,
                                              quantized):
    """Bit for bit, -1 ids included; cosine scores as a dot product of
    the normalised centred queries, which `prepared()` returns."""
    _, queries, _ = corpus
    codes, cb, center = quantized[simf]
    center = center + 0.01 if centered else None
    ids = torch.as_tensor(np.random.default_rng(2).integers(-1, N, (Q, 41)))
    obj = tsearcher.CodesProvider(queries, codes, cb, center, simf)
    ref = _closure(queries, codes, cb, center, simf)
    assert torch.equal(obj(ids), ref(ids))
    q, q2 = obj.prepared()
    assert q.shape == (Q, D) and q2.shape == (Q,)
    assert torch.equal(q2, torch.sum(q * q, -1))
    want = (SimilarityFunction.EUCLIDEAN if simf is
            SimilarityFunction.EUCLIDEAN else SimilarityFunction.DOT_PRODUCT)
    assert obj.simf is want
    if simf is SimilarityFunction.COSINE:
        np.testing.assert_allclose(torch.linalg.vector_norm(q, dim=1), 1.0,
                                   rtol=1e-6)


def _random_pq(seed, m, k, d, n=2000):
    rng = np.random.default_rng(seed)
    cb = torch.from_numpy(rng.standard_normal((m, k, d // m))
                          .astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, k, (n, m)).astype(np.uint8))
    q = torch.from_numpy(rng.standard_normal((16, d)).astype(np.float32))
    center = torch.from_numpy(0.1 * rng.standard_normal(d)
                              .astype(np.float32))
    return q, codes, cb, center, torch.as_tensor(rng.integers(-1, n, (16, 300)))


# (M, K, d): the deployment's PQ48, PQ64 at d = 128, a narrow K, dsub 5
PQ_SHAPES = [(48, 256, 96), (64, 256, 128), (16, 100, 32), (24, 256, 120)]


@pytest.mark.parametrize("shape", PQ_SHAPES, ids=str)
@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_table_scoring_stays_within_the_bound(simf, shape):
    """The kernel's scoring written plainly (a table a query, its entries
    summed subspace by subspace) against the provider's decode: within
    `codes_error_bound`, and not bit-equal (the bound is doing work)."""
    q, codes, cb, center, ids = _random_pq(sum(shape), *shape)
    prov = tsearcher.CodesProvider(q, codes, cb, center, simf)
    got = beam_kernel.codes_table_scores(prov, ids)
    want = prov(ids)
    bound = beam_kernel.codes_error_bound(prov, ids)
    assert got.shape == want.shape == bound.shape == ids.shape
    assert bool(((got - want).abs() <= bound).all())
    assert bool((bound > 0).all())


@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_codes_error_bound_covers_a_float64_score(simf, corpus, quantized):
    """The bound holds for the provider's float32 score and for the table
    scoring against the decode's formula in float64, over a trained PQ48
    and a random one."""
    _, queries, _ = corpus
    codes, cb, center = quantized[simf]
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, N, (Q, 64)))
    cases = [tsearcher.CodesProvider(queries, codes, cb, center, simf)]
    q, codes2, cb2, center2, ids2 = _random_pq(9, 48, 256, 96)
    cases.append(tsearcher.CodesProvider(q, codes2, cb2, center2, simf))
    for prov, i in zip(cases, (ids, ids2.clamp(min=0))):
        qq, _ = prov.prepared()
        exact = batched_candidate_scores(qq.double(),
                                         prov.decoded(i).double(), prov.simf)
        bound = beam_kernel.codes_error_bound(prov, i)
        for got in (prov(i), beam_kernel.codes_table_scores(prov, i)):
            assert bool(((got.double() - exact).abs() <= bound).all())


@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_a_walk_scored_by_the_table_matches_where_no_near_tie(
        simf, corpus, quantized):
    """The plain walk scored by the table (the kernel's arithmetic) and by
    the provider: the same pool and counters on every query the plain walk
    does not report as near a tie under `codes_error_bound`, and on most
    queries overall."""
    _, queries, adj = corpus
    codes, cb, center = quantized[simf]
    prov = tsearcher.CodesProvider(queries, codes, cb, center, simf)
    ids, _, vis, exp, near, _ = beam_kernel.beam_search_reference(
        adj, 17, prov, Q, 64, 8, 10,
        tie_bound=lambda i: beam_kernel.codes_error_bound(prov, i))
    gi, _, gv, ge = beam_kernel.beam_search_reference(
        adj, 17, lambda i: beam_kernel.codes_table_scores(prov, i), Q, 64, 8,
        10)
    same = ((torch.sort(gi, 1).values == torch.sort(ids, 1).values).all(1)
            & (gv == vis) & (ge == exp))
    assert bool(same[~near].all())
    assert float(same.float().mean()) >= 0.9 and bool((~near).any())


# (L, E, M, max_iters, M_pq x K) of the codes walk's callers: the in_memory
# beam tier of an NVQ segment at ef 100 and 200 (degree 32; a merged
# graph's 38), its hierarchy descent, PQ64 at d = 128, the on_disk beam tier
# codes-only at overquery 5
CODES_SHAPES = [(200, 16, 32, 13, 48 * 256), (100, 16, 32, 8, 48 * 256),
                (200, 16, 38, 13, 48 * 256), (16, 4, 16, 8, 48 * 256),
                (200, 16, 32, 13, 64 * 256), (250, 16, 38, 16, 64 * 256)]


@pytest.mark.parametrize("shape", CODES_SHAPES, ids=str)
def test_beam_plan_with_the_table_fits_every_caller_shape(shape):
    need, ws = beam_kernel.beam_plan(*shape)
    assert need == beam_kernel.beam_smem_bytes(*shape)
    assert need <= beam_kernel.SMEM_LIMIT and ws == 0
    table = 4 * shape[4]
    assert need - beam_kernel.beam_smem_bytes(*shape[:4], 0) == table


def test_beam_plan_with_the_table_raises_past_the_limit():
    """A table of PQ192 (d 768-1,536) beside a pool of 200, or the on_disk
    beam tier's pool of 4,000, takes a workspace; a table past the
    kernel's 32-bit indexing raises."""
    for shape in [(200, 16, 38, 13, 192 * 256), (4000, 16, 57, 250, 64 * 256),
                  (200, 16, 32, 13, 2000 * 256)]:
        need, ws = beam_kernel.beam_plan(*shape)
        assert need == 0 and ws == beam_kernel.beam_smem_bytes(*shape)
        assert ws > beam_kernel.SMEM_LIMIT
    with pytest.raises(ValueError, match="d=268435456"):
        beam_kernel.beam_plan(200, 16, 32, 13, 2**20 * 256)


@pytest.mark.parametrize("per_query", [False, True],
                         ids=["shared_entry", "per_query_entry"])
@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_codes_wrapper_on_cpu_runs_the_plain_walk(simf, per_query, corpus,
                                                  quantized):
    """On CPU tensors the wrapper is the plain walk, bit for bit; it
    reports its steps, launches nothing and reports no launch."""
    _, queries, adj = corpus
    codes, cb, center = quantized[simf]
    prov = tsearcher.CodesProvider(queries, codes, cb, center, simf)
    entry = (torch.as_tensor(np.random.default_rng(4).integers(0, N, Q))
             if per_query else 5)
    steps, launches = [], []
    before = beam_kernel.beam_search.codes_launches
    got = beam_kernel.beam_search(adj, entry, prov, Q, 64, 8, 10,
                                  on_steps=steps.append,
                                  on_launches=launches.append)
    want_steps = []
    want = beam_kernel.beam_search_reference(adj, entry, prov, Q, 64, 8, 10,
                                             on_steps=want_steps.append)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert steps == want_steps and 1 <= steps[0] <= 10 and launches == []
    assert beam_kernel.beam_search.codes_launches == before == 0


def test_the_wrapper_refuses_codes_on_another_device_than_the_graph(
        corpus, quantized):
    _, queries, adj = corpus
    codes, cb, center = quantized[SimilarityFunction.EUCLIDEAN]
    prov = tsearcher.CodesProvider(queries, codes.to("meta"), cb, center,
                                   SimilarityFunction.EUCLIDEAN)
    with pytest.raises(ValueError, match="codes on meta"):
        beam_kernel.beam_search(adj, 0, prov, Q, 64, 8, 10)


def test_the_searcher_walks_a_codes_provider_through_the_wrapper(
        corpus, quantized, monkeypatch):
    """`searcher.search` over PQ codes hands a `CodesProvider` to
    `beam_kernel.beam_search` on both layers (the hierarchy descent and
    the base walk) and counts the plain walk's steps, no launch."""
    x, queries, adj = corpus
    codes, cb, center = quantized[SimilarityFunction.COSINE]
    seen = []
    original = beam_kernel.beam_search

    def spy(adjacency, entry, provider, *a, **kw):
        seen.append(type(provider))
        return original(adjacency, entry, provider, *a, **kw)

    monkeypatch.setattr(beam_kernel, "beam_search", spy)
    live = torch.ones(N, dtype=torch.bool)
    res = tsearcher.search(
        adj, live, 0, queries, tsearcher.SearchParams(k=10, ef_search=64),
        SimilarityFunction.COSINE, pq_codes=codes, pq_codebooks=cb,
        pq_center=center, vectors=x, upper_adjacency=adj[:, :8].contiguous())
    assert seen == [tsearcher.CodesProvider] * 2
    assert res.codes_walk_steps > 0 and res.codes_walk_launches == 0
    assert bool((res.ids >= 0).all())


def test_the_codes_walk_launches_counter_exists():
    stats = StatsRegistry()
    assert stats.get(Counter.KNN_QUERY_CODES_WALK_LAUNCHES) == 0
    stats.increment(Counter.KNN_QUERY_CODES_WALK_LAUNCHES, 2)
    assert stats.snapshot()["knn_query_codes_walk_launches"] == 2
