"""The rest of the JAX package's surface in the port, against the JAX
package on the same seeded inputs or the same converted state:
`adc.lookup_candidates`, single-space `kmeans.train_kmeans`,
`ProductQuantization`'s size accessors and `encode_for_cosine`,
`VamanaGraph.size` / `id_upper_bound`, `SearchParams.resolved_iters`,
`SegmentReader.check_integrity` and `ShardedVectorIndex.deleted_docs_for`.

`resolved_iters` is the iteration count the search runs. Where
`max_iters` is set it equals the reference's accessor; where it is 0 the
reference's accessor returns max(8, ef_search), a value its own `search`
does not use, so the port's is held to the count the reference's `search`
derives (`opensearch_jvector_tpu/models/searcher.py:460-463`) and to the
count the port's beam search is given.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.api.config import DiskAnnConfig as JConfig
from opensearch_jvector_tpu.index import reader as jreader
from opensearch_jvector_tpu.index import store as jstore
from opensearch_jvector_tpu.models import graph as jgraph
from opensearch_jvector_tpu.models import pq as jpq
from opensearch_jvector_tpu.models.searcher import SearchParams as JParams
from opensearch_jvector_tpu.ops import adc as jadc
from opensearch_jvector_tpu.ops import kmeans as jkm
from opensearch_jvector_tpu.parallel.distributed import (
    ShardedVectorIndex as JSharded,
)
from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig
from opensearch_jvector_tpu_torch.convert import graph_from_numpy, pq_from_numpy
from opensearch_jvector_tpu_torch.index import store as tstore
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.reader import SegmentReader
from opensearch_jvector_tpu_torch.models import pq as tpq
from opensearch_jvector_tpu_torch.models import searcher as tsearcher
from opensearch_jvector_tpu_torch.models.searcher import SearchParams
from opensearch_jvector_tpu_torch.ops import adc as tadc
from opensearch_jvector_tpu_torch.ops import kmeans as tkm
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.parallel.distributed import ShardedVectorIndex

torch.set_num_threads(2)

D = 16


def _latent(rng, n, d=D):
    a = rng.standard_normal((8, d)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, d))).astype(np.float32)


# -- ops ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 8, 16, 37), (1, 4, 256, 1),
                                   (3, 16, 64, 200)], ids=str)
def test_lookup_candidates_matches_the_reference(shape):
    q, m, k, c = shape
    rng = np.random.default_rng(c)
    luts = rng.standard_normal((q, m, k)).astype(np.float32)
    codes = rng.integers(0, k, (q, c, m)).astype(np.uint8)
    want = np.asarray(jadc.lookup_candidates(jnp.asarray(luts),
                                             jnp.asarray(codes)))
    got = tadc.lookup_candidates(torch.from_numpy(luts),
                                 torch.from_numpy(codes))
    assert got.shape == (q, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _inertia(x, c):
    d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    return float(d2.min(1).sum())


@pytest.mark.parametrize("k", [4, 6])
def test_train_kmeans_matches_the_reference_inertia(k):
    rng = np.random.default_rng(k)
    centers = 10.0 * rng.standard_normal((k, 8))
    x = (centers[rng.integers(0, k, 600)]
         + rng.standard_normal((600, 8))).astype(np.float32)
    want = np.asarray(jkm.train_kmeans(jnp.asarray(x), k, iters=8,
                                       key=jax.random.PRNGKey(0)))
    got = [tkm.train_kmeans(torch.from_numpy(x), k, iters=8,
                            generator=torch.Generator().manual_seed(3))
           for _ in range(2)]
    assert got[0].shape == (k, 8) and torch.equal(got[0], got[1])
    j_in, t_in = _inertia(x, want), _inertia(x, got[0].numpy())
    assert abs(t_in - j_in) <= 0.05 * j_in, (t_in, j_in)


# -- accessors --------------------------------------------------------------------

def test_pq_accessors_and_cosine_encode_match_the_reference():
    rng = np.random.default_rng(5)
    m, k = 4, 32
    cb = rng.standard_normal((m, k, D // m)).astype(np.float32)
    center = np.zeros(D, np.float32)
    jq = jpq.ProductQuantization(codebooks=jnp.asarray(cb),
                                 center=jnp.asarray(center))
    tq = pq_from_numpy(cb, center, device="cpu")
    assert (tq.num_subspaces, tq.num_clusters, tq.dim) == (
        jq.num_subspaces, jq.num_clusters, jq.dim) == (m, k, D)
    assert (tq.compressed_bytes(), tq.original_bytes()) == (
        jq.compressed_bytes(), jq.original_bytes()) == (m, 4 * D)
    v = _latent(rng, 300)
    want = np.asarray(jpq.encode_for_cosine(jq, jnp.asarray(v)))
    got = tpq.encode_for_cosine(tq, torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpq.encode(tq, torch.from_numpy(v), SimilarityFunction.COSINE).numpy(),
        want)


@pytest.mark.parametrize("dead", [[], [3, 9], [40, 63], list(range(64))],
                         ids=str)
def test_graph_size_and_id_upper_bound_match_the_reference(dead):
    rng = np.random.default_rng(7)
    cap, deg = 64, 6
    adj = rng.integers(-1, 41, (cap, deg)).astype(np.int32)
    live = np.zeros(cap, bool)
    live[:41] = True
    live[63] = True
    live[dead] = False
    degrees = (adj >= 0).sum(1).astype(np.int32)
    jg = jgraph.VamanaGraph(adjacency=jnp.asarray(adj),
                            degrees=jnp.asarray(degrees),
                            live=jnp.asarray(live), entry=jnp.int32(0))
    tg = graph_from_numpy(adj, degrees, live, 0, device="cpu")
    assert tg.size() == jg.size() == int(live.sum())
    assert tg.id_upper_bound() == jg.id_upper_bound()


def _reference_search_iters(p):
    """The iteration count the reference's `search` derives."""
    ef = max(p.ef_search, max(p.k * p.overquery_factor, p.k))
    return p.max_iters or max(8, (ef + p.expansions_per_iter - 1)
                              // p.expansions_per_iter)


@pytest.mark.parametrize("kw", [
    dict(k=10), dict(k=10, ef_search=200), dict(k=10, ef_search=48,
                                                expansions_per_iter=4),
    dict(k=50, overquery_factor=5, expansions_per_iter=2),
    dict(k=10, max_iters=3), dict(k=10, ef_search=300, max_iters=40),
], ids=str)
def test_resolved_iters_is_the_searchs_iteration_count(kw, monkeypatch):
    tp, jp = SearchParams(**kw), JParams(**kw)
    if jp.max_iters:
        assert tp.resolved_iters() == jp.resolved_iters()
    assert tp.resolved_iters() == _reference_search_iters(jp)

    seen = []
    real = tsearcher.beam_search

    def spy(*a, **k):
        seen.append(k["max_iters"])
        return real(*a, **k)

    monkeypatch.setattr(tsearcher, "beam_search", spy)
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(_latent(rng, 64))
    adj = torch.from_numpy(
        rng.integers(0, 64, (64, 8)).astype(np.int32))
    live = torch.ones(64, dtype=torch.bool)
    tsearcher.search(adj, live, 0, rows[:3], tp,
                     SimilarityFunction.EUCLIDEAN, vectors=rows)
    assert seen == [tp.resolved_iters()]


@pytest.mark.parametrize("mode", ["in_memory", "on_disk"])
def test_check_integrity_matches_the_reference(mode, tmp_path):
    v = _latent(np.random.default_rng(11), 300)
    idx = VectorIndex(tmp_path, DiskAnnConfig(
        dim=D, m=8, ef_construction=32, num_pq_subspaces=4, mode=mode,
        min_batch_size_for_quantization=64), device="cpu")
    idx.add_batch(np.arange(300), v)
    seg = tmp_path / idx.flush()
    idx.close()
    jr = jreader.SegmentReader.open(seg)
    assert SegmentReader.check_integrity(seg) is jr.check_integrity(seg) is True
    files = sorted(f for f in seg.iterdir()
                   if f.suffix in (".jvtpu", ".f32"))
    assert files and (mode == "in_memory" or any(f.suffix == ".f32"
                                                  for f in files))
    for f in files:
        raw = f.read_bytes()
        flipped = bytearray(raw)
        flipped[len(raw) // 2] ^= 0x40
        f.write_bytes(bytes(flipped))
        with pytest.raises(tstore.CorruptSegmentError):
            SegmentReader.check_integrity(seg)
        with pytest.raises(jstore.CorruptSegmentError):
            jr.check_integrity(seg)
        f.write_bytes(raw)
    assert SegmentReader.check_integrity(seg)


def test_sharded_deleted_docs_for_matches_the_reference(tmp_path):
    v = _latent(np.random.default_rng(13), 400)
    dead = [1, 2, 7, 150, 151, 399]
    j = JSharded(tmp_path, JConfig(dim=D, m=8, ef_construction=32,
                                   quantization_type="none"), n_shards=2)
    for lo, hi in ((0, 200), (200, 400)):
        j.add_batch(np.arange(lo, hi), v[lo:hi])
        j.flush()
    j.delete(dead)
    j.close()
    j = JSharded(tmp_path)
    t = ShardedVectorIndex(tmp_path, device="cpu")
    assert t.segment_names == j.segment_names and len(t.segment_names) == 4
    got = {n: t.deleted_docs_for(n) for n in t.segment_names}
    assert got == {n: frozenset(j.deleted_docs_for(n))
                   for n in j.segment_names}
    assert set().union(*got.values()) == set(dead)
    t.close()
    j.close()
