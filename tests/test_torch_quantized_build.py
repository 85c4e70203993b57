"""The port's quantized build and `flush(device_rows=...)`.

The quantized build (on_disk PQ graph segments at capacity >= 2^22) is
reached at test scale by lowering `writer.quantized_build_min_capacity`.
The JAX package's own quantized build writes a dead-entry graph for any
flush that is not a power of two (its medoid can land on a capacity pad
row), so the port is held against its own fp32 build instead:
  * a non-pow2 flush and a merge at the gate: recall@10 within RECALL_BAND
    of the fp32 build's, a live entry, degree <= m, no self-loop, no
    duplicate neighbour, every live node reachable from the entry; the row
    file holds the true fp32 rows and the JAX package reads the segment;
  * `device_rows`: codes, doc ids and answers bit-equal to the host path,
    for a flat, an fp32-built vamana and a quantized-build segment and an
    in_memory one; the provider is ignored after an in-buffer dedup and
    after a buffered delete, also when the flush that follows fails;
  * an fp32 source builds exactly the graphs it built before bf16 sources
    were passed through the builder (digests of adjacency, degrees, live
    mask, entry and upper layer).
"""

import collections
import hashlib

import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.index import segment as jsegment
from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig, SearchConfig
from opensearch_jvector_tpu_torch.index import reader as treader
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.scheduler import (
    ForceMergesOnlyMergePolicy,
)
from opensearch_jvector_tpu_torch.index.segment import read_segment
from opensearch_jvector_tpu_torch.models import builder as tbuilder
from opensearch_jvector_tpu_torch.models import pq as tpq
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.utils.circuit_breaker import (
    BREAKER,
    CircuitBreakerException,
)
from opensearch_jvector_tpu_torch.utils.ground_truth import (
    ground_truth_topk,
    recall_at_k,
)

torch.set_num_threads(2)

D, N, K = 16, 900, 10
RECALL_BAND = 0.1  # the quantized build's recall@10 against the fp32 build's
EUCLID = SimilarityFunction.EUCLIDEAN
PQ = dict(dim=D, m=8, ef_construction=48, quantization_type="pq",
          min_batch_size_for_quantization=128, num_pq_subspaces=8)


def _latent(rng, n):
    a = rng.standard_normal((8, D)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    return _latent(rng, N), _latent(rng, 32)


@pytest.fixture
def beam_tier(monkeypatch):
    """Graph segments take the beam tier, so the graph itself is read."""
    monkeypatch.setattr(treader.SegmentReader, "SCAN_TIER_MAX_CODES", 0)


def _index(root, quantized: bool, **cfg):
    idx = VectorIndex(root, DiskAnnConfig(**{**PQ, "mode": "on_disk", **cfg}),
                      device="cpu", merge_policy=ForceMergesOnlyMergePolicy())
    if quantized:
        idx.writer.quantized_build_min_capacity = 1
    return idx


def _sources(monkeypatch) -> list:
    """Record the dtype of every build source the builder's cleanup sees
    (fresh builds and delta inserts both end there)."""
    seen = []
    real = tbuilder.GraphIndexBuilder.cleanup
    monkeypatch.setattr(tbuilder.GraphIndexBuilder, "cleanup",
                        lambda self, g, rows, *a: seen.append(rows.dtype)
                        or real(self, g, rows, *a))
    return seen


def _check_invariants(seg, m):
    adj = seg.graph.adjacency.numpy()
    deg = seg.graph.degrees.numpy()
    live = seg.graph.live.numpy()
    entry = seg.graph.entry
    used = seg.docmap.num_ordinals
    assert live[entry] and entry < used  # a live, used ordinal
    assert not live[used:].any() and (deg <= m).all()
    for i in np.nonzero(live)[0]:
        row = adj[i][adj[i] >= 0]
        assert i not in row and np.unique(row).size == row.size
        assert live[row].all() and row.size == deg[i]
    seen = {entry}
    todo = collections.deque([entry])
    while todo:
        for j in adj[todo.popleft()]:
            if j >= 0 and live[j] and j not in seen:
                seen.add(int(j))
                todo.append(int(j))
    assert len(seen) == int(live.sum())


def _recall(idx, corpus, live_ids=None):
    v, q = corpus
    ids = np.arange(N) if live_ids is None else live_ids
    truth = ids[ground_truth_topk(torch.from_numpy(q), torch.from_numpy(v[ids]),
                                  K, EUCLID)]
    res = idx.search(q, SearchConfig(k=K, ef_search=64))
    return recall_at_k(res.doc_ids, truth, K)


def test_quantized_flush_matches_the_fp32_build(tmp_path, corpus, beam_tier,
                                                monkeypatch):
    v, _ = corpus
    exact = _index(tmp_path / "exact", False)
    exact.add_batch(np.arange(N), v)
    exact.flush()
    seen = _sources(monkeypatch)
    quant = _index(tmp_path / "quant", True)
    quant.add_batch(np.arange(N), v)
    name = quant.flush()
    assert seen == [torch.bfloat16]
    seg = quant._reader(name).seg
    assert seg.capacity() == 1024 and seg.vectors is None
    np.testing.assert_array_equal(seg.row_store.gather(np.arange(N)), v)
    _check_invariants(seg, PQ["m"])
    rec_q, rec_e = _recall(quant, corpus), _recall(exact, corpus)
    assert rec_q >= rec_e - RECALL_BAND and rec_q >= 0.8, (rec_q, rec_e)
    # the JAX package reads the segment: same graph, codes and rows
    jseg = jsegment.read_segment(tmp_path / "quant" / name)
    np.testing.assert_array_equal(np.asarray(jseg.graph.adjacency)[:N],
                                  seg.graph.adjacency.numpy()[:N])
    assert int(jseg.graph.entry) == seg.graph.entry
    np.testing.assert_array_equal(np.asarray(jseg.pqv.codes)[:N],
                                  seg.pqv.codes.numpy()[:N])
    np.testing.assert_array_equal(jseg.row_store.gather(np.arange(N)), v)
    for i in (exact, quant):
        i.close()


@pytest.mark.parametrize("deleted", [False, True])
def test_quantized_merge_matches_the_fp32_merge(tmp_path, corpus, beam_tier,
                                                monkeypatch, deleted):
    """Two flushes and a force_merge at the gate (incremental merge; with
    deletes folded in): the same bands as the flush."""
    v, _ = corpus
    dead = np.arange(0, N, 9) if deleted else np.empty(0, np.int64)
    live_ids = np.setdiff1d(np.arange(N), dead)
    out = {}
    for quantized in (False, True):
        idx = _index(tmp_path / str(quantized), False)
        for lo, hi in ((0, 600), (600, N)):
            idx.add_batch(np.arange(lo, hi), v[lo:hi])
            idx.flush()
        if deleted:
            idx.delete(dead)
        if quantized:
            idx.writer.quantized_build_min_capacity = 1
            seen = _sources(monkeypatch)
        name = idx.force_merge()
        seg = idx._reader(name).seg
        if quantized:
            assert seen == [torch.bfloat16]
            _check_invariants(seg, PQ["m"])
            assert seg.vectors is None
            o2d = seg.docmap.ord_to_doc
            mapped = np.nonzero(o2d >= 0)[0]  # folded deletes map to -1
            np.testing.assert_array_equal(seg.row_store.gather(mapped),
                                          v[o2d[mapped]])
        out[quantized] = _recall(idx, corpus, live_ids)
        res = idx.search(corpus[1], SearchConfig(k=K))
        assert not np.isin(res.doc_ids, dead).any()
        assert idx.doc_count() == live_ids.size
        idx.close()
    assert out[True] >= out[False] - RECALL_BAND and out[True] >= 0.8, out


def test_build_batch_size_reaches_the_flush_and_merge_builders(
        tmp_path, corpus, monkeypatch):
    """`writer.build_batch_size` (bench's graph tier sets 8192) sizes the
    insert batches of a flush's and a merge's builder; None leaves the
    builder's own size."""
    v, _ = corpus
    sizes = []
    real = tbuilder.GraphIndexBuilder.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        sizes.append(self.batch_size)

    monkeypatch.setattr(tbuilder.GraphIndexBuilder, "__init__", spy)
    idx = _index(tmp_path, True)
    assert idx.writer.build_batch_size is None
    idx.add_batch(np.arange(300), v[:300])
    idx.flush()
    default = sizes[-1]
    idx.writer.build_batch_size = 96
    idx.add_batch(np.arange(300, 600), v[300:600])
    idx.flush()
    idx.force_merge()
    assert default != 96 and sizes[1:] == [96] * (len(sizes) - 1)
    idx.close()


def test_a_dedup_under_the_minimum_batch_takes_the_fp32_build(tmp_path,
                                                              monkeypatch):
    """The gate is read after the in-buffer dedup: 200 rows, half of them
    updates, leave 100 docs, under the minimum batch of 128."""
    rng = np.random.default_rng(2)
    idx = _index(tmp_path, True)
    seen = _sources(monkeypatch)
    idx.add_batch(np.arange(100), _latent(rng, 100))
    idx.add_batch(np.arange(100), _latent(rng, 100))
    name = idx.flush()
    seg = idx._reader(name).seg
    assert seen == [torch.float32] and seg.pqv is None
    assert seg.docmap.num_ordinals == 100
    idx.close()


# -- flush(device_rows=...) ----------------------------------------------------

CONFIGS = {
    "on_disk_flat": dict(mode="on_disk", index_type="flat"),
    "on_disk_vamana": dict(mode="on_disk"),
    "on_disk_quantized": dict(mode="on_disk"),
    "in_memory": dict(mode="in_memory"),
}


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_device_rows_match_the_host_path(tmp_path, corpus, kind):
    v, q = corpus
    calls = []

    def provider(lo, hi):
        calls.append((lo, hi))
        return torch.from_numpy(v[lo:hi].copy())

    segs, answers = [], []
    for rows in (None, provider):
        idx = _index(tmp_path / str(rows is None), kind == "on_disk_quantized",
                     **CONFIGS[kind])
        idx.add_batch(np.arange(N), v)
        name = idx.flush(device_rows=rows)
        segs.append(read_segment(idx.root / name, "cpu"))
        answers.append(idx.search(q, SearchConfig(k=K)))
        idx.close()
    assert calls and calls[0] == (0, N)  # one DEVICE_ROWS_BLOCK covers N
    host, dev = segs
    np.testing.assert_array_equal(host.pqv.codes.numpy(),
                                  dev.pqv.codes.numpy())
    np.testing.assert_array_equal(host.docmap.ord_to_doc, dev.docmap.ord_to_doc)
    np.testing.assert_array_equal(host.graph.adjacency.numpy(),
                                  dev.graph.adjacency.numpy())
    np.testing.assert_array_equal(answers[0].doc_ids, answers[1].doc_ids)
    np.testing.assert_array_equal(answers[0].scores, answers[1].scores)
    for s in segs:
        if s.row_store is not None:
            np.testing.assert_array_equal(s.row_store.gather(np.arange(N)), v)
            s.row_store.close()


def _poisoned(lo, hi):
    raise AssertionError("the provider was used")


@pytest.mark.parametrize("kind", ["on_disk_flat", "on_disk_quantized"])
def test_device_rows_ignored_after_a_dedup(tmp_path, corpus, kind):
    v, _ = corpus
    idx = _index(tmp_path, kind == "on_disk_quantized", **CONFIGS[kind])
    idx.add_batch(np.arange(300), v[:300])
    idx.add(0, v[500])  # an update: the buffer keeps the last copy
    idx.flush(device_rows=_poisoned)
    got, found = idx.get_vectors([0, 1])
    assert found.all()
    np.testing.assert_array_equal(got, v[[500, 1]])
    idx.close()


@pytest.mark.parametrize("kind", ["on_disk_flat", "on_disk_quantized"])
def test_device_rows_ignored_after_a_buffered_delete(tmp_path, corpus, kind,
                                                     monkeypatch):
    """A buffered delete compacts the blocks; the next flush ignores its
    provider, also when that flush fails first (the flag is restored with
    the buffer) and is then retried."""
    v, _ = corpus
    idx = _index(tmp_path / "idx", kind == "on_disk_quantized",
                 **CONFIGS[kind])
    idx.add_batch(np.arange(300), v[:300])
    idx.delete([5])
    monkeypatch.setattr(BREAKER, "device_memory", lambda dev: (1, 1))
    with pytest.raises(CircuitBreakerException):
        idx.flush(device_rows=_poisoned)
    monkeypatch.undo()
    assert idx.writer.num_buffered() == 299
    name = idx.flush(device_rows=_poisoned)
    seg = idx._reader(name).seg
    # the codes of a clean host-only flush of the compacted buffer
    keep = np.arange(300) != 5
    clean = _index(tmp_path / "clean", kind == "on_disk_quantized",
                   **CONFIGS[kind])
    clean.add_batch(np.arange(300)[keep], v[:300][keep])
    want = clean._reader(clean.flush()).seg
    np.testing.assert_array_equal(seg.pqv.codes.numpy(),
                                  want.pqv.codes.numpy())
    np.testing.assert_array_equal(seg.docmap.ord_to_doc,
                                  np.arange(300)[keep])
    for i in (idx, clean):
        i.close()


# -- the fp32 source ------------------------------------------------------------

# sha256 prefixes of (adjacency, degrees, live, entry, upper layer) of the
# builds in `_fp32_builds`, as the builder produced them while it upcast
# every source to float32 on entry
FP32_DIGESTS = ["8793ea964ad99222", "8793ea964ad99222", "fd6c89f52a03d2ee",
                "2189c5e542c89b71", "2189c5e542c89b71", "41fb0a50150203e0"]


def _digest(g) -> str:
    m = hashlib.sha256()
    for t in (g.adjacency, g.degrees, g.live):
        m.update(t.numpy().tobytes())
    m.update(str(int(g.entry)).encode())
    if g.upper_adjacency is not None:
        m.update(g.upper_adjacency.numpy().tobytes())
    return m.hexdigest()[:16]


def test_an_fp32_source_builds_the_same_graphs():
    """build (with the hierarchy layer), build beside a decoded-PQ beam
    source, and add_nodes + mark_deleted (the entry included) + cleanup,
    for euclidean and cosine."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal((700, 16)).astype(np.float32))
    out = []
    for simf in (SimilarityFunction.EUCLIDEAN, SimilarityFunction.COSINE):
        b = tbuilder.GraphIndexBuilder(16, max_degree=8, beam_width=32,
                                       hierarchy_enabled=True)
        g = b.build(v[:600], simf, capacity=600)
        out.append(_digest(g))
        pq = tpq.train_pq(v[:600], simf, num_subspaces=4)
        dec = tpq.PQVectors(pq=pq,
                            codes=tpq.encode(pq, v[:600], simf)).decode_bf16()
        out.append(_digest(b.build(v[:600], simf, pq={"decoded": dec})))
        g3 = b.add_nodes(g.with_capacity(1024), v, np.arange(600, 700), simf)
        g3 = b.mark_deleted(g3, np.array([g3.entry, 5, 6, 7]))
        out.append(_digest(b.cleanup(g3, v, simf)))
    assert out == FP32_DIGESTS
