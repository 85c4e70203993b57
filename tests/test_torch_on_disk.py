"""Port parity for the on_disk tier: fp32 rows in the host row store, the
approximate phase on the device, the exact rerank on the host.

on_disk index directories cross between the packages both ways (flat and
vamana segments; raw row files byte-identical, integrity checks pass
across), and each rung of the tier returns the same doc ids up to ties and
the same counters in both packages:
  * scan tier: decoded-bf16 cache; codes-only fused decode-then-score
    (batches of >= 256 queries); codes-only per-query LUTs (small batches);
  * beam tier: the `pq_decoded` provider, and the codes-only `pq` provider.
The memory circuit breaker is tripped by replacing its device-memory
probe (on the CPU it reports nothing and never trips); the JAX package's
fused route is forced as its own tests force it (the kernel interprets on
the CPU).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.api import config as jconfig
from opensearch_jvector_tpu.index import reader as jreader
from opensearch_jvector_tpu.index import segment as jsegment
from opensearch_jvector_tpu.index.index import VectorIndex as JIndex
from opensearch_jvector_tpu.index.scheduler import ForceMergesOnlyMergePolicy
from opensearch_jvector_tpu.utils import circuit_breaker as jbreaker
from opensearch_jvector_tpu_torch.api import config as tconfig
from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
from opensearch_jvector_tpu_torch.index import reader as treader
from opensearch_jvector_tpu_torch.index import segment as tsegment
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.store import CorruptSegmentError
from opensearch_jvector_tpu_torch.index.writer import IndexWriter
from opensearch_jvector_tpu_torch.models import builder as tbuilder
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

D, N, K = 16, 600, 10
CFG = dict(dim=D, m=8, ef_construction=32, quantization_type="pq",
           min_batch_size_for_quantization=128, num_pq_subspaces=4,
           mode="on_disk")
BIG_Q = 300  # buckets to 512 >= 256 queries: the fused rung's batches
SMALL_Q = 8


def _latent(rng, n):
    a = rng.standard_normal((8, D)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return _latent(rng, N), _latent(rng, BIG_Q)


def _cfg(pkg, index_type, simf):
    """A DiskAnnConfig of package `pkg` (jconfig or tconfig)."""
    return pkg.DiskAnnConfig(**CFG, index_type=index_type,
                             similarity=pkg.SimilarityFunction(simf.value))


def _fill(idx, vectors):
    idx.add_batch(np.arange(N), vectors)
    idx.flush()


@pytest.fixture(scope="module")
def dirs(corpus, tmp_path_factory):
    """dirs(index_type, simf) -> (JAX-written dir, port-written dir) over
    the same rows, built once per module."""
    made = {}

    def get(kind, simf=SimilarityFunction.EUCLIDEAN):
        if (kind, simf) not in made:
            tag = f"{kind}_{simf.name.lower()}"
            jroot = tmp_path_factory.mktemp(f"jax_{tag}")
            jidx = JIndex(jroot, _cfg(jconfig, kind, simf),
                          merge_policy=ForceMergesOnlyMergePolicy())
            _fill(jidx, corpus[0])
            jidx.close()
            troot = tmp_path_factory.mktemp(f"port_{tag}")
            tidx = VectorIndex(troot, _cfg(tconfig, kind, simf),
                               device="cpu")
            _fill(tidx, corpus[0])
            tidx.close()
            made[kind, simf] = (jroot, troot)
        return made[kind, simf]

    return get


@pytest.fixture
def beam_tier(monkeypatch):
    """Both packages route graph segments to the beam tier."""
    monkeypatch.setattr(jreader.SegmentReader, "SCAN_TIER_MAX_CODES", 0)
    monkeypatch.setattr(treader.SegmentReader, "SCAN_TIER_MAX_CODES", 0)


def _limit(monkeypatch, total):
    """Both breakers see a device of `total` bytes with nothing in use
    (budget: 50% of it)."""
    monkeypatch.setattr(jbreaker.BREAKER, "device_memory_bytes",
                        lambda: total)
    monkeypatch.setattr(jbreaker.BREAKER, "device_memory_in_use", lambda: 0)
    monkeypatch.setattr(BREAKER, "device_memory", lambda dev: (total, 0))


def assert_same_up_to_ties(a, b, tol=1e-5):
    """Scores agree; doc ids differ only where the score is tied; the
    counters are equal."""
    np.testing.assert_allclose(a.scores, b.scores, rtol=tol, atol=tol)
    for r in range(a.doc_ids.shape[0]):
        for j in np.nonzero(a.doc_ids[r] != b.doc_ids[r])[0]:
            tied = np.abs(a.scores[r] - a.scores[r, j]) <= tol
            tied[j] = False
            assert tied.any(), (r, j, a.doc_ids[r], b.doc_ids[r])
    assert (a.visited, a.expanded, a.reranked) == (
        b.visited, b.expanded, b.reranked)


def _open_both(root):
    jidx = JIndex(root, merge_policy=ForceMergesOnlyMergePolicy())
    tidx = VectorIndex(root, device="cpu")
    name = tidx.segment_names[0]
    # segments load while memory is fine; the breaker tightens afterwards
    return jidx, tidx, jidx._reader(name), tidx._reader(name)


def _search_both(jidx, tidx, queries):
    return (jidx.search(queries, jconfig.SearchConfig(k=K)),
            tidx.search(queries, tconfig.SearchConfig(k=K)))


def _recall(res, queries, vectors, simf=SimilarityFunction.EUCLIDEAN):
    truth = ground_truth_topk(torch.from_numpy(queries),
                              torch.from_numpy(vectors), K, simf)
    return recall_at_k(res.doc_ids, truth, K)


@pytest.mark.parametrize("kind", ["flat", "vamana"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_on_disk_index_opens_in_the_other_package(writer, kind, dirs,
                                                  corpus, beam_tier):
    root = dirs(kind)[0 if writer == "jax" else 1]
    jidx, tidx, jrd, trd = _open_both(root)
    assert trd.seg.row_store is not None and trd.seg.vectors is None
    assert trd.seg.row_store.is_native
    assert jrd.seg.row_store is not None
    jres, tres = _search_both(jidx, tidx, corpus[1][:SMALL_Q])
    assert_same_up_to_ties(jres, tres)
    assert (tres.expanded > 0) == (kind == "vamana")
    assert tres.reranked == SMALL_Q * K * 5
    assert _recall(tres, corpus[1][:SMALL_Q], corpus[0]) >= 0.8


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


@pytest.mark.parametrize("kind", ["flat", "vamana"])
def test_row_files_identical_and_integrity_crosses(kind, dirs, tmp_path):
    jroot, troot = dirs(kind)
    name = VectorIndex(troot, device="cpu").segment_names[0]
    jfiles, tfiles = _files(jroot / name), _files(troot / name)
    for f in ("rows.f32", "rows.f32.crc"):
        assert tfiles[f] == jfiles[f]
    assert tsegment.check_integrity(jroot / name)
    assert jsegment.check_integrity(troot / name)
    # rewriting a segment read from the other package reproduces its
    # containers byte for byte (the row file stays where it is)
    seg = tsegment.read_segment(jroot / name, "cpu")
    tsegment.write_segment(tmp_path / "t", seg)
    got = _files(tmp_path / "t" / name)
    assert got == {f: b for f, b in jfiles.items() if f.endswith(".jvtpu")}
    seg.row_store.close()
    # a flipped byte in the row file is caught
    bad = tmp_path / "bad"
    shutil.copytree(troot / name, bad)
    raw = bytearray((bad / "rows.f32").read_bytes())
    raw[100] ^= 0xFF
    (bad / "rows.f32").write_bytes(bytes(raw))
    with pytest.raises(CorruptSegmentError):
        tsegment.check_integrity(bad)


SIMFS = [SimilarityFunction.EUCLIDEAN, SimilarityFunction.COSINE]


@pytest.mark.parametrize("simf", SIMFS, ids=lambda f: f.name)
@pytest.mark.parametrize("rung", ["decoded", "fused", "lut"])
def test_scan_tier_rungs_match(rung, simf, dirs, corpus, monkeypatch):
    """Flat segments take the scan tier at any size: each rung of its
    ladder, in both packages."""
    jidx, tidx, jrd, trd = _open_both(dirs("flat", simf)[0])
    queries = corpus[1] if rung == "fused" else corpus[1][:SMALL_Q]
    routed = []
    real = treader.decode_scan
    monkeypatch.setattr(treader, "decode_scan",
                        lambda *a: routed.append(1) or real(*a))
    if rung == "fused":
        monkeypatch.setattr(jreader, "_fused_scan_ok", lambda q, pq: True)
        # budget 10,000 B: codes_sq (4 B/row) fits, the cache (2*d) not
        _limit(monkeypatch, 20_000)
    elif rung == "lut":
        _limit(monkeypatch, 1)
    jres, tres = _search_both(jidx, tidx, queries)
    assert_same_up_to_ties(jres, tres)
    assert (trd._pq_decoded is not None) == (rung == "decoded")
    assert (trd._codes_sq_cache is not None) == (rung == "fused")
    assert bool(routed) == (rung == "fused")
    assert _recall(tres, queries, corpus[0], simf) >= 0.8


@pytest.mark.parametrize("simf", SIMFS, ids=lambda f: f.name)
@pytest.mark.parametrize("provider", ["pq_decoded", "pq"])
def test_beam_tier_providers_match(provider, simf, dirs, corpus,
                                   monkeypatch, beam_tier):
    jidx, tidx, jrd, trd = _open_both(dirs("vamana", simf)[0])
    if provider == "pq":
        _limit(monkeypatch, 1)
    queries = corpus[1][:SMALL_Q]
    jres, tres = _search_both(jidx, tidx, queries)
    assert_same_up_to_ties(jres, tres)
    assert tres.expanded > 0
    assert (trd._pq_decoded is not None) == (provider == "pq_decoded")
    assert _recall(tres, queries, corpus[0], simf) >= 0.8


def test_fused_gate_follows_the_batch_bucket():
    assert not treader._fused_scan_ok(128)
    assert treader._fused_scan_ok(129)  # buckets to 256, as in the reference
    assert treader._fused_scan_ok(256)


def test_port_flat_flush_keeps_rows_on_the_host(corpus, tmp_path):
    """A flat on_disk flush trains on a host sample and writes the rows
    straight to the row file; the segment reopens with a row store."""
    idx = VectorIndex(tmp_path, _cfg(tconfig, "flat",
                                     SimilarityFunction.EUCLIDEAN),
                      device="cpu")
    _fill(idx, corpus[0])
    name = idx.segment_names[0]
    rows = np.fromfile(tmp_path / name / "rows.f32", np.float32)
    np.testing.assert_array_equal(rows.reshape(N, D), corpus[0])
    seg = tsegment.read_segment(tmp_path / name, "cpu")
    assert seg.vectors is None and seg.row_store.num_rows == N
    np.testing.assert_array_equal(seg.row_store.gather([5, -1, N]),
                                  np.stack([corpus[0][5], np.zeros(D),
                                            np.zeros(D)]))
    seg.row_store.close()


def test_quantized_build_flush_raises(tmp_path, monkeypatch, corpus):
    """The quantized build's flush (gate lowered to this size) charges the
    breaker its decoded-bf16 source beside the codes and the adjacency, no
    fp32 rows: one byte short of that, the flush raises and keeps its
    buffer; with it, the flush builds from the bf16 rows."""
    cfg = tconfig.DiskAnnConfig(**CFG)
    w = IndexWriter(tmp_path, cfg, device="cpu")
    w.quantized_build_min_capacity = 512
    n = 500  # capacity 512
    w.add_batch(np.arange(n), corpus[0][:n])
    est = BREAKER.estimate_segment_bytes(
        n, D, cfg.m, cfg.neighbor_overflow, cfg.num_pq_subspaces,
        keep_fp32=False) + n * D * 2
    budget = int(1e9 * GLOBAL_SETTINGS.get(
        "knn.memory.circuit_breaker.limit") / 100.0)
    in_use = [budget - est + 1]
    monkeypatch.setattr(BREAKER, "device_memory",
                        lambda dev: (int(1e9), in_use[0]))
    with pytest.raises(CircuitBreakerException):
        w.flush()
    assert w._buffered == n
    sources = []
    real = tbuilder.GraphIndexBuilder.build
    monkeypatch.setattr(tbuilder.GraphIndexBuilder, "build",
                        lambda self, v, *a, **kw: sources.append(v.dtype)
                        or real(self, v, *a, **kw))
    in_use[0] -= 1
    assert w.flush() is not None and w._buffered == 0
    assert sources == [torch.bfloat16]
