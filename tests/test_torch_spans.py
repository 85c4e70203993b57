"""The port's span helper (`utils/profiling.phase`), the spans of the
search call and the flush, the build's work counters and the time
counters' sub-millisecond carry.

A span is a profiler range only while a profiler records: the search and
the flush of a small `VectorIndex` under `torch.profiler.profile` export
every named step (beam and scan tier alike), while without a profiler
`phase` opens no `record_function` at all. `BuildCounters.rows_scored` and
`expanded` are the insert walks' own counts, and a flush adds its build's
totals to the `knn_graph_build_*` counters. Time-valued counters carry
what a block adds below a millisecond.
"""

import json
import types

import numpy as np
import pytest
import torch

from opensearch_jvector_tpu_torch.api import stats as stats_mod
from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig, SearchConfig
from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
from opensearch_jvector_tpu_torch.api.stats import Counter, StatsRegistry
from opensearch_jvector_tpu_torch.index import writer as writer_mod
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.scheduler import (
    ForceMergesOnlyMergePolicy,
)
from opensearch_jvector_tpu_torch.models import builder as builder_mod
from opensearch_jvector_tpu_torch.models import searcher as searcher_mod
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.utils import profiling
from opensearch_jvector_tpu_torch.utils.profiling import phase

torch.set_num_threads(2)

D, PER_FLUSH, FLUSHES, Q, K = 16, 600, 2, 24, 10
CFG = dict(dim=D, m=12, ef_construction=48, num_pq_subspaces=8,
           min_batch_size_for_quantization=256)
SETTING = "index.knn.advanced.scan_tier_max_codes"
SEARCH_SPANS = {"index.search", "index.merge_topk", "reader.upload",
                "reader.accept", "reader.launch", "reader.to_host",
                "reader.docmap", "query"}
FLUSH_SPANS = {"flush", "writer.upload", "writer.quantize",
               "writer.pq_train", "writer.pq_encode", "writer.build",
               "writer.write", "builder.entry", "builder.bootstrap",
               "builder.search", "builder.prune+fwd", "builder.sel_fetch",
               "builder.backedges_host", "builder.apply", "builder.overflow",
               "builder.cleanup", "builder.cleanup_fetch",
               "builder.cleanup_splice", "builder.cleanup_overflow",
               "builder.cleanup_orphans"}


def _latent(rng, n):
    a = rng.standard_normal((8, D)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


def _index(root, stats=None):
    kw = {} if stats is None else {"stats": stats}
    idx = VectorIndex(root, DiskAnnConfig(**CFG), device="cpu",
                      merge_policy=ForceMergesOnlyMergePolicy(), **kw)
    # a bootstrap block of 128 rows, then insert rounds
    idx.writer.build_batch_size = 128
    return idx


def _ranges(path) -> list[tuple[float, float, str]]:
    doc = json.loads(path.read_text())
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(ranges, inner: str, outer: str) -> bool:
    """Every range named `inner` lies within one named `outer`."""
    outs = [(a, b) for a, b, n in ranges if n == outer]
    return all(any(lo <= a and b <= hi for lo, hi in outs)
               for a, b, n in ranges if n == inner)


@pytest.fixture
def scan_bound():
    def put(bound):
        GLOBAL_SETTINGS.put(SETTING, bound)
    yield put
    GLOBAL_SETTINGS.put(SETTING, -1)


@pytest.mark.parametrize("tier", ["beam", "scan"])
def test_search_and_flush_spans_in_an_exported_trace(tier, tmp_path,
                                                     scan_bound):
    scan_bound(0 if tier == "beam" else -1)
    rng = np.random.default_rng(1)
    rows, queries = _latent(rng, PER_FLUSH * FLUSHES), _latent(rng, Q)
    idx = _index(tmp_path / "idx")
    path = tmp_path / "trace.json"
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for f in range(FLUSHES):
            lo = f * PER_FLUSH
            idx.add_batch(np.arange(lo, lo + PER_FLUSH),
                          rows[lo: lo + PER_FLUSH])
            idx.flush()
        res = idx.search(queries, SearchConfig(k=K))
    prof.export_chrome_trace(str(path))
    idx.close()
    assert (res.doc_ids >= 0).all()
    ranges = _ranges(path)
    names = {n for _, _, n in ranges}
    assert SEARCH_SPANS | FLUSH_SPANS <= names, (
        (SEARCH_SPANS | FLUSH_SPANS) - names)
    count = {n: sum(1 for *_, m in ranges if m == n) for n in names}
    # one wait, one upload and one `query` a segment; one merge a search
    assert count["reader.to_host"] == count["reader.upload"] == FLUSHES
    assert count["query"] == FLUSHES and count["index.search"] == 1
    assert count["flush"] == count["writer.build"] == FLUSHES
    for inner, outer in [("reader.launch", "query"),
                         ("reader.to_host", "query"),
                         ("query", "index.search"),
                         ("reader.upload", "index.search"),
                         ("reader.docmap", "index.search"),
                         ("index.merge_topk", "index.search"),
                         ("writer.pq_train", "flush"),
                         ("writer.build", "flush"),
                         ("writer.write", "flush"),
                         ("builder.search", "writer.build"),
                         ("builder.backedges_host", "writer.build"),
                         ("builder.cleanup_orphans", "builder.cleanup")]:
        assert _inside(ranges, inner, outer), (inner, outer)


def test_phase_opens_no_range_without_a_profiler(monkeypatch, tmp_path):
    opened = []
    original = torch.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return original(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    got = []
    for _ in range(5):
        with phase("unit", add_seconds=got.append):
            pass
    rng = np.random.default_rng(2)
    idx = _index(tmp_path / "idx")
    idx.add_batch(np.arange(PER_FLUSH), _latent(rng, PER_FLUSH))
    idx.flush()
    idx.search(_latent(rng, Q), SearchConfig(k=K))
    idx.close()
    assert opened == [] and len(got) == 5
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with phase("unit", add_seconds=got.append):
            pass
    assert opened == ["unit"] and len(got) == 6


def test_phase_feeds_its_counter_when_the_block_raises():
    reg = StatsRegistry()
    got = []
    with pytest.raises(ValueError):
        with phase("unit", Counter.KNN_GRAPH_BUILD_TIME, reg, got.append):
            raise ValueError("inside")
    assert len(got) == 1 and got[0] >= 0.0


def _walk_spy(monkeypatch):
    """Each walk the builder makes, made again on the same inputs: the
    second run's counts, summed."""
    totals = {"visited": 0, "expanded": 0, "walks": 0}
    original = searcher_mod.search

    def spy(*a, **kw):
        res = original(*a, **kw)
        again = original(*a, **kw)
        assert torch.equal(res.ids, again.ids)
        totals["visited"] += int(again.visited_count.sum())
        totals["expanded"] += int(again.expanded_count.sum())
        totals["walks"] += 1
        return res

    monkeypatch.setattr(searcher_mod, "search", spy)
    return totals


def test_build_counters_are_the_insert_walks_counts(monkeypatch):
    rng = np.random.default_rng(3)
    n, add = 1500, 300
    rows = torch.from_numpy(_latent(rng, n + add))
    simf = SimilarityFunction.EUCLIDEAN
    totals = _walk_spy(monkeypatch)
    b = builder_mod.GraphIndexBuilder(dim=D, max_degree=12, beam_width=32,
                                      batch_size=256)
    g = b.build(rows[:n], simf, capacity=2048)
    assert totals["walks"] == b.counters.rounds > 0
    assert (b.counters.rows_scored, b.counters.expanded) == (
        totals["visited"], totals["expanded"])
    assert b.counters.rows_scored > b.counters.expanded > 0
    b.add_nodes(g, rows, np.arange(n, n + add), simf)
    assert totals["walks"] == b.counters.rounds
    assert (b.counters.rows_scored, b.counters.expanded) == (
        totals["visited"], totals["expanded"])


def test_a_flush_adds_its_build_to_the_stats(monkeypatch, tmp_path):
    builders = []

    class Recording(writer_mod.GraphIndexBuilder):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            builders.append(self)

    monkeypatch.setattr(writer_mod, "GraphIndexBuilder", Recording)
    reg = StatsRegistry()
    rng = np.random.default_rng(4)
    idx = _index(tmp_path / "idx", stats=reg)
    idx.add_batch(np.arange(PER_FLUSH), _latent(rng, PER_FLUSH))
    before = reg.snapshot()
    idx.flush()
    after = reg.snapshot()
    idx.close()
    (b,) = builders
    gain = {k: after[k] - before[k] for k in after}
    assert gain["knn_graph_build_nodes"] == PER_FLUSH
    assert gain["knn_graph_build_rows_scored"] == b.counters.rows_scored > 0
    assert gain["knn_graph_build_expanded_nodes"] == b.counters.expanded > 0


class _FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("via", ["timed", "phase", "add_seconds"])
def test_time_counters_keep_what_blocks_add_below_a_millisecond(
        via, monkeypatch):
    clock = _FakeClock()
    fake = types.SimpleNamespace(monotonic=clock, perf_counter=clock)
    monkeypatch.setattr(stats_mod, "time", fake)
    monkeypatch.setattr(profiling, "time", fake)
    reg = StatsRegistry()
    c = Counter.KNN_GRAPH_SEARCH_TIME
    for _ in range(1000):
        if via == "add_seconds":
            reg.add_seconds(c, 0.0004)
            continue
        block = (reg.timed(c) if via == "timed"
                 else phase("unit", c, reg))
        with block:
            clock.t += 0.0004
    assert reg.get(c) == 400
    snap = reg.snapshot()
    assert snap[c.value] == 400 and isinstance(snap[c.value], int)
    reg.reset()
    reg.add_seconds(c, 0.0009)
    assert reg.get(c) == 0
    reg.add_seconds(c, 0.0002)
    assert reg.get(c) == 1
