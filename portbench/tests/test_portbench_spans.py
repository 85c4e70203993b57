"""The metrics that read the program's own spans and build counters
(`portbench/spans.py`, `index.*`, `builder.idle_s`,
`builder.rows_scored_per_node`): their arithmetic on a synthetic trace,
nothing to read where the program opens no such range or the trace kept
no device event, and the four-segment cell run small on the CPU with its
spans read from the profiler's real trace."""

import json

import pytest

from portbench import harness, spans
from portbench import trace as trace_mod
from portbench.trace import Trace

SEED = 2**31 + 77
CELL_4SEG = "sift1m-inmem-4seg.batch512"


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1}


def _trace(with_device=True, with_spans=True) -> Trace:
    ev = [_ev("user_annotation", "portbench.active", 0, 1000),
          _ev("user_annotation", "portbench.search", 10, 480),
          _ev("user_annotation", "portbench.search", 500, 480)]
    if with_spans:
        ev += [_ev("user_annotation", "index.search", 20, 460),
               _ev("user_annotation", "reader.to_host", 100, 200),
               _ev("user_annotation", "index.search", 510, 460),
               _ev("user_annotation", "reader.to_host", 600, 300),
               # before the window: not read
               _ev("user_annotation", "reader.to_host", -50, 10)]
    if with_device:
        ev += [_ev("kernel", "k", 50, 200, tid=7),
               _ev("kernel", "k", 550, 400, tid=7)]
    return Trace({"traceEvents": ev})


class _Rec:
    def __init__(self, t, batches=2):
        self.trace = t
        self.trace_counters = {"batches": batches}


def _metric(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py")


def test_span_arithmetic_on_a_synthetic_trace():
    t = _trace()
    assert spans.ranges(t, "reader.to_host") == [(100, 300), (600, 900)]
    # 460 + 460 us in the searches, less 200 + 300 us of waits
    assert spans.host_seconds(t, "index.search", "reader.to_host") == (
        pytest.approx(420e-6))
    # idle [0, 50) [250, 550) [950, 1000); inside the searches
    # [20, 50) + [250, 480) + [510, 550) + [950, 970)
    assert spans.idle_seconds(t, "index.search") == pytest.approx(320e-6)
    rec = _Rec(t)
    assert _metric("index.waits_per_batch").read(rec) == 1.0
    assert _metric("index.search_host_ms").read(rec) == pytest.approx(0.21)
    assert _metric("index.search_idle_ms").read(rec) == pytest.approx(0.16)


@pytest.mark.parametrize("what", ["no spans", "no device event", "no trace"])
def test_nothing_to_read(what):
    t = {"no spans": _trace(with_spans=False),
         "no device event": _trace(with_device=False),
         "no trace": None}[what]
    rec = _Rec(t)
    for name in ("index.waits_per_batch", "index.search_host_ms",
                 "index.search_idle_ms"):
        assert _metric(name).read(rec) is None
    rec.trace_counters = {"flushes": 1}
    assert _metric("builder.idle_s").read(rec) is None


def _cut_4seg(root):
    p = root / "portbench" / "configs" / "sift1m-inmem-4seg.json"
    c = json.loads(p.read_text())
    c.update(rows=4000, queries=300, dim=16, flush_rows=1000)
    c["data"]["latent"] = 4
    c["index"].update(dim=16, num_pq_subspaces=8)
    c["search"]["ef_search"] = 64
    p.write_text(json.dumps(c))


@pytest.fixture
def device_kept(monkeypatch):
    """Each trace taken on the CPU gains one device event over its window,
    as a trace of the card would have, so the span metrics read it."""
    load = Trace.load

    def with_device(path):
        t = load(path)
        t.device.append((t.lo, t.lo + 1.0, "k", None))
        return t

    monkeypatch.setattr(trace_mod.Trace, "load", staticmethod(with_device))


@pytest.mark.parametrize("cell,waits", [(CELL_4SEG, 4.0),
                                        ("sift1m-inmem.batch512", 1.0)])
def test_traced_search_cells_read_the_spans(small_root, device_kept, cell,
                                            waits):
    _cut_4seg(small_root)
    result = harness.run(small_root, cell, SEED, 0.5, True, "cpu")
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["index.waits_per_batch"] == waits
    assert m["index.search_host_ms"] > 0.0
    assert m["index.search_idle_ms"] > 0.0
    idle = dict(result["breakdown"]["idle_gaps"])
    assert "portbench.search" not in idle


def test_the_four_segment_cell_runs_correct(small_root):
    _cut_4seg(small_root)
    result = harness.run(small_root, CELL_4SEG, SEED, 0.5, False, "cpu")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"qps", "latency_p95_ms",
                                      "recall_at_10", "setup_s"}


def test_traced_ingest_reads_the_build_spans_and_counters(small_root,
                                                          device_kept):
    result = harness.run(small_root, "sift1m-inmem.ingest300k", SEED, 0.5,
                         True, "cpu")
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["builder.idle_s"] > 0.0
    # every inserted node outside the bootstrap block scores rows
    assert m["builder.rows_scored_per_node"] > 1.0
