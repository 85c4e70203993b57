"""Bulk ingest from an empty index: `add_batch` + `flush` of fresh rows.

Set-up draws a pool of `pool_flushes` x `rows_per_flush` rows from the
configuration's generator (the first rows are its corpus, the rest fresh
draws of the same generator) and warms the path with one flush of the same
size into a scratch index, which it then drops. The window starts from an
empty index (merges only when forced, so a flush's cost does not depend
on what is already there) and adds and flushes one segment of
`rows_per_flush` rows at a time until `--seconds` have passed. After the
window, outside it, the configuration's queries are searched over every
segment the window flushed, in batches of `search_batch`, and those
answers are judged against the exact top k of the rows flushed.

Traffic keys: `rows_per_flush`, `pool_flushes`, `search_batch`,
`trace_start_s` (a traced run traces one flush: `trace_calls` 1).
"""

from __future__ import annotations

import shutil
import time

import numpy as np

from portbench.harness import Outcome
from portbench.judge import Answers
from portbench.window import Window


class _Recorder:
    """Keeps every graph builder a flush makes, to read its counters."""

    def __init__(self):
        from opensearch_jvector_tpu_torch.index import writer

        self.writer = writer
        self.original = writer.GraphIndexBuilder
        self.builders = []
        rec = self

        class Recording(self.original):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                rec.builders.append(self)

        writer.GraphIndexBuilder = Recording

    def close(self) -> None:
        self.writer.GraphIndexBuilder = self.original


def run(ctx) -> Outcome:
    from opensearch_jvector_tpu_torch.api.stats import STATS, Counter

    cfg, tr = ctx.config, ctx.traffic
    per, pool_n = int(tr["rows_per_flush"]), int(tr["pool_flushes"])
    data = ctx.data()
    pool = data.rows(per * pool_n)
    queries = data.queries(int(cfg["queries"]))
    del data
    ctx.reset_peak()
    warm = ctx.open_index(ctx.tmp / "warm")
    warm.add_batch(np.arange(per, dtype=np.int64), pool[:per])
    warm.flush()
    warm.close()
    del warm
    shutil.rmtree(ctx.tmp / "warm")
    index = ctx.open_index(ctx.tmp / "index")
    recorder = _Recorder() if ctx.trace else None
    ctx.begin_window()
    train0 = STATS.get(Counter.KNN_QUANTIZATION_TRAINING_TIME)
    tracer = ctx.tracer
    traced = {"flushes": 0}
    win = Window(ctx.seconds)
    f = 0
    win.open()
    while ctx.more(win) and f < pool_n:
        lo, hi = f * per, (f + 1) * per
        active = tracer.before_call(win.elapsed()) if tracer else False
        t0 = time.perf_counter()
        with ctx.span("portbench.add_batch"):
            index.add_batch(np.arange(lo, hi, dtype=np.int64), pool[lo:hi])
        with ctx.span("portbench.flush"):
            index.flush()
        t1 = time.perf_counter()
        if tracer:
            tracer.after_call()
        win.record(t0, t1)
        traced["flushes"] += int(active)
        f += 1
    ctx.end_window()
    if f == pool_n and win.more():
        ctx.log(f"the pool of {pool_n} flushes ran out before the window's "
                f"end")
    train_ms = STATS.get(Counter.KNN_QUANTIZATION_TRAINING_TIME) - train0
    phase_s: dict[str, float] = {}
    if recorder is not None:
        recorder.close()
        for b in recorder.builders:
            for k, v in b.counters.phase_s.items():
                phase_s[k] = phase_s.get(k, 0.0) + v
    # the judged answers: the query set over every segment flushed
    sc = ctx.search_config()
    sb, nq = int(tr["search_batch"]), queries.shape[0]
    ids, scores = [], []
    for lo in range(0, nq, sb):
        res = index.search(queries[lo: lo + sb], sc)
        ids.append(res.doc_ids)
        scores.append(res.scores)
    peak = ctx.memory_peak()
    index.close()
    del index
    answers = Answers(np.arange(nq, dtype=np.int64),
                      np.concatenate(ids).astype(np.int64),
                      np.concatenate(scores).astype(np.float32))
    lat = win.latencies()
    ctx.log(f"flushes {f}, flush seconds median "
            f"{float(np.median(lat)):.6f}")
    return Outcome(
        calls=win.calls, window_s=win.window_s, units=f * per,
        unit="rows", answers=answers, rows=pool[: f * per],
        queries=queries, attempted=f, failed=0, memory_peak=peak,
        counters={"flushes": f, "pq_train_ms": train_ms,
                  "phase_s": phase_s},
        trace_counters=traced)
