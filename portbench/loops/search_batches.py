"""Closed loop of one caller sending query batches to `VectorIndex.search`.

Set-up makes the configuration's corpus and queries from the seed, builds
the index through the facade (`add_batch` + `flush`, merges only when
forced) and searches `warm_calls` batches of the window's own shape. The
window then sends batches of `batch` queries, taken in turn from the
query set and wrapping round (so every batch has the same shape), one
after another until `--seconds` have passed, and closes when the last
returns. Every answer is kept for the judge.

Traffic keys: `batch`, `warm_calls`, `trace_start_s`, `trace_calls`.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import Outcome
from portbench.judge import Answers
from portbench.window import Window


def kernel_launches() -> dict:
    """The port's own launch counters of its hand-written kernels."""
    from opensearch_jvector_tpu_torch.ops import (
        adc_kernel,
        beam_kernel,
        pq_scan_kernel,
        prune_kernel,
    )

    return {"adc_scan": adc_kernel.adc_scan.launches,
            "decode_scan": pq_scan_kernel.decode_scan.launches,
            "beam_search": beam_kernel.beam_search.launches,
            "robust_prune": prune_kernel.robust_prune.launches}


def run(ctx) -> Outcome:
    cfg, tr = ctx.config, ctx.traffic
    data = ctx.data()
    rows = data.rows(int(cfg["rows"]))
    queries = data.queries(int(cfg["queries"]))
    del data
    ctx.reset_peak()
    index = ctx.build_index(ctx.tmp / "index", rows)
    sc = ctx.search_config()
    b, nq = int(tr["batch"]), queries.shape[0]

    def batch(i: int) -> tuple[int, np.ndarray]:
        lo = (i * b) % nq
        return lo, np.take(queries, np.arange(lo, lo + b) % nq, axis=0)

    for i in range(int(tr["warm_calls"])):
        index.search(batch(i)[1], sc)
    ctx.begin_window()
    launches0 = kernel_launches()
    win = Window(ctx.seconds)
    tracer = ctx.tracer
    starts, ids, scores = [], [], []
    visited = expanded = 0
    traced = {"visited": 0, "expanded": 0, "queries": 0, "batches": 0}
    i = 0
    win.open()
    while ctx.more(win):
        lo, qb = batch(i)
        active = tracer.before_call(win.elapsed()) if tracer else False
        t0 = time.perf_counter()
        with ctx.span("portbench.search"):
            res = index.search(qb, sc)
        t1 = time.perf_counter()
        if tracer:
            tracer.after_call()
        win.record(t0, t1)
        starts.append(lo)
        ids.append(res.doc_ids)
        scores.append(res.scores)
        visited += res.visited
        expanded += res.expanded
        if active:
            traced["visited"] += res.visited
            traced["expanded"] += res.expanded
            traced["queries"] += b
            traced["batches"] += 1
        i += 1
    ctx.end_window()
    made = {k: v - launches0[k] for k, v in kernel_launches().items()}
    ctx.log(f"kernel launches in the window: {made}")
    peak = ctx.memory_peak()
    index.close()
    del index
    qidx = (np.asarray(starts, np.int64)[:, None]
            + np.arange(b, dtype=np.int64)[None, :]).reshape(-1) % nq
    answers = Answers(qidx, np.concatenate(ids).astype(np.int64),
                      np.concatenate(scores).astype(np.float32))
    lat = win.latencies()
    ctx.log(f"calls {len(lat)}, latency median "
            f"{1e3 * float(np.median(lat)):.6f} ms")
    return Outcome(
        calls=win.calls, window_s=win.window_s, units=i * b,
        unit="queries", answers=answers, rows=rows, queries=queries,
        attempted=i, failed=0, memory_peak=peak,
        counters={"visited": visited, "expanded": expanded,
                  "queries": i * b, "batches": i, "launches": made},
        trace_counters=traced)
