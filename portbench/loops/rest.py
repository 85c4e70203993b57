"""An open loop of REST requests against the port's HTTP service, started
in this process.

Set-up builds the configuration's index through the facade under
`<root>/<index>/<field>`, closes it, starts `KnnService` over `<root>` on
the run's device (its micro-batcher at its defaults) and attaches the
index with `PUT /<index>`. The client runs in one other process
(`rest_client.py`, standard library only), so its Python never takes the
server's interpreter lock. It offers single-vector `_search` requests (k
and `ef_search` as the configuration sets them) at a fixed `rate`, as
independent users do, over a pool of `pool` keep-alive connections:
`warm_s` of warm-up, then the window. A request's latency runs from when
it was due to the last byte of its answer, on the client's clock. Every
answer is judged.

Traffic keys: `rate`, `pool`, `warm_s`, `index`, `field`,
`trace_start_s`, `trace_warm_s`, `trace_active_s`.
"""

from __future__ import annotations

import http.client
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from portbench.harness import Outcome
from portbench.judge import Answers

CLIENT = Path(__file__).resolve().parent / "rest_client.py"


def _call(port: int, method: str, path: str, body: dict | None = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        raw = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, raw,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
    finally:
        conn.close()
    if r.status != 200:
        raise RuntimeError(f"{method} {path}: HTTP {r.status} {data[:300]!r}")
    return json.loads(data)


def start_service(ctx, rows: np.ndarray, queries: np.ndarray):
    """The service over the configuration's index, and the request bodies
    written for the client -> (service, bodies path)."""
    from opensearch_jvector_tpu_torch.service.http import KnnService

    cfg, tr = ctx.config, ctx.traffic
    name, field = tr["index"], tr["field"]
    root = ctx.tmp / "service"
    ctx.build_index(root / name / field, rows).close()
    svc = KnnService(root, device=ctx.device)
    svc.start()
    try:
        _call(svc.port, "PUT", f"/{name}", {"mappings": {"properties": {
            field: {"type": "knn_vector", "dimension": rows.shape[1]}}}})
        search = cfg["search"]
        params = {k: search[k] for k in ("ef_search", "overquery_factor")
                  if search.get(k)}
        bodies = ctx.tmp / "bodies.jsonl"
        with open(bodies, "w") as f:
            for q in queries:
                f.write(json.dumps({"size": search["k"], "query": {"knn": {
                    field: {"vector": [float(x) for x in q],
                            "k": search["k"],
                            "method_parameters": params}}}}) + "\n")
    except BaseException:
        svc.stop()
        svc.manager.close()
        raise
    return svc, bodies


def offer(ctx, svc, bodies: Path, count: int, rate: float, seconds: float,
          on_ready=None, while_open=None) -> dict:
    """Run the client at `rate` for a warm-up and a window of `seconds`
    -> its log. `on_ready()` runs between the two, `while_open()` in the
    window."""
    tr = ctx.traffic
    out = ctx.tmp / "requests.json"
    client = subprocess.Popen(
        [sys.executable, str(CLIENT), "--port", str(svc.port),
         "--index", tr["index"], "--bodies", str(bodies),
         "--count", str(count), "--rate", str(rate),
         "--pool", str(tr["pool"]), "--warm", str(tr["warm_s"]),
         "--seconds", str(seconds), "--out", str(out)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        if client.stdout.readline().strip() != "ready":
            raise RuntimeError("the REST client did not warm up")
        if on_ready is not None:
            on_ready()
        client.stdin.write("go\n")
        client.stdin.flush()
        if while_open is not None:
            while_open()
        rc = client.wait(timeout=seconds + 300)
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
    if rc != 0:
        raise RuntimeError(f"the REST client exited with {rc}")
    with open(out) as f:
        return json.load(f)


def run(ctx) -> Outcome:
    cfg, tr = ctx.config, ctx.traffic
    data = ctx.data()
    rows = data.rows(int(cfg["rows"]))
    queries = data.queries(int(cfg["queries"]))
    del data
    ctx.reset_peak()
    svc, bodies = start_service(ctx, rows, queries)
    mgr = svc.manager
    stages0 = {}

    def on_ready():
        stages0.update(mgr.stage_seconds)
        ctx.begin_window()

    def while_open():
        if ctx.tracer is not None:
            time.sleep(float(tr["trace_start_s"]))
            ctx.tracer.timed(float(tr["trace_warm_s"]),
                             float(tr["trace_active_s"]))

    try:
        log = offer(ctx, svc, bodies, queries.shape[0], float(tr["rate"]),
                    ctx.seconds, on_ready, while_open)
        ctx.end_window()
        execute_s = mgr.stage_seconds["execute"] - stages0["execute"]
        peak = ctx.memory_peak()
    finally:
        svc.stop()
        svc.manager.close()
    reqs = log["requests"]
    k = int(cfg["search"]["k"])
    ok = [r for r in reqs if r["status"] == 200]
    ids = np.full((len(ok), k), -1, np.int64)
    scores = np.full((len(ok), k), -np.inf, np.float32)
    dispatch = []
    for j, r in enumerate(ok):
        body = json.loads(r["body"])
        hits = body["hits"]["hits"][:k]
        ids[j, : len(hits)] = [h["_id"] for h in hits]
        scores[j, : len(hits)] = [h["_score"] for h in hits]
        dispatch.append(body["profile"]["dispatch_rows"])
    calls = [(r["due"], r["end"]) for r in reqs]
    lat = [end - due for due, end in calls]
    late = [r["sent"] - r["due"] for r in reqs]
    ctx.log(f"requests {len(reqs)} ({len(reqs) - len(ok)} failed) at "
            f"{tr['rate']}/s, latency median {1e3 * float(np.median(lat)):.6f}"
            f" ms, sent late by {1e3 * float(np.mean(late)):.6f} ms on "
            f"average and {1e3 * max(late):.6f} ms at most, reconnects "
            f"{log['reconnects']}")
    return Outcome(
        calls=calls, window_s=max(end for _, end in calls),
        units=len(ok), unit="queries",
        answers=Answers(np.array([r["q"] for r in ok], np.int64), ids,
                        scores),
        rows=rows, queries=queries, attempted=len(reqs),
        failed=len(reqs) - len(ok), memory_peak=peak,
        counters={"requests": len(reqs), "dispatch_rows": dispatch,
                  "execute_s": execute_s})
