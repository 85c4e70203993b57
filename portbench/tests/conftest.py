"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with the
same cells at a size a test can hold."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

# configuration -> (rows, queries, dim, latent) of the small copy
SMALL_CONFIGS = {"sift1m-inmem": (4000, 300, 16, 4),
                 "gist500k-ondisk": (3000, 100, 32, 4)}
SMALL_TRAFFIC = {
    "batch512": {"batch": 64, "warm_calls": 1, "trace_start_s": 0.1,
                 "trace_calls": 2},
    "batch500": {"batch": 50, "warm_calls": 1, "trace_start_s": 0.1},
    "ingest300k": {"rows_per_flush": 2000, "pool_flushes": 3,
                   "search_batch": 100, "trace_start_s": 0.0},
    "rest200": {"pool": 8, "warm_s": 0.3, "trace_start_s": 0.1},
}
# The REST cell is not in BENCHMARK.json (PERF.md, Open questions: its
# tail spreads past any bound on the card); its loop, mix and metrics
# are kept for it, and the small copy adds it as a later change would.
REST_CELL = "sift1m-inmem.rest200"
REST_METRICS = [("service.dispatch_rows", "rows/dispatch", "higher",
                 "program_counter", "REST service"),
                ("service.execute_ms", "ms/request", "lower",
                 "program_span", "REST service"),
                ("idle_share.serve", "%", "lower", "device_trace", "device")]


def add_rest_cell(root: Path) -> None:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": REST_CELL, "config": "sift1m-inmem",
                              "traffic": "rest200", "chips": 1,
                              "why": "open loop of single-vector _search"})
    for m in spec["end_to_end"]:
        if m["name"] == "latency_p95_ms":
            m["workloads"].append(REST_CELL)
    for name, unit, better, source, layer in REST_METRICS:
        spec["per_layer"].append({
            "name": name, "unit": unit, "better": better, "source": source,
            "layer": layer, "moves": "latency_p95_ms",
            "workloads": [REST_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def copy_benchmark(dest: Path) -> Path:
    """BENCHMARK.json and the benchmark's folder, copied under `dest`."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


@pytest.fixture
def small_root(tmp_path) -> Path:
    """A copy whose configurations and mixes are cut to a test's size;
    limits, search settings and everything else as committed."""
    root = copy_benchmark(tmp_path)
    for name, (rows, queries, dim, latent) in SMALL_CONFIGS.items():
        p = root / "portbench" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c.update(rows=rows, queries=queries, dim=dim, flush_rows=rows)
        c["data"]["latent"] = latent
        c["index"].update(dim=dim, num_pq_subspaces=8)
        if c["search"]["ef_search"]:
            c["search"]["ef_search"] = 64
        p.write_text(json.dumps(c))
    for name, upd in SMALL_TRAFFIC.items():
        p = root / "portbench" / "traffic" / f"{name}.json"
        t = json.loads(p.read_text())
        t.update(upd)
        p.write_text(json.dumps(t))
    add_rest_cell(root)
    return root
