"""Runs one cell of BENCHMARK.json once and builds its result line.

Everything is found by name: the cell in BENCHMARK.json names its
configuration (`configs[].file`) and its traffic mix
(`<bench>/traffic/<mix>.json`); the mix names its loop
(`<bench>/loops/<loop>.py`); the configuration names its reference
(`<bench>/reference/<reference>.py`); each metric is read by
`<bench>/metrics/<metric>.py`. Adding a configuration, a mix, a metric or a
cell adds files and entries and edits none.

A loop's `run(ctx)` makes the data from the seed, sets the program up,
warms it, calls `ctx.begin_window()`, runs the window, reads the peak
memory, frees the program's state and returns an `Outcome`. The harness
then judges the answers against the reference and reads the metrics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import judge as judge_mod
from portbench.imports import forbidden_loaded

BENCH_DIR = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- finding things by name ---------------------------------------------------

def load_spec(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import the Python file `path` under a name of its own."""
    name = "portbench_" + "_".join(
        "".join(c if c.isalnum() else "_" for c in part)
        for part in path.parts[-2:])
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell with everything it names, found from `root`."""

    root: Path
    spec: dict
    entry: dict
    config: dict
    traffic: dict

    @staticmethod
    def find(root: Path, name: str) -> "Cell":
        root = Path(root)
        spec = load_spec(root)
        entry = _named(spec["workloads"], name, "workload")
        cfg_entry = _named(spec["configs"], entry["config"], "config")
        config = _load_json(root / cfg_entry["file"])
        traffic = _load_json(bench_dir(root) / "traffic"
                             / f"{entry['traffic']}.json")
        return Cell(root, spec, entry, config, traffic)

    @property
    def name(self) -> str:
        return self.entry["name"]

    def metrics(self, kind: str) -> list[dict]:
        """The `end_to_end` or `per_layer` metrics this cell reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def module(self, kind: str, name: str):
        return load_module(bench_dir(self.root) / kind / f"{name}.py")


def bench_dir(root: Path) -> Path:
    return Path(root) / BENCH_DIR.name


# -- what a loop sees ---------------------------------------------------------

@dataclasses.dataclass
class Outcome:
    """What a loop hands back after the window."""

    calls: list                     # [(start, end)] on one clock
    window_s: float
    units: int                      # queries answered or rows ingested
    unit: str                       # "queries" | "rows"
    answers: judge_mod.Answers
    rows: np.ndarray                # what the reference searches
    queries: np.ndarray
    attempted: int
    failed: int
    memory_peak: int
    counters: dict = dataclasses.field(default_factory=dict)
    trace_counters: dict = dataclasses.field(default_factory=dict)


class Context:
    """One run of one cell: its files, seed, device and scratch space."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, tmp: Path, t_start: float):
        import torch

        from portbench.trace import Tracer

        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.tmp = Path(tmp)
        self.t_start = t_start
        self.setup_s: float | None = None
        self.log = log
        self.tracer = (Tracer(self.tmp, self.traffic["trace_start_s"],
                              self.traffic.get("trace_calls", 1), log)
                       if trace else None)

    # set-up helpers shared by the loops
    def data(self):
        from portbench.data import LatentData

        return LatentData(dict(self.config["data"], dim=self.config["dim"]),
                          self.seed, self.device)

    def index_config(self):
        from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig
        from opensearch_jvector_tpu_torch.ops.distances import (
            SimilarityFunction,
        )

        fields = dict(self.config["index"])
        fields["similarity"] = SimilarityFunction[
            fields["similarity"].upper()]
        return DiskAnnConfig(**fields)

    def search_config(self):
        from opensearch_jvector_tpu_torch.api.config import SearchConfig

        return SearchConfig(**self.config["search"])

    def open_index(self, path: Path):
        """A new, empty index at `path` whose merges run only when forced."""
        from opensearch_jvector_tpu_torch.index.index import VectorIndex
        from opensearch_jvector_tpu_torch.index.scheduler import (
            ForceMergesOnlyMergePolicy,
        )

        return VectorIndex(path, self.index_config(), device=self.device,
                           merge_policy=ForceMergesOnlyMergePolicy())

    def build_index(self, path: Path, rows: np.ndarray):
        """The configuration's index over `rows`: doc id = row number,
        flushed in segments of `flush_rows`."""
        index = self.open_index(path)
        step = int(self.config["flush_rows"])
        for lo in range(0, rows.shape[0], step):
            hi = min(rows.shape[0], lo + step)
            index.add_batch(np.arange(lo, hi, dtype=np.int64), rows[lo:hi])
            index.flush()
        return index

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def memory_peak(self) -> int:
        import torch

        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def span(self, name: str):
        """A host range around a call into the program, in traced runs."""
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def begin_window(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        log(f"set-up {self.setup_s:.3f} s")

    def more(self, win) -> bool:
        """Whether the window's loop starts another call: while the window
        is open, and in a traced run until the trace is taken."""
        return win.more() or (self.tracer is not None
                              and self.tracer.pending)

    def end_window(self) -> None:
        """After the window's last call: finish the trace."""
        if self.tracer is not None:
            self.tracer.close()


# -- reading the metrics ------------------------------------------------------

@dataclasses.dataclass
class Record:
    """What a metric reader reads."""

    cell: Cell
    outcome: Outcome
    setup_s: float
    recall: float | None
    trace: object  # portbench.trace.Trace or None

    @property
    def counters(self) -> dict:
        return self.outcome.counters

    @property
    def trace_counters(self) -> dict:
        return self.outcome.trace_counters


def read_metrics(cell: Cell, kind: str, rec: Record) -> dict:
    out = {}
    for m in cell.metrics(kind):
        value = cell.module("metrics", m["name"]).read(rec)
        if value is None:
            log(f"metric {m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


# -- one run ------------------------------------------------------------------

def run(root: Path, name: str, seed: int, seconds: float, trace: bool,
        device, t_start: float | None = None) -> dict:
    """Run cell `name` once -> the result line's object (`correct`,
    `attempted`, `failed`, `metrics`, `device`, optional `breakdown`, and
    `checks` last). Prints each check on standard error as the last lines."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell.find(root, name)
    if trace:
        # read by the port's builder when it is imported; syncs the device
        # at every build phase, so only in traced runs
        os.environ["JVECTOR_TPU_BUILD_PROFILE"] = "1"
        os.environ["TEARDOWN_CUPTI"] = "0"
    import torch

    dev = torch.device(device)
    loop = cell.module("loops", cell.traffic["loop"])
    reference = cell.module("reference", cell.config["reference"])
    tmp = Path(tempfile.mkdtemp(prefix="portbench_"))
    try:
        ctx = Context(cell, seed, seconds, trace, dev, tmp, t_start)
        if ctx.tracer is not None:
            ctx.tracer.prime()
        outcome = loop.run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"window {outcome.window_s:.6f} s, {len(outcome.calls)} calls, "
        f"{outcome.units} {outcome.unit}, peak device memory "
        f"{outcome.memory_peak} B")
    checks = judge_mod.judge(
        outcome.answers, outcome.rows, outcome.queries,
        int(cell.config["search"]["k"]), cell.config["limits"], reference,
        dev, failed=outcome.failed)
    recall = next((c.value for c in checks if c.name == "recall_at_10"),
                  None)
    tr = ctx.tracer.trace if ctx.tracer is not None else None
    rec = Record(cell, outcome, ctx.setup_s, recall, tr)
    metrics = read_metrics(cell, "per_layer" if trace else "end_to_end",
                           rec)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(cell.entry["chips"]),
                   "memory_peak_bytes": outcome.memory_peak}
    if dev.type == "cuda":
        device_info["power_limit_w"] = power_limit_w()
    result = {"correct": all(c.holds for c in checks),
              "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = tr.busy_s if tr is not None else 0.0
        device_info["window_s"] = tr.window_s if tr is not None else 0.0
        if tr is not None:
            result["breakdown"] = {"device_ops": tr.top_device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                                 "holds": c.holds} for c in checks}
    for c in checks:
        log(c.line())
    return result


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    root = BENCH_DIR.parent
    cell = Cell.find(root, args.workload)
    # kernel caches at fixed paths inside the checkout (the port builds its
    # own kernels under build/torch_kernels/)
    cache = root / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch

    want = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        log(f"this cell needs {want} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f": no result")
        return 2
    result = run(root, args.workload, args.seed, args.seconds,
                 bool(args.trace), "cuda:0", t_start)
    found = forbidden_loaded(sys.modules)
    if found:
        log(f"the process loaded {', '.join(found)}: no result")
        return 3
    print(json.dumps(result), flush=True)
    checks = result["checks"]
    log("checks: " + ", ".join(
        f"{k} {v['value']!r} (limit {v['limit']!r})"
        for k, v in checks.items()))
    return 0
