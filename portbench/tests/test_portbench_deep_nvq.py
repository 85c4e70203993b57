"""The NVQ cosine cell (`deep4m-nvq.batch512`) run small on the CPU, its
segment searched through the beam tier as on the card: `correct` for the
program, not for the TF32 control nor under each fault that
`test_portbench_faults.py` defines, and the four codes-walk metrics read
from a traced run."""

import json

import pytest
import torch

from conftest import SMALL_TRAFFIC, copy_benchmark
from portbench import control, harness

torch.set_num_threads(2)

CELL = "deep4m-nvq.batch512"
SEED = 2**31 + 4242
# rows, queries, latent of the small copy; widths as configured
ROWS, QUERIES, LATENT = 3000, 200, 16


@pytest.fixture
def deep_root(tmp_path, monkeypatch):
    """A copy with the configuration cut to a test's rows and queries and
    the mix to a test's batch, the segment taken by the beam tier."""
    from opensearch_jvector_tpu_torch.index.reader import SegmentReader

    root = copy_benchmark(tmp_path)
    p = root / "portbench" / "configs" / "deep4m-nvq.json"
    c = json.loads(p.read_text())
    c.update(rows=ROWS, queries=QUERIES, flush_rows=ROWS)
    c["data"]["latent"] = LATENT
    c["search"]["ef_search"] = 64
    p.write_text(json.dumps(c))
    t = root / "portbench" / "traffic" / "batch512.json"
    t.write_text(json.dumps(dict(json.loads(t.read_text()),
                                 **SMALL_TRAFFIC["batch512"])))
    monkeypatch.setattr(SegmentReader, "SCAN_TIER_MAX_CODES", 0)
    return root


def run(root, trace=False, seconds=0.5):
    return harness.run(root, CELL, SEED, seconds, trace, "cpu")


def test_the_program_runs_correct(deep_root):
    result = run(deep_root)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"qps", "latency_p95_ms",
                                      "recall_at_10", "setup_s"}


def test_the_tf32_control_is_not_correct(deep_root):
    checks = control.readings(deep_root, CELL, SEED, "cpu")
    assert {c.name for c in checks if not c.holds} == {"score_gap"}


@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_a_broken_search_is_not_correct(deep_root, monkeypatch, fault):
    import test_portbench_faults as faults

    faults._patch_search(monkeypatch, getattr(faults, f"_{fault}"))
    # a window of several calls: the first answers as the warm call did
    result = run(deep_root, seconds=3.0)
    assert result["attempted"] >= 2
    assert not result["correct"], result["checks"]


@pytest.fixture
def device_kept(monkeypatch):
    """Each trace taken on the CPU gains one device event launched inside
    each `searcher.codes_walk` range, as a trace of the card would have,
    so the span and roofline metrics read it."""
    from portbench import trace as trace_mod

    load = trace_mod.Trace.load

    def with_device(path):
        t = load(path)
        for a, b, name, tid in list(t.ranges):
            if name == "searcher.codes_walk":
                corr = f"cpu-test-{len(t.launch)}"
                t.launch[corr] = (a, tid)
                t.device.append((a, min(b, a + 1.0), "k", corr))
        return t

    monkeypatch.setattr(trace_mod.Trace, "load", staticmethod(with_device))


def test_a_traced_run_reads_the_codes_walk_metrics(deep_root, device_kept):
    result = run(deep_root, trace=True)
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["searcher.codes_walk_ms"] > 0.0
    assert m["searcher.nvq_rerank_ms"] > 0.0
    # ef 64 over 16 expansions a step: at most max(8, 4) steps a batch
    assert 1.0 <= m["searcher.codes_walk_steps"] <= 8.0
    assert 0.0 < m["codes_walk_roofline"]
    assert m["index.waits_per_batch"] == 1.0
