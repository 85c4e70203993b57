"""`correct` on a whole run of each cell, at a size a test can hold, on the
CPU (the harness's look for a card is skipped by calling `harness.run`):
true for the program as it is, false for the TF32 control in its place,
and false with the timed path broken underneath in each way the cell can
break: an answer altered where it is produced, half of the batch left
out, a step that returns its state unchanged."""

import dataclasses

import numpy as np
import pytest

from portbench import control, harness

CELLS = ["sift1m-inmem.batch512", "gist500k-ondisk.batch500",
         "sift1m-inmem.ingest300k", "sift1m-inmem.rest200"]
SEED = 2**31 + 99


def run(root, cell, seconds=0.5):
    return harness.run(root, cell, SEED, seconds, False, "cpu")


def failing(result) -> set:
    return {k for k, v in result["checks"].items() if not v["holds"]}


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_as_it_is_runs_correct(small_root, cell):
    result = run(small_root, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    names = {m["name"] for m in harness.Cell.find(small_root, cell)
             .metrics("end_to_end")}
    assert set(result["metrics"]) == names
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(small_root, cell):
    checks = control.readings(small_root, cell, SEED, "cpu", flushes=2)
    assert "score_gap" in {c.name for c in checks if not c.holds}


def _patch_search(monkeypatch, alter):
    from opensearch_jvector_tpu_torch.index.index import VectorIndex

    original = VectorIndex.search
    state = {}

    def search(self, queries, sc, accept_docs=None):
        res = original(self, queries, sc, accept_docs=accept_docs)
        return alter(res, state)

    monkeypatch.setattr(VectorIndex, "search", search)


def _altered(res, state):  # one id of every answer changed
    ids = res.doc_ids.copy()
    ids[:, 0] = (ids[:, 0] + 1) % 1000
    return dataclasses.replace(res, doc_ids=ids)


def _half(res, state):  # the second half of the batch left out
    ids, scores = res.doc_ids.copy(), res.scores.copy()
    h = ids.shape[0] // 2
    if ids.shape[0] == 1:
        state["n"] = state.get("n", 0) + 1
        h = 0 if state["n"] % 2 else 1
    ids[h:] = -1
    scores[h:] = -np.inf
    return dataclasses.replace(res, doc_ids=ids, scores=scores)


def _unchanged(res, state):  # every call answers as the first one did
    first = state.setdefault("first", res)
    n = min(first.doc_ids.shape[0], res.doc_ids.shape[0])
    ids, scores = res.doc_ids.copy(), res.scores.copy()
    ids[:n], scores[:n] = first.doc_ids[:n], first.scores[:n]
    return dataclasses.replace(res, doc_ids=ids, scores=scores)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered, _half, _unchanged],
                         ids=["altered", "half", "unchanged"])
def test_a_broken_search_is_not_correct(small_root, monkeypatch, cell,
                                        fault):
    _patch_search(monkeypatch, fault)
    result = run(small_root, cell)
    assert not result["correct"], result["checks"]


def test_a_flush_that_keeps_the_index_unchanged_is_not_correct(
        small_root, monkeypatch):
    """Ingest: every second flush drops its rows and leaves the segment
    set as it was."""
    from opensearch_jvector_tpu_torch.index.index import VectorIndex

    original = VectorIndex.flush
    count = {"n": 0}

    def flush(self, *a, **kw):
        count["n"] += 1
        if count["n"] % 2 == 0:
            self.writer._blocks.clear()
            self.writer._buffered = 0
            return None
        return original(self, *a, **kw)

    monkeypatch.setattr(VectorIndex, "flush", flush)
    result = run(small_root, "sift1m-inmem.ingest300k", seconds=2.0)
    assert result["attempted"] >= 2
    assert not result["correct"], result["checks"]
    assert "recall_at_10" in failing(result)


def test_a_traced_run_reports_per_layer_metrics(small_root):
    """On the CPU the trace holds no device event: the device-trace
    metrics are left out, the counters' metrics are reported, and the
    device block carries the traced window."""
    result = harness.run(small_root, "sift1m-inmem.batch512", SEED, 0.5,
                         True, "cpu")
    assert result["correct"]
    assert set(result["metrics"]) == {"searcher.visited_per_query"}
    assert result["device"]["busy_s"] == 0.0
    assert "window_s" in result["device"] and "breakdown" in result
