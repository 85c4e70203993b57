"""Everything BENCHMARK.json names is found by name, new pieces are found
as new files, the file keeps to its format, and nothing the benchmark
runs imports JAX or the JAX package."""

import ast
import json
import re
from pathlib import Path

import pytest

from conftest import REPO, copy_benchmark
from portbench import harness
from portbench.imports import FORBIDDEN, forbidden_loaded

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer") + (("source",) if group == "configs"
                                           else ()):
                if key in e:
                    assert 1 <= len(e[key]) <= 200, (e["name"], key)
                    assert "\n" not in e[key] and "\t" not in e[key]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_cells_and_metrics_refer_to_each_other():
    configs = {c["name"] for c in SPEC["configs"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])
    assert {w["config"] for w in SPEC["workloads"]} == configs
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in CELLS
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
    for cell in CELLS:  # setup_s, another end-to-end and a per-layer metric
        c = harness.Cell.find(REPO, cell)
        names = {m["name"] for m in c.metrics("end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        assert c.metrics("per_layer")


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_is_found_by_name(cell):
    c = harness.Cell.find(REPO, cell)
    assert callable(c.module("loops", c.traffic["loop"]).run)
    ref = c.module("reference", c.config["reference"])
    assert callable(ref.exact_topk) and callable(ref.control_topk)
    for kind in ("end_to_end", "per_layer"):
        for m in c.metrics(kind):
            assert callable(c.module("metrics", m["name"]).read)


def test_config_files_record_their_cuts():
    for entry in SPEC["configs"]:
        path = REPO / entry["file"]
        assert path.is_relative_to(REPO / "portbench")
        cfg = json.loads(path.read_text())
        assert set(entry["reduced"]) == set(cfg["reduced"])
        for key in entry["reduced"]:
            assert key in cfg
        assert len(entry["source"]) <= 200 and len(cfg["source"]) <= 200
        assert cfg["limits"]["recall_at_10_min"] == 0.95


def test_new_mix_metric_and_cell_are_found_as_new_files(tmp_path):
    root = copy_benchmark(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    bench = root / "portbench"
    (bench / "traffic" / "batch64.json").write_text(json.dumps(
        {"loop": "search_batches", "batch": 64, "warm_calls": 1,
         "trace_start_s": 1, "trace_calls": 4}))
    (bench / "metrics" / "searcher.expanded_per_query.py").write_text(
        "def read(rec):\n"
        "    return rec.counters['expanded'] / rec.counters['queries']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "sift1m-inmem.batch64",
                              "config": "sift1m-inmem", "traffic": "batch64",
                              "chips": 1, "why": "small batches"})
    spec["per_layer"].append({
        "name": "searcher.expanded_per_query", "unit": "rows/query",
        "better": "lower", "source": "program_counter", "layer": "searcher",
        "moves": "qps", "workloads": ["sift1m-inmem.batch64"]})
    spec["end_to_end"][0]["workloads"].append("sift1m-inmem.batch64")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.Cell.find(root, "sift1m-inmem.batch64")
    assert cell.traffic["batch"] == 64
    assert [m["name"] for m in cell.metrics("per_layer")] == [
        "searcher.expanded_per_query"]
    reader = cell.module("metrics", "searcher.expanded_per_query")
    rec = type("R", (), {"counters": {"expanded": 30, "queries": 10}})()
    assert reader.read(rec) == 3.0
    for p, raw in before.items():  # no file that was there was edited
        assert p.read_bytes() == raw


def test_forbidden_modules_compare_top_level_names_whole():
    assert forbidden_loaded(["opensearch_jvector_tpu_torch",
                             "opensearch_jvector_tpu_torch.index.index",
                             "jaxtyping", "flaxen.x", "numpy"]) == []
    assert forbidden_loaded(["opensearch_jvector_tpu.ops", "jax.numpy",
                             "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "opensearch_jvector_tpu"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (REPO / "portbench").rglob("*.py"):
        assert not _imports(path) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").glob("*.py"):
        tops = _imports(path)
        assert not any(t.startswith("opensearch_jvector_tpu") for t in tops)
        assert not tops & {"portbench"}, path


def test_the_command_refuses_to_run_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
