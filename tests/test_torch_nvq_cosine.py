"""The port's NVQ cosine deployment (`nvq+pq`, cosine, in_memory vamana,
the segment taken by the beam tier) against the benchmark's plain
reference `portbench/reference/nvq_cosine.py`, and the codes walk's
spans and counters.

- The port's stored NVQ bytes, parameters and mean equal the reference's
  re-encode of the same rows by NVQ's published definition (0 rows
  differ on these seeds).
- Every returned score is the reference's float64 cosine score of the
  query and that row's NVQ reconstruction within SCORE_RTOL, and recall@10
  against the exact cosine top 10 of the raw rows reaches the target.
- The reference's TF32 control fails that score check.
- A search whose approximate phase walks PQ codes opens the spans
  `searcher.codes_walk` and `searcher.nvq_rerank` and counts the plain
  walk's steps and the rows reranked from NVQ; a row-provider search
  opens neither span.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig, SearchConfig
from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
from opensearch_jvector_tpu_torch.api.stats import Counter, StatsRegistry
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.reader import SegmentReader
from opensearch_jvector_tpu_torch.index.scheduler import (
    ForceMergesOnlyMergePolicy,
)
from opensearch_jvector_tpu_torch.ops import beam_kernel
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from portbench import judge
from portbench.reference import nvq_cosine as ref

torch.set_num_threads(2)

N, D, Q, K, LATENT = 3000, 96, 200, 10, 16
SETTING = "index.knn.advanced.scan_tier_max_codes"
CONFIG = (Path(__file__).resolve().parents[1] / "portbench" / "configs"
          / "deep4m-nvq.json")
CFG = dict(dim=D, similarity=SimilarityFunction.COSINE, m=32,
           ef_construction=100, num_pq_subspaces=48,
           quantization_type="nvq+pq", nvq_num_subvectors=2)
SC = SearchConfig(k=K, ef_search=100, overquery_factor=5)
# The port scores in float32: each side normalised (a sum of 96 squares and
# an inverse square root) and one 96-term dot, each a few units of 2^-24
# times sqrt(96) ~ 6e-7 of the score; twice that is the tolerance. TF32's
# 10-bit inputs move a score by ~1e-4 (the control, below).
SCORE_RTOL = 2e-6


def _latent(rng, n):
    basis = rng.standard_normal((LATENT, D)) / np.sqrt(LATENT)
    return (rng.standard_normal((n, LATENT)) @ basis
            + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


def _data(seed):
    rng = np.random.default_rng(seed)
    x = _latent(rng, N + Q)
    return x[:N], x[N:]


@pytest.fixture(scope="module", params=[11, 12], ids=["seed11", "seed12"])
def deployment(request, tmp_path_factory):
    """One NVQ cosine segment over N rows, searched through the beam tier
    -> (rows, queries, index, segment path, the index's stats)."""
    rows, queries = _data(request.param)
    stats = StatsRegistry()
    root = tmp_path_factory.mktemp("nvq")
    idx = VectorIndex(root, DiskAnnConfig(**CFG), device="cpu",
                      merge_policy=ForceMergesOnlyMergePolicy(), stats=stats)
    idx.add_batch(np.arange(N), rows)
    path = root / idx.flush()
    GLOBAL_SETTINGS.put(SETTING, 0)
    try:
        yield rows, queries, idx, path, stats
    finally:
        GLOBAL_SETTINGS.put(SETTING, -1)
        idx.close()


def _search(idx, queries):
    res = idx.search(queries, SC)
    return res.doc_ids, res.scores


def test_the_stored_nvq_equals_the_reference_encode(deployment):
    rows, _, _, path, _ = deployment
    seg = SegmentReader.open(path, "cpu").seg
    x = torch.from_numpy(rows)
    mean = ref.global_mean(x)
    codes, params = ref.encode(x, mean)
    assert torch.equal(seg.nvq.global_mean, mean)
    differ = (codes != seg.nvq.bytes_[:N]).any(1)
    assert int(differ.sum()) == 0
    assert torch.equal(params, seg.nvq.params[:N])


def test_scores_are_the_nvq_reconstruction_cosine(deployment):
    rows, queries, idx, _, stats = deployment
    before = stats.get(Counter.KNN_QUERY_CODES_WALK_STEPS)
    ids, scores = _search(idx, queries)
    assert stats.get(Counter.KNN_QUERY_CODES_WALK_STEPS) > before
    assert judge.bad_rows(ids, scores, N) == 0
    want = ref.exact_scores(rows, queries, np.arange(Q), ids, "cpu")
    assert judge.score_gap(scores, want) <= SCORE_RTOL
    # the raw rows' scores differ by NVQ's own error, far past it
    raw = (1.0 + np.einsum("qkd,qd->qk", _unit(rows)[ids],
                           _unit(queries))) / 2.0
    assert judge.score_gap(scores, raw) > 100 * SCORE_RTOL


def _unit(x):
    x = x.astype(np.float64)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_recall_against_exact_cosine(deployment):
    rows, queries, idx, _, _ = deployment
    ids, _ = _search(idx, queries)
    truth, cos = ref.exact_topk(rows, queries, K, "cpu")
    brute = _unit(queries) @ _unit(rows).T
    np.testing.assert_allclose(cos, np.take_along_axis(brute, truth, 1),
                               rtol=1e-12)
    np.testing.assert_allclose(cos, np.sort(brute, 1)[:, ::-1][:, :K],
                               rtol=1e-12)
    assert judge.recall(ids, truth) >= 0.95


def test_the_tf32_control_fails_the_score_check(deployment):
    rows, queries, _, _, _ = deployment
    ids, scores = ref.control_topk(rows, queries, K, "cpu")
    want = ref.exact_scores(rows, queries, np.arange(Q), ids, "cpu")
    assert judge.score_gap(scores, want) > 10 * SCORE_RTOL
    limits = json.loads(CONFIG.read_text())["limits"]
    checks = judge.judge(judge.Answers(np.arange(Q), ids, scores), rows,
                         queries, K, limits, ref, "cpu")
    assert [c.name for c in checks if not c.holds] == ["score_gap"]


def test_counters_are_the_walks_steps_and_the_nvq_reranked_rows(
        deployment, monkeypatch):
    """The plain walk scores its entry once, then once a step: the step
    count is the provider's calls less one, counted here apart from the
    walk's own report."""
    _, queries, idx, _, stats = deployment
    calls = []
    original = beam_kernel.beam_search_reference

    def spy(adjacency, entry, score, *a, **kw):
        def counted(ids):
            calls[-1] += 1
            return score(ids)
        calls.append(0)
        return original(adjacency, entry, counted, *a, **kw)

    monkeypatch.setattr(beam_kernel, "beam_search_reference", spy)
    s0 = stats.snapshot()
    res = idx.search(queries, SC)
    s1 = stats.snapshot()
    assert len(calls) == 1 and calls[0] > 1
    assert (s1["knn_query_codes_walk_steps"]
            - s0["knn_query_codes_walk_steps"]) == calls[0] - 1
    assert (s1["knn_query_nvq_reranked_count"]
            - s0["knn_query_nvq_reranked_count"]) == res.reranked > 0


def _range_names(tmp_path, fn) -> list[str]:
    path = tmp_path / "trace.json"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    return [e["name"] for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_the_codes_walk_spans_in_an_exported_trace(deployment, tmp_path):
    _, queries, idx, _, _ = deployment
    names = _range_names(tmp_path, lambda: idx.search(queries[:64], SC))
    assert names.count("searcher.codes_walk") == 1
    assert names.count("searcher.nvq_rerank") == 1
    assert names.count("reader.to_host") == 1


def test_a_row_provider_search_opens_neither_span(tmp_path):
    rows, queries = _data(13)
    stats = StatsRegistry()
    idx = VectorIndex(tmp_path / "pq", DiskAnnConfig(
        dim=D, m=16, ef_construction=48, num_pq_subspaces=48),
        device="cpu", merge_policy=ForceMergesOnlyMergePolicy(),
        stats=stats)
    idx.add_batch(np.arange(1000), rows[:1000])
    idx.flush()
    GLOBAL_SETTINGS.put(SETTING, 0)
    try:
        names = _range_names(tmp_path,
                             lambda: idx.search(queries[:64], SC))
    finally:
        GLOBAL_SETTINGS.put(SETTING, -1)
        idx.close()
    assert "query" in names and "reader.to_host" in names
    assert "searcher.codes_walk" not in names
    assert "searcher.nvq_rerank" not in names
    assert stats.get(Counter.KNN_QUERY_CODES_WALK_STEPS) == 0
    assert stats.get(Counter.KNN_QUERY_NVQ_RERANKED_COUNT) == 0
