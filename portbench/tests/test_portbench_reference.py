"""The reference's exact top k, scores and recall on small data against
brute force in NumPy, and the judge's checks on answers made to fail."""

import numpy as np
import pytest

from portbench import judge
from portbench.reference import exact_l2


def data(seed=0, n=700, q=40, d=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((q, d)).astype(np.float32))


def brute(rows, queries, k):
    d2 = ((queries[:, None, :].astype(np.float64)
           - rows[None, :, :].astype(np.float64)) ** 2).sum(-1)
    ids = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d2, ids, 1)


@pytest.mark.parametrize("row_block,q_block", [(1 << 17, 1024), (64, 16)])
def test_exact_topk_matches_brute_force(monkeypatch, row_block, q_block):
    monkeypatch.setattr(exact_l2, "ROW_BLOCK", row_block)
    monkeypatch.setattr(exact_l2, "Q_BLOCK", q_block)
    rows, queries = data()
    ids, d2 = exact_l2.exact_topk(rows, queries, 10, "cpu")
    want_ids, want_d2 = brute(rows, queries, 10)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(d2, want_d2, rtol=1e-12)


def test_exact_scores_and_recall():
    rows, queries = data(1)
    truth, d2 = brute(rows, queries, 10)
    qidx = np.arange(queries.shape[0])
    s = exact_l2.exact_scores(rows, queries, qidx, truth, "cpu")
    np.testing.assert_allclose(s, 1.0 / (1.0 + d2), rtol=1e-13)
    bad = truth.copy()
    bad[:, 0] = -1
    assert np.isnan(exact_l2.exact_scores(rows, queries, qidx, bad,
                                          "cpu")[:, 0]).all()
    half = truth.copy()
    half[:, 5:] = truth[:, ::-1][:, :5] + 10_000  # five ids that miss
    assert judge.recall(truth, truth) == 1.0
    assert judge.recall(half, truth) == pytest.approx(0.5)
    sets = [len(set(a) & set(b)) / 10 for a, b in zip(half, truth)]
    assert judge.recall(half, truth, block=7) == pytest.approx(
        np.mean(sets))


def test_control_is_tf32_and_reads_a_wider_gap():
    rows, queries = data(2, d=128)
    rows += 3.0  # large norms against small distances, as in the corpora
    queries += 3.0
    ids, scores = exact_l2.control_topk(rows, queries, 10, "cpu")
    ref = exact_l2.exact_scores(rows, queries,
                                np.arange(queries.shape[0]), ids, "cpu")
    gap = judge.score_gap(scores, ref)
    assert gap > 1e-4
    import torch
    up = torch.tensor([1.0 + 2.0 ** -11 + 2.0 ** -12])  # past half an ulp
    down = torch.tensor([1.0 + 2.0 ** -12])
    assert exact_l2.round_to_tf32(up).item() == 1.0 + 2 ** -10
    assert exact_l2.round_to_tf32(down).item() == 1.0
    assert exact_l2.round_to_tf32(torch.tensor([-1.5])).item() == -1.5


def test_bad_rows():
    ids = np.array([[1, 2, 3], [1, 1, 3], [1, 2, -1], [1, 2, 9]])
    scores = np.array([[0.9, 0.8, 0.7], [0.9, 0.8, 0.7], [0.9, 0.8, 0.7],
                       [0.7, 0.8, 0.9]], np.float32)
    assert judge.bad_rows(ids, scores, 10) == 3  # the dup, the -1, rising
    assert judge.bad_rows(ids[3:], scores[3:], 10) == 1  # rising scores
    assert judge.bad_rows(ids[:1], np.array([[0.9, np.nan, 0.1]]), 10) == 1
    assert judge.bad_rows(ids[3:], scores[:1], 9) == 1  # id 9 >= 9 rows


def test_judge_passes_exact_answers_and_fails_altered_ones():
    rows, queries = data(3)
    truth, d2 = brute(rows, queries, 10)
    qidx = np.arange(queries.shape[0])
    scores = (1.0 / (1.0 + d2)).astype(np.float32)
    limits = {"recall_at_10_min": 0.95, "score_gap_max": 1e-4}
    ok = judge.judge(judge.Answers(qidx, truth, scores), rows, queries, 10,
                     limits, exact_l2, "cpu")
    assert all(c.holds for c in ok), [c.line() for c in ok]
    shifted = judge.judge(judge.Answers(qidx, (truth + 1) % rows.shape[0],
                                        scores), rows, queries, 10, limits,
                          exact_l2, "cpu")
    failing = {c.name for c in shifted if not c.holds}
    assert {"score_gap", "recall_at_10"} <= failing
    none = judge.judge(judge.Answers(qidx[:0], truth[:0], scores[:0]), rows,
                       queries, 10, limits, exact_l2, "cpu")
    assert not all(c.holds for c in none)
    failed = judge.judge(judge.Answers(qidx, truth, scores), rows, queries,
                         10, limits, exact_l2, "cpu", failed=1)
    assert [c.name for c in failed if not c.holds] == ["failed"]
