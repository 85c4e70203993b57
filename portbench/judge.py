"""The comparison that decides `correct`.

Every answer the timed path gave (or, in the ingest cell, the answers of
the search over what the window flushed) is compared with the plain
reference, recomputed from the rows and queries the benchmark made:

- `bad_rows`: answer rows that are malformed: fewer than k ids, an id that
  is no row, an id twice, a score that is not finite, or scores that rise
  along the row. Limit 0.
- `recall_at_10`: the share of each answered query's exact top k among its
  returned ids, over every answer. At least the configuration's target.
- `score_gap`: the largest relative gap |s - s_ref| / s_ref between a
  returned score and the reference's float64 score of the same row. The
  configurations guarantee exact float32 scores; the limit lies between
  what sound runs and the TF32 control read (PERF.md).
- `failed`: calls that returned an error. Limit 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Answers:
    qidx: np.ndarray    # [A] int64: the query each answer row is for
    ids: np.ndarray     # [A, k] int64
    scores: np.ndarray  # [A, k] float32


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float
    at_most: bool  # True: value <= limit holds; False: value >= limit

    @property
    def holds(self) -> bool:
        if not np.isfinite(self.value):
            return False
        return (self.value <= self.limit if self.at_most
                else self.value >= self.limit)

    def line(self) -> str:
        op = "<=" if self.at_most else ">="
        return (f"check {self.name} {self.value!r} {op} {self.limit!r} "
                + ("holds" if self.holds else "FAILS"))


def bad_rows(ids: np.ndarray, scores: np.ndarray, n_rows: int) -> int:
    """Answer rows that are malformed (see the module docstring)."""
    if ids.shape[0] == 0:
        return 0
    out_of_range = ((ids < 0) | (ids >= n_rows)).any(1)
    s = np.sort(ids, axis=1)
    duplicate = (s[:, 1:] == s[:, :-1]).any(1)
    not_finite = ~np.isfinite(scores).all(1)
    with np.errstate(invalid="ignore"):
        rising = (scores[:, 1:] > scores[:, :-1]).any(1)
    return int((out_of_range | duplicate | not_finite | rising).sum())


def recall(ids: np.ndarray, truth: np.ndarray, block: int = 1 << 16) -> float:
    """Mean over rows of |ids ∩ truth| / k, for `truth` [A, k] aligned with
    `ids` and holding no repeats."""
    hits = 0
    for lo in range(0, ids.shape[0], block):
        hits += int((ids[lo: lo + block, :, None]
                     == truth[lo: lo + block, None, :]).any(2).sum())
    return hits / (ids.shape[0] * truth.shape[1])


def score_gap(scores: np.ndarray, ref: np.ndarray) -> float:
    """Largest |s - ref| / ref over the entries with a reference score."""
    ok = np.isfinite(ref)
    if not ok.any():
        return float("nan")
    return float((np.abs(scores[ok].astype(np.float64) - ref[ok])
                  / ref[ok]).max())


def judge(answers: Answers, rows: np.ndarray, queries: np.ndarray, k: int,
          limits: dict, reference, device, failed: int = 0) -> list[Check]:
    """The checks of one run's answers against the reference."""
    n = rows.shape[0]
    checks = [Check("failed", float(failed), 0.0, True)]
    if answers.ids.shape[0] == 0:
        return checks + [Check("answers", 0.0, 1.0, False)]
    ids = answers.ids
    if ids.shape[1] < k:  # fewer than k ids: pad as missing
        pad = k - ids.shape[1]
        ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        answers = Answers(answers.qidx, ids,
                          np.pad(answers.scores, ((0, 0), (0, pad)),
                                 constant_values=-np.inf))
    checks.append(Check("bad_rows", float(bad_rows(ids, answers.scores, n)),
                        0.0, True))
    asked, slot = np.unique(answers.qidx, return_inverse=True)
    truth, _ = reference.exact_topk(rows, queries[asked], k, device)
    rec = recall(ids, truth[slot])
    checks.append(Check("recall_at_10", rec,
                        float(limits["recall_at_10_min"]), False))
    ref = reference.exact_scores(rows, queries, answers.qidx, ids, device)
    checks.append(Check("score_gap", score_gap(answers.scores, ref),
                        float(limits["score_gap_max"]), True))
    return checks
