"""Background merge scheduling: merge policies + merge-pool execution.

Copy of `opensearch_jvector_tpu/index/scheduler.py` (host-only code; the
port keeps its own so that it imports nothing of the JAX package).

The reference rides Lucene's merge scheduler: merges run concurrently with
ingest on dedicated lower-priority pools (SIMD_POOL_MERGE,
JVectorFormat.java:197-212), and `ForceMergesOnlyMergePolicy`
(codec/jvector/ForceMergesOnlyMergePolicy.java:20-23) is the deterministic
override used by tests/benchmarks. This module provides the same pair:

  * `ForceMergesOnlyMergePolicy` — never auto-selects; only explicit
    `force_merge()` merges (deterministic tests).
  * `TieredMergePolicy` — size-tiered: when more than `max_segments`
    segments exist, merge the `merge_factor` smallest together.
  * `MergeScheduler` — runs selected merges on `ComputePools.merge_pool`
    (niced background threads) concurrently with ingest.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future


class MergePolicy:
    """Selects which segments to merge after a flush (None = no merge)."""

    auto = True  # False -> maybe_merge() skips sizing entirely

    def select(self, segments: list[tuple[str, int]]) -> list[str] | None:
        raise NotImplementedError


class ForceMergesOnlyMergePolicy(MergePolicy):
    """Only honors explicit force_merge (reference test/bench override)."""

    auto = False  # maybe_merge() skips segment sizing entirely

    def select(self, segments):
        return None


@dataclasses.dataclass
class TieredMergePolicy(MergePolicy):
    """Merge the `merge_factor` smallest segments once more than
    `max_segments` exist (size-tiered compaction)."""

    max_segments: int = 4
    merge_factor: int = 4

    def select(self, segments):
        if len(segments) <= self.max_segments:
            return None
        by_size = sorted(segments, key=lambda t: t[1])
        pick = by_size[: max(2, min(self.merge_factor, len(by_size)))]
        return [name for name, _ in pick]


class MergeScheduler:
    """Submits merges to the background merge pool; tracks in-flight work.

    Failed merges are never silently discarded: pruning a completed future
    stashes its exception, and the next await_all() re-raises it (the
    executor otherwise swallows unretrieved exceptions forever)."""

    def __init__(self):
        self._pending: list[Future] = []
        self._failures: list[BaseException] = []
        self._lock = threading.Lock()

    def submit(self, fn, *args) -> Future:
        from opensearch_jvector_tpu_torch.parallel.pools import ComputePools

        fut = ComputePools.instance().submit_merge(fn, *args)
        with self._lock:
            self._pending.append(fut)
            live = []
            for f in self._pending:
                if f.done():
                    exc = f.exception()
                    if exc is not None:
                        self._failures.append(exc)
                else:
                    live.append(f)
            self._pending = live
        return fut

    def await_all(self, timeout: float | None = None) -> None:
        """Join every in-flight merge (re-raises merge exceptions,
        including ones from merges that completed between calls)."""
        with self._lock:
            pending, self._pending = self._pending, []
            failures, self._failures = self._failures, []
        for f in pending:
            try:
                f.result(timeout=timeout)
            except BaseException as e:  # noqa: BLE001 — collect, then raise
                failures.append(e)
        if failures:
            raise failures[0]

    @property
    def in_flight(self) -> int:
        with self._lock:
            return sum(1 for f in self._pending if not f.done())
