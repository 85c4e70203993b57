"""The port's one span helper.

`phase(name)` marks one host step. While a `torch.profiler` is recording,
it opens a `record_function` range of that name, so the step lies on the
profiler's clock beside the kernels and copies it launches. Otherwise it
opens none: a range that no profiler records still costs over ten
microseconds of host time a call, the check for a profiler and this
object about one microsecond, so the spans are free when off. Either way
it feeds its optional time-valued counter (api/stats.py) and its optional
`add_seconds` callback with the block's host seconds, over the interval
the range covers; both are fed when the block raises too.

Names follow `<layer>.<step>` (`index.search`, `reader.to_host`,
`writer.build`, `builder.backedges_host`, ...); the older ranges `query`,
`approximate`, `rerank_gather`, `rerank_score`, `flush` and `merge` keep
their names.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from opensearch_jvector_tpu_torch.api.stats import STATS, Counter, StatsRegistry


class _Phase:
    __slots__ = ("name", "counter", "stats", "add_seconds", "_range", "_t0")

    def __init__(self, name: str, counter: Counter | None,
                 stats: StatsRegistry,
                 add_seconds: Callable[[float], None] | None):
        self.name = name
        self.counter = counter
        self.stats = stats
        self.add_seconds = add_seconds

    def __enter__(self) -> "_Phase":
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.counter is not None or self.add_seconds is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if self.counter is not None or self.add_seconds is not None:
                dt = time.perf_counter() - self._t0
                if self.counter is not None:
                    self.stats.add_seconds(self.counter, dt)
                if self.add_seconds is not None:
                    self.add_seconds(dt)
        finally:
            if self._range is not None:
                self._range.__exit__(exc_type, exc, tb)


def phase(
    name: str,
    counter: Counter | None = None,
    stats: StatsRegistry = STATS,
    add_seconds: Callable[[float], None] | None = None,
) -> _Phase:
    """A host step named `name`: a profiler range while one records, and
    its seconds into `counter` of `stats` and to `add_seconds`."""
    return _Phase(name, counter, stats, add_seconds)
