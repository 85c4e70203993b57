"""Phase-scoped profiling + wall-clock timing.

Port of `opensearch_jvector_tpu/utils/profiling.py`: wall-clock phases feed
time-valued counters (api/stats.py), and each phase is annotated with
`torch.profiler.record_function` so device kernels group under it. With
JVECTOR_TORCH_TRACE_DIR set, the phase body also runs under
`torch.profiler.profile` and writes one Chrome trace per phase name.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

from opensearch_jvector_tpu_torch.api.stats import STATS, Counter, StatsRegistry

TRACE_DIR_ENV = "JVECTOR_TORCH_TRACE_DIR"


@contextmanager
def phase(
    name: str,
    counter: Counter | None = None,
    stats: StatsRegistry = STATS,
):
    """Time a phase; optionally feed a time counter and write a trace."""
    trace_dir = os.environ.get(TRACE_DIR_ENV)
    t0 = time.monotonic()
    if trace_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(name):
                yield
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
    else:
        with torch.profiler.record_function(name):
            yield
    if counter is not None:
        stats.increment(counter, int((time.monotonic() - t0) * 1000))
