"""Host executor pools: foreground flush vs background merge.

Copy of `opensearch_jvector_tpu/parallel/pools.py` (host-only code; the
port keeps its own so that it imports nothing of the JAX package).
Mirrors the reference's dedicated ForkJoinPools — SIMD_POOL_FLUSH vs
SIMD_POOL_MERGE kept separate so background merges never starve foreground
flushes, with merge threads at lowered priority (JVectorFormat.java:36-39,
197-212, priority NORM-2 at :206). Device work from every pool thread goes
to the device's default stream, which serializes it; these pools
parallelize the HOST side (adjacency bookkeeping, serialization, IO) and
keep merge work off the ingest path. Only `submit_merge` has a caller so
far: the per-segment search fan-out on `flush_pool` waits (ROADMAP queue 2,
"in_memory: one host wait a batch").
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor


def _physical_cores() -> int:
    # jvector.physical_core_count analog (JVectorFormat.java:198-201)
    env = os.environ.get("JVECTOR_TPU_PHYSICAL_CORE_COUNT")
    if env:
        return max(1, int(env))
    heuristic = max(1, (os.cpu_count() or 2) // 2)
    # knn.algo_param.index_thread_qty (KNNSettings.java): the reference
    # sizes per-field merge workers from this cluster setting. Honored as a
    # RAISE only — max(qty, heuristic) — so a modest bump above the default
    # of 1 on a many-core host widens the pools instead of shrinking them.
    # Note ComputePools is a cached singleton: the setting must be in place
    # before the first pool use (see ComputePools.reset_for_settings).
    try:
        from opensearch_jvector_tpu_torch.api.settings import (
            GLOBAL_SETTINGS,
        )

        qty = int(GLOBAL_SETTINGS.get("knn.algo_param.index_thread_qty"))
        if qty > 1:
            return max(qty, heuristic)
    except Exception:  # noqa: BLE001 — settings registry optional here
        pass
    return heuristic


class _NicedExecutor(ThreadPoolExecutor):
    """Executor whose workers drop their scheduling priority."""

    def __init__(self, max_workers: int, name: str, nice_increment: int = 0):
        self._nice_increment = nice_increment
        super().__init__(max_workers=max_workers, thread_name_prefix=name,
                         initializer=self._init_worker)

    def _init_worker(self):
        if self._nice_increment:
            try:
                os.nice(self._nice_increment)
            except OSError:
                pass


class ComputePools:
    """FLUSH (foreground) + MERGE (background, niced) executors."""

    _instance: "ComputePools | None" = None
    _lock = threading.Lock()

    def __init__(self):
        cores = _physical_cores()
        self.flush_pool = _NicedExecutor(cores, "jvt-flush")
        self.merge_pool = _NicedExecutor(max(1, cores // 2), "jvt-merge",
                                         nice_increment=2)
        # shard-level search fan-out (ShardedVectorIndex.search).
        # Distinct from flush_pool: shard searches submit their per-segment
        # work to flush_pool, and a single shared pool would deadlock once
        # outer tasks occupy every worker while waiting on inner tasks.
        self.search_pool = _NicedExecutor(cores, "jvt-search")

    @classmethod
    def instance(cls) -> "ComputePools":
        with cls._lock:
            if cls._instance is None:
                cls._instance = ComputePools()
            return cls._instance

    @classmethod
    def reset_for_settings(cls) -> None:
        """Rebuild the singleton so a late `index_thread_qty` change takes
        effect (the pools are otherwise sized once, at first use). Old pools
        finish their in-flight work and are garbage-collected."""
        with cls._lock:
            old = cls._instance
            cls._instance = None
        if old is not None:
            old.flush_pool.shutdown(wait=False)
            old.merge_pool.shutdown(wait=False)
            old.search_pool.shutdown(wait=False)

    def submit_flush(self, fn, *args, **kwargs) -> Future:
        return self.flush_pool.submit(fn, *args, **kwargs)

    def submit_merge(self, fn, *args, **kwargs) -> Future:
        return self.merge_pool.submit(fn, *args, **kwargs)
