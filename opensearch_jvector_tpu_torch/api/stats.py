"""Counters + stats registry (observability surface).

Mirrors the reference's `KNNCounter` set including the jVector-specific
counters (KNNCounter.java:13-37: knn_query_count, query_visited_nodes,
reranked_count, expanded_nodes, expanded_base_layer_nodes, graph_search_time,
quantization_training_time, graph_merge_time ...) and the `KNNStats`
node-level registry (KNNStats.java:40-75). Thread-safe via a lock (counters
are bumped from host orchestration code, not inside jit).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from enum import Enum


class Counter(Enum):
    # query-side
    KNN_QUERY_COUNT = "knn_query_count"
    KNN_QUERY_WITH_FILTER_COUNT = "knn_query_with_filter_count"
    KNN_QUERY_VISITED_NODES = "knn_query_visited_nodes"
    KNN_QUERY_RERANKED_COUNT = "knn_query_reranked_count"
    KNN_QUERY_EXPANDED_NODES = "knn_query_expanded_nodes"
    KNN_QUERY_EXPANDED_BASE_LAYER_NODES = "knn_query_expanded_base_layer_nodes"
    KNN_GRAPH_SEARCH_TIME = "knn_graph_search_time"
    # on_disk candidate rows scored by the host rerank kernel
    # (csrc/host_rerank.cpp); 0 where its numpy fallback ran (the port's own)
    KNN_QUERY_HOST_RERANK_NATIVE_ROWS = "knn_query_host_rerank_native_rows"
    # the host row store's gathers: pages they advised the kernel to read
    # ahead (csrc/vector_store.cpp), and on_disk rerank gathers served from
    # their thread's existing block buffer without growing it (the port's
    # own)
    KNN_QUERY_ROW_STORE_PAGES_ADVISED = "knn_query_row_store_pages_advised"
    KNN_QUERY_RERANK_BUFFER_REUSES = "knn_query_rerank_buffer_reuses"
    # the beam walk over codes: the plain walk's steps, one host wait each
    # (the `hamming` provider, and every walk on the CPU), the kernel's
    # launches (the `pq` provider on a card), and the rows reranked from
    # the NVQ decode (the port's own)
    KNN_QUERY_CODES_WALK_STEPS = "knn_query_codes_walk_steps"
    KNN_QUERY_CODES_WALK_LAUNCHES = "knn_query_codes_walk_launches"
    KNN_QUERY_NVQ_RERANKED_COUNT = "knn_query_nvq_reranked_count"
    SCRIPT_QUERY_REQUESTS = "script_query_requests"
    SCRIPT_QUERY_ERRORS = "script_query_errors"
    # index-side
    KNN_GRAPH_BUILD_TIME = "knn_graph_build_time"
    KNN_GRAPH_MERGE_TIME = "knn_graph_merge_time"
    KNN_QUANTIZATION_TRAINING_TIME = "knn_quantization_training_time"
    KNN_FLUSH_COUNT = "knn_flush_count"
    KNN_MERGE_COUNT = "knn_merge_count"
    # the flushes' graph builds: nodes inserted, and the rows scored and
    # nodes expanded by their insert walks (the port's own; the reference's
    # KNNCounter has no build work counts)
    KNN_GRAPH_BUILD_NODES = "knn_graph_build_nodes"
    KNN_GRAPH_BUILD_ROWS_SCORED = "knn_graph_build_rows_scored"
    KNN_GRAPH_BUILD_EXPANDED_NODES = "knn_graph_build_expanded_nodes"
    # the insert rounds' reverse edges written to a slot and rows sent to
    # the overflow prune, over flushes and merges (the port's own)
    KNN_GRAPH_BUILD_REVERSE_EDGES = "knn_graph_build_reverse_edges"
    KNN_GRAPH_BUILD_OVERFLOW_NODES = "knn_graph_build_overflow_nodes"


class StatsRegistry:
    """Node-level counter registry; cluster aggregation sums registries.

    Time-valued counters hold whole milliseconds (as the reference's stats
    API reports them); `add_seconds` carries what a block adds below a
    millisecond on to the next block, so many short blocks add up."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {c.value: 0 for c in Counter}
        # per time-valued counter: nanoseconds below its last whole ms
        self._carry_ns: dict[str, int] = {}

    def increment(self, counter: Counter, amount: int = 1) -> None:
        with self._lock:
            self._counters[counter.value] += int(amount)

    def add_seconds(self, counter: Counter, seconds: float) -> None:
        """Add `seconds` to the millisecond counter `counter`."""
        with self._lock:
            ns = self._carry_ns.get(counter.value, 0) + round(seconds * 1e9)
            whole, self._carry_ns[counter.value] = divmod(ns, 1_000_000)
            self._counters[counter.value] += whole

    def get(self, counter: Counter) -> int:
        with self._lock:
            return self._counters[counter.value]

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            for k in self._counters:
                self._counters[k] = 0
            self._carry_ns.clear()

    @contextmanager
    def timed(self, counter: Counter):
        """Accumulate elapsed milliseconds into a time-valued counter."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add_seconds(counter, time.monotonic() - t0)

    @staticmethod
    def aggregate(registries: list["StatsRegistry"]) -> dict[str, int]:
        """Cluster-level stats = sum over nodes (transport-broadcast analog)."""
        out: dict[str, int] = {c.value: 0 for c in Counter}
        for r in registries:
            for k, v in r.snapshot().items():
                out[k] += v
        return out


# process-wide default registry (the "node" registry)
STATS = StatsRegistry()
