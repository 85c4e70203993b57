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
    SCRIPT_QUERY_REQUESTS = "script_query_requests"
    SCRIPT_QUERY_ERRORS = "script_query_errors"
    # index-side
    KNN_GRAPH_BUILD_TIME = "knn_graph_build_time"
    KNN_GRAPH_MERGE_TIME = "knn_graph_merge_time"
    KNN_QUANTIZATION_TRAINING_TIME = "knn_quantization_training_time"
    KNN_FLUSH_COUNT = "knn_flush_count"
    KNN_MERGE_COUNT = "knn_merge_count"
    # mesh-path state uploads (ShardedVectorIndex): each re-stack re-uploads
    # shard state to the mesh after the segment set changes; the time
    # counter records the stall so operators can see churn cost
    KNN_MESH_RESTACK_COUNT = "knn_mesh_restack_count"
    KNN_MESH_RESTACK_TIME = "knn_mesh_restack_time"
    # incremental restacks: only changed shards re-stacked (device-side
    # slice writes instead of a full-corpus host re-upload)
    KNN_MESH_RESTACK_PARTIAL_COUNT = "knn_mesh_restack_partial_count"
    # mesh-eligibility rejections: why a search fell back to the host
    # scatter-gather loop. Each reason has a distinct operator fix
    # (compact segments / flush buffers / unify quantization modes), so
    # drift off the fast path is visible per cause in /_plugins/_knn/stats.
    KNN_MESH_REJECT_SEGMENT_COUNT = "knn_mesh_reject_segment_count"
    KNN_MESH_REJECT_BUFFERED_DOCS = "knn_mesh_reject_buffered_docs"
    KNN_MESH_REJECT_EMPTY_SHARD = "knn_mesh_reject_empty_shard"
    KNN_MESH_REJECT_STACK_SHAPE = "knn_mesh_reject_stack_shape"


class StatsRegistry:
    """Node-level counter registry; cluster aggregation sums registries."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {c.value: 0 for c in Counter}

    def increment(self, counter: Counter, amount: int = 1) -> None:
        with self._lock:
            self._counters[counter.value] += int(amount)

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

    @contextmanager
    def timed(self, counter: Counter):
        """Accumulate elapsed milliseconds into a time-valued counter."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.increment(counter, int((time.monotonic() - t0) * 1000))

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
