"""Distributed (multi-shard) index: scatter-gather over shards.

Port of `opensearch_jvector_tpu/parallel/distributed.py`. The corpus is
routed by `doc_id % S` to S shards (a nested child by its parent's id, so
a doc block stays on one shard), each an independent `VectorIndex` in
`shard_{s}/` beside `shards.json`; a sharded directory written by either
package opens in the other. A mesh with one device per shard places shard
s on mesh[s] (its segments, builds, merges and searches all live there);
otherwise every shard lives on `device`. A search runs each shard's own
`VectorIndex.search` on the compute pools' search pool and merges the
[Q, k] lists on the host. There is no stacked mesh engine as in the
reference: a mesh here is devices in one process, and each shard's reader
already runs every tier (scan, beam, on_disk host rerank) where it lives.

The query layer (query/) drives a ShardedVectorIndex as it drives a
VectorIndex: the segment-level surface (`snapshot`, `_pinned_reader`,
`segment_names`) names segments "{shard}::{name}",
and `get_vectors`, `parents_of` and `has_nested` ask every shard. `stats`
is the coordinator's registry (the query layer's counters); calling it
sums every shard's registry with it, as the reference's stats broadcast
does.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig, SearchConfig
from opensearch_jvector_tpu_torch.api.stats import StatsRegistry
from opensearch_jvector_tpu_torch.index.index import (
    VectorIndex,
    _merge_topk,
    resolve_device,
)
from opensearch_jvector_tpu_torch.index.reader import QueryResult
from opensearch_jvector_tpu_torch.index.scheduler import MergePolicy
from opensearch_jvector_tpu_torch.parallel import sharded
from opensearch_jvector_tpu_torch.parallel.pools import ComputePools


class ShardedStats(StatsRegistry):
    """The coordinator's registry; calling it returns the sum of every
    shard's registry and its own (cluster-level stats)."""

    def __init__(self, shard_stats: list[StatsRegistry]):
        super().__init__()
        self.shard_stats = shard_stats

    def __call__(self) -> dict[str, int]:
        return StatsRegistry.aggregate(self.shard_stats + [self])


class ShardedVectorIndex:
    """S independent shards + scatter-gather search."""

    SEG_SEP = "::"

    def __init__(self, root: str | Path, config: DiskAnnConfig | None = None,
                 *, n_shards: int = 2, device: torch.device | str,
                 mesh=None, merge_policy: MergePolicy | None = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.device = resolve_device(device)
        meta_path = self.root / "shards.json"
        if meta_path.exists():
            n_shards = json.loads(meta_path.read_text())["n_shards"]
            config = None  # each shard restores its own
        else:
            if config is None:
                raise ValueError("new sharded index requires a config")
            meta_path.write_text(json.dumps({"n_shards": n_shards}))
        self.n_shards = n_shards
        # shard s lives on mesh[s] where the mesh has one device per shard,
        # else every shard on `device`
        mesh = None if mesh is None else sharded.make_mesh(mesh)
        self.mesh = mesh if mesh is not None and len(mesh) == n_shards else None
        places = self.mesh or [self.device] * n_shards
        self.shard_stats = [StatsRegistry() for _ in range(n_shards)]
        self.shards = [
            VectorIndex(self.root / f"shard_{s}", config, device=places[s],
                        stats=self.shard_stats[s], merge_policy=merge_policy)
            for s in range(n_shards)
        ]
        self.stats = ShardedStats(self.shard_stats)

    @property
    def config(self) -> DiskAnnConfig:
        return self.shards[0].config

    # -- ingest -----------------------------------------------------------

    def _route(self, doc_id: int) -> int:
        return int(doc_id) % self.n_shards

    def add(self, doc_id: int, vector, parent_id: int | None = None) -> None:
        route = parent_id if parent_id is not None else doc_id
        self.shards[self._route(route)].add(doc_id, vector,
                                            parent_id=parent_id)

    def add_batch(self, doc_ids, vectors, parent_ids=None) -> int:
        """Route a block of docs to the shards in one pass."""
        doc_ids = np.asarray(doc_ids, np.int64).reshape(-1)
        vectors = np.asarray(vectors)
        if parent_ids is not None:
            parent_ids = np.asarray(parent_ids, np.int64).reshape(-1)
        route = doc_ids if parent_ids is None else np.where(
            parent_ids >= 0, parent_ids, doc_ids)
        total = 0
        for s in range(self.n_shards):
            sel = (route % self.n_shards) == s
            if sel.any():
                total += self.shards[s].add_batch(
                    doc_ids[sel], vectors[sel],
                    parent_ids=None if parent_ids is None
                    else parent_ids[sel])
        return total

    def delete(self, doc_ids) -> None:
        """Broadcast: a child routed by its parent is not found from its own
        id, and a delete of an absent doc is a no-op."""
        arr = np.atleast_1d(np.asarray(doc_ids, np.int64))
        for shard in self.shards:
            shard.delete(arr)

    def flush(self) -> list[str | None]:
        """Flush every shard (side by side on the search pool)."""
        pool = ComputePools.instance().search_pool
        return list(pool.map(lambda s: s.flush(), self.shards))

    def force_merge(self) -> list[str]:
        pool = ComputePools.instance().search_pool
        return list(pool.map(lambda s: s.force_merge(), self.shards))

    def await_merges(self, timeout: float | None = None) -> None:
        for shard in self.shards:
            shard.await_merges(timeout=timeout)

    def close(self) -> None:
        """Quiesce every shard (VectorIndex.close)."""
        for shard in self.shards:
            shard.close()

    def doc_count(self) -> int:
        return sum(s.doc_count() for s in self.shards)

    def live_doc_ids(self) -> np.ndarray:
        return np.unique(np.concatenate(
            [s.live_doc_ids() for s in self.shards]))

    # -- segment-level surface (the query layer's) ---------------------------

    @property
    def segment_names(self) -> list[str]:
        return [f"{s}{self.SEG_SEP}{n}"
                for s, shard in enumerate(self.shards)
                for n in shard.segment_names]

    def _split(self, combined: str):
        s, name = combined.split(self.SEG_SEP, 1)
        return self.shards[int(s)], name

    def deleted_docs_for(self, combined: str) -> frozenset[int]:
        """One segment's tombstones (`VectorIndex.deleted_docs_for` of its
        shard). The query layer reads segments and tombstones together
        through `snapshot` instead."""
        shard, name = self._split(combined)
        return shard.deleted_docs_for(name)

    def snapshot(self) -> list[tuple[str, frozenset[int]]]:
        """Every shard's segment set with its tombstones (one
        `VectorIndex.snapshot` a shard)."""
        return [(f"{s}{self.SEG_SEP}{n}", dead)
                for s, shard in enumerate(self.shards)
                for n, dead in shard.snapshot()]

    def _pinned_reader(self, combined: str):
        shard, name = self._split(combined)
        return shard._pinned_reader(name)

    @property
    def has_deletes(self) -> bool:
        return any(s.has_deletes for s in self.shards)

    def has_nested(self) -> bool:
        return any(s.has_nested() for s in self.shards)

    def parents_of(self, doc_ids) -> np.ndarray:
        out = np.full(np.shape(doc_ids), -1, np.int64)
        for s in self.shards:
            out = np.where(out < 0, s.parents_of(doc_ids), out)
        return out

    def get_vectors(self, doc_ids) -> tuple[np.ndarray, np.ndarray]:
        """Vectors read back across shards (derived source); broadcast like
        `delete`, each shard filling only the ids it holds."""
        ids = np.asarray(doc_ids, np.int64).reshape(-1)
        vecs = np.zeros((ids.size, self.config.dim), np.float32)
        found = np.zeros(ids.size, bool)
        for shard in self.shards:
            missing = np.flatnonzero(~found)
            if not missing.size:
                break
            v, f = shard.get_vectors(ids[missing])
            vecs[missing[f]] = v[f]
            found[missing[f]] = True
        return vecs, found

    def search(self, queries, sc: SearchConfig,
               accept_docs=None) -> QueryResult:
        """Scatter to every shard (each shard's own search, side by side on
        the search pool) and merge the [Q, k] lists into the top k."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        pool = ComputePools.instance().search_pool
        results = list(pool.map(
            lambda shard: shard.search(queries, sc, accept_docs=accept_docs),
            self.shards))
        ids, scores = _merge_topk([r.doc_ids for r in results],
                                  [r.scores for r in results], sc.k)
        return QueryResult(
            doc_ids=ids, scores=scores,
            visited=sum(r.visited for r in results),
            expanded=sum(r.expanded for r in results),
            reranked=sum(r.reranked for r in results))
