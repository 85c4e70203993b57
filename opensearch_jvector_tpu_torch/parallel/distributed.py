"""Distributed (multi-shard) index: scatter-gather over a device mesh.

Port of `opensearch_jvector_tpu/parallel/distributed.py`. The corpus is
routed by `doc_id % S` to S shards (a nested child by its parent's id, so
a doc block stays on one shard), each an independent `VectorIndex` in
`shard_{s}/` beside `shards.json`; a sharded directory written by either
package opens in the other. A search runs on the mesh when one is attached
with one device per shard (`parallel/sharded.py`: every shard's full
two-phase search where it lives, one merge on mesh[0]); otherwise, and
when the mesh path rejects the segment set (a reason counted per cause),
each shard's own `VectorIndex.search` runs on the compute pools' search
pool and the host merges the [Q, k] lists.

The mesh path takes each shard's segment names and tombstones in one
`VectorIndex.snapshot()` and holds every segment's reader pinned until the
search ends, the on_disk paged rerank included. (The reference reads the
tombstones later than the names, so a merge's swap in between can bring
deleted docs back, and it gathers rows from stores it does not hold.)

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
import threading
import time
from contextlib import ExitStack
from pathlib import Path

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig, SearchConfig
from opensearch_jvector_tpu_torch.api.stats import Counter, StatsRegistry
from opensearch_jvector_tpu_torch.index.index import VectorIndex, resolve_device
from opensearch_jvector_tpu_torch.index.reader import QueryResult
from opensearch_jvector_tpu_torch.index.scheduler import MergePolicy
from opensearch_jvector_tpu_torch.models.searcher import SearchParams
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
    # segments a shard may hold for the mesh path: the state pads every
    # shard to the largest segment count and capacity
    MESH_MAX_SEGMENTS = 4

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
        self.shard_stats = [StatsRegistry() for _ in range(n_shards)]
        self.shards = [
            VectorIndex(self.root / f"shard_{s}", config, device=self.device,
                        stats=self.shard_stats[s], merge_policy=merge_policy)
            for s in range(n_shards)
        ]
        self.stats = ShardedStats(self.shard_stats)
        self.mesh = None
        self._mesh_state = None  # the stacked mesh state and the segment
        self._mesh_segments = None  # names it was stacked from: one pair
        self._mesh_lock = threading.Lock()
        # (shard, segment name) -> synthetic donor-codebook PQVectors of a
        # below-min-batch fp32 segment (homogenize_pq)
        self._synth_pq_cache: dict = {}
        if mesh is not None:
            self.attach_mesh(mesh)

    def attach_mesh(self, mesh) -> None:
        """Place the shards on a device mesh (one device per shard; see
        `sharded.make_mesh`). None detaches it."""
        with self._mesh_lock:
            self.mesh = None if mesh is None else sharded.make_mesh(mesh)
            self._mesh_state = self._mesh_segments = None

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

    # -- mesh path ------------------------------------------------------------

    def _mesh_ready_readers(self, pins: ExitStack):
        """(per-shard pinned readers, per-shard tombstones, None) for the
        mesh path, or (None, None, reject reason). Each shard's names and
        tombstones come from one snapshot; its readers stay pinned in
        `pins`. A shard over the segment cap gets a background compaction,
        so the index comes back to the mesh path."""
        readers, deletes, reject = [], [], None
        for shard in self.shards:
            snap = shard.snapshot()
            if not snap:
                reject = reject or Counter.KNN_MESH_REJECT_EMPTY_SHARD
                continue
            if len(snap) > self.MESH_MAX_SEGMENTS:
                # every over-cap shard gets its compaction on this pass
                shard.compact_to(self.MESH_MAX_SEGMENTS)
                reject = reject or Counter.KNN_MESH_REJECT_SEGMENT_COUNT
                continue
            if shard.writer.num_buffered():
                reject = reject or Counter.KNN_MESH_REJECT_BUFFERED_DOCS
                continue
            readers.append([pins.enter_context(shard._pinned_reader(n))
                            for n, _ in snap])
            deletes.append([dead for _, dead in snap])
        if reject is not None:
            return None, None, reject
        return readers, deletes, None

    def _restacked(self, segs) -> sharded.ShardedEngineState | None:
        """The mesh state for these per-shard segment lists, restacked
        where the names changed (counted per shard registry); None (and a
        reject counted) when they do not stack."""
        names = [[s.name for s in lst] for lst in segs]
        with self._mesh_lock:
            if self._mesh_state is not None and self._mesh_segments == names:
                return self._mesh_state
            t0 = time.monotonic()
            try:
                state, rebuilt = sharded.restack_engine_state(
                    self._mesh_state, self._mesh_segments, segs, names,
                    self.mesh)
            except ValueError:  # mixed quantization, flat shards
                self.stats.increment(Counter.KNN_MESH_REJECT_STACK_SHAPE)
                return None
            self._mesh_state, self._mesh_segments = state, names
            dt = time.monotonic() - t0
            for reg in self.shard_stats:
                reg.increment(Counter.KNN_MESH_RESTACK_COUNT)
                if rebuilt < self.n_shards:
                    reg.increment(Counter.KNN_MESH_RESTACK_PARTIAL_COUNT)
                reg.add_seconds(Counter.KNN_MESH_RESTACK_TIME, dt)
            return state

    def _accept(self, state, readers, deletes, accept_docs):
        """Per shard, the [G, n] ordinal accept masks (filter and the
        snapshot's tombstones, from each reader's cached device masks), or
        None where neither applies."""
        if accept_docs is None and not any(d for ds in deletes for d in ds):
            return None
        out = []
        for s, (rs, ds) in enumerate(zip(readers, deletes)):
            rows = []
            for reader, dead in zip(rs, ds):
                m = reader._accept(accept_docs, dead)
                if m is None:
                    m = reader._live_valid()
                rows.append(sharded.fit_rows(m.to(self.mesh[s]),
                                             state.n_local, False))
            rows += [rows[0].new_zeros(rows[0].shape)] * (
                state.n_segments - len(rows))
            out.append(torch.stack(rows))
        return out

    def _count(self, counters: np.ndarray, qn: int, filtered: bool,
               reranked: np.ndarray, seconds: float) -> None:
        for s, reg in enumerate(self.shard_stats):
            reg.increment(Counter.KNN_QUERY_COUNT, qn)
            if filtered:
                reg.increment(Counter.KNN_QUERY_WITH_FILTER_COUNT, qn)
            reg.increment(Counter.KNN_QUERY_VISITED_NODES, int(counters[s, 0]))
            reg.increment(Counter.KNN_QUERY_EXPANDED_NODES,
                          int(counters[s, 1]))
            reg.increment(Counter.KNN_QUERY_EXPANDED_BASE_LAYER_NODES,
                          int(counters[s, 1]))
            reg.increment(Counter.KNN_QUERY_RERANKED_COUNT, int(reranked[s]))
            reg.add_seconds(Counter.KNN_GRAPH_SEARCH_TIME, seconds)

    def _search_on_mesh(self, queries: np.ndarray, sc: SearchConfig,
                        accept_docs) -> QueryResult | None:
        """The full-engine mesh search; None where it does not apply."""
        if self.mesh is None or len(self.mesh) != self.n_shards:
            return None
        with ExitStack() as pins:
            readers, deletes, reject = self._mesh_ready_readers(pins)
            if readers is None:
                self.stats.increment(reject)
                return None
            segs = sharded.homogenize_pq(
                [[r.seg for r in rs] for rs in readers],
                self.config.similarity, cache=self._synth_pq_cache)
            live = {(s, seg.name) for s, lst in enumerate(segs) for seg in lst}
            for stale in set(self._synth_pq_cache) - live:
                self._synth_pq_cache.pop(stale, None)  # merged away
            state = self._restacked(segs)
            if state is None:
                return None
            accept = self._accept(state, readers, deletes, accept_docs)
            params = SearchParams(
                k=sc.k, ef_search=sc.resolved_ef(),
                overquery_factor=sc.overquery_factor,
                threshold=sc.threshold, rerank_floor=sc.rerank_floor)
            q = torch.from_numpy(queries)
            t0 = time.monotonic()
            if state.approx_only:
                docs, scores, counters, reranked = self._mesh_approx_search(
                    state, segs, q, params, accept)
            else:
                docs, scores, counters = sharded.sharded_engine_search(
                    self.mesh, state, q, params, self.config.similarity,
                    accept=accept)
                docs, scores, counters = (t.cpu().numpy() for t in
                                          (docs, scores, counters))
                reranked = counters[:, 2]
            dt = time.monotonic() - t0
        self._count(counters, queries.shape[0], accept_docs is not None,
                    reranked, dt)
        return QueryResult(
            doc_ids=docs.astype(np.int64), scores=scores.astype(np.float32),
            visited=int(counters[:, 0].sum()),
            expanded=int(counters[:, 1].sum()),
            reranked=int(np.sum(reranked)))

    def _mesh_approx_search(self, state, segs, q, params, accept):
        """on_disk mesh search: the PQ beam on the mesh, the candidates'
        fp32 rows paged from each (pinned) segment's row store, one exact
        rerank pass on mesh[0]. -> host (docs, scores, counters [D, 3],
        rows reranked per shard)."""
        docs, locs, _, counters = sharded.sharded_engine_search_approx(
            self.mesh, state, q, params, self.config.similarity,
            accept=accept)
        docs, locs, counters = (t.cpu().numpy() for t in
                                (docs, locs, counters))
        qn, r = docs.shape
        g_n, n = state.n_segments, state.n_local
        cand = np.zeros((qn, r, self.config.dim), np.float32)
        valid = locs >= 0
        reranked = np.zeros(self.n_shards, np.int64)
        flat = locs[valid]
        seg_ids, ords = flat // n, flat % n  # seg_id = shard * G + slot
        rows = np.zeros((flat.size, self.config.dim), np.float32)
        uniq = np.unique(seg_ids)
        for sid in uniq:  # start every store's readahead first
            store = segs[sid // g_n][sid % g_n].row_store
            if store is not None:
                store.prefetch(ords[seg_ids == sid])
        for sid in uniq:
            seg = segs[sid // g_n][sid % g_n]
            m = seg_ids == sid
            if seg.row_store is not None:
                rows[m] = seg.row_store.gather(ords[m])
            else:  # a below-min-batch flush keeps its fp32 rows on the card
                rows[m] = seg.vectors[torch.as_tensor(
                    ords[m], device=seg.device)].cpu().numpy()
            reranked[sid // g_n] += int(m.sum())
        cand[valid] = rows
        dev = self.mesh[0]
        top_d, top_s, _ = sharded.paged_rerank(
            q.to(dev), torch.from_numpy(cand).to(dev),
            torch.from_numpy(docs).to(dev), params.k, params.threshold,
            self.config.similarity)
        return top_d.cpu().numpy(), top_s.cpu().numpy(), counters, reranked

    def search(self, queries, sc: SearchConfig,
               accept_docs=None) -> QueryResult:
        """Scatter to every shard and merge the top-k: on the mesh where it
        applies, else each shard's own search on the search pool."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        res = self._search_on_mesh(queries, sc, accept_docs)
        if res is not None:
            return res
        pool = ComputePools.instance().search_pool
        results = list(pool.map(
            lambda shard: shard.search(queries, sc, accept_docs=accept_docs),
            self.shards))
        all_ids = np.concatenate([r.doc_ids for r in results], axis=1)
        all_scores = np.concatenate([r.scores for r in results], axis=1)
        order = np.argsort(-all_scores, axis=1, kind="stable")[:, : sc.k]
        return QueryResult(
            doc_ids=np.take_along_axis(all_ids, order, axis=1),
            scores=np.take_along_axis(all_scores, order, axis=1),
            visited=sum(r.visited for r in results),
            expanded=sum(r.expanded for r in results),
            reranked=sum(r.reranked for r in results))
