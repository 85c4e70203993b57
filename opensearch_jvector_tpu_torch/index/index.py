"""VectorIndex: the multi-segment index facade (one "shard").

Port of `opensearch_jvector_tpu/index/index.py`: buffered ingest,
flush-to-segment, deletes as tombstones scoped to the segments that hold
the doc, cross-segment search with a global top-k merge, background merges
picked by a merge policy after every flush (`TieredMergePolicy` by default;
`ForceMergesOnlyMergePolicy` pins merge timing for tests and benchmarks),
`force_merge`, and the commit model (`commits.json` lists the live segment
set and the per-segment tombstones, so a crash between flushes rolls back
to the last committed set). An index directory written by either package
opens in the other.

Segments of either mode (in_memory, on_disk) are searched in a plain loop
over a snapshot of the segment set and its tombstones, so a search that
races a merge's swap answers from the set it started with. The readers own
the on_disk segments' host row stores: a reader that a merge swaps out (or
`close()` drops) is closed only once no search holds it. `has_nested`,
`parents_of` and `get_vectors` wait (ROADMAP queue 1, "Query and
serving").
"""

from __future__ import annotations

import dataclasses
import json
import threading
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig, SearchConfig
from opensearch_jvector_tpu_torch.api.stats import STATS, StatsRegistry
from opensearch_jvector_tpu_torch.index import store
from opensearch_jvector_tpu_torch.index.docmap import DocMap
from opensearch_jvector_tpu_torch.index.merge import merge_segments
from opensearch_jvector_tpu_torch.index.reader import QueryResult, SegmentReader
from opensearch_jvector_tpu_torch.index.scheduler import (
    MergePolicy,
    MergeScheduler,
    TieredMergePolicy,
)
from opensearch_jvector_tpu_torch.index.segment import Segment, read_segment
from opensearch_jvector_tpu_torch.index.writer import IndexWriter


def resolve_device(device: torch.device | str) -> torch.device:
    """The index's device; a CUDA device that is absent is an error."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


class VectorIndex:
    def __init__(
        self,
        root: str | Path,
        config: DiskAnnConfig | None = None,
        *,
        device: torch.device | str,
        stats: StatsRegistry = STATS,
        merge_policy: MergePolicy | None = None,
    ):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.device = resolve_device(device)
        self.stats = stats
        commits = self.root / "commits.json"
        if commits.exists():
            state = json.loads(commits.read_text())
            self.config = DiskAnnConfig.from_meta(state["config"])
            self._segments = list(state["segments"])
            # deletes are SCOPED to the segments that existed when delete()
            # was called (Lucene liveDocs semantics): a later re-add of the
            # same doc id lands in a new segment and is NOT masked
            self._segment_deletes: dict[str, set[int]] = {
                name: set(docs)
                for name, docs in state.get("segment_deletes", {}).items()
            }
            for d in state.get("deleted_docs", []):  # legacy global set
                for name in self._segments:
                    self._segment_deletes.setdefault(name, set()).add(int(d))
        else:
            if config is None:
                raise ValueError("new index requires a config")
            self.config = config
            self._segments = []
            self._segment_deletes = {}
        self.writer = IndexWriter(self.root, self.config, self.device, stats)
        self._readers: dict[str, SegmentReader] = {}
        # readers in use by a search (reader -> users) and readers dropped
        # from `_readers` while in use: closed by their last user
        self._pins: dict[SegmentReader, int] = {}
        self._retired: set[SegmentReader] = set()
        # TieredMergePolicy is the production default, as in the reference;
        # ForceMergesOnlyMergePolicy is the test/bench override
        self.merge_policy = merge_policy or TieredMergePolicy()
        self.merge_scheduler = MergeScheduler()
        self._lock = threading.RLock()  # guards _segments/_segment_deletes
        self._merging: set[str] = set()  # segments owned by in-flight merges
        # deletes arriving while a flush has already snapshotted the buffer
        # (set by flush(), consumed at its commit)
        self._flush_pending: set[int] | None = None
        self._flush_serial = threading.Lock()  # one flush at a time
        self._docmap_cache: dict[str, np.ndarray] = {}  # name -> ord_to_doc
        # immutable per-segment tombstone snapshots handed to searches,
        # rebuilt after the set changes
        self._deletes_frozen: dict[str, frozenset[int]] = {}
        # merge output names must stay unique when the index is reopened:
        # reusing a committed merge name would overwrite that segment's
        # files in place
        counter = 0
        for p in self.root.glob("merged_*"):
            tail = p.name.rsplit("_m", 1)
            if len(tail) == 2 and tail[1].isdigit():
                counter = max(counter, int(tail[1]))
        self._merge_counter = counter
        # with `time_merge_stages`, every merge waits for the device after
        # each of its stages and leaves their seconds in
        # `last_merge_timings`
        self.time_merge_stages = False
        self.last_merge_timings: dict[str, float] | None = None
        self._closed = False

    def close(self) -> None:
        """Quiesce the index: refuse new flushes and merges, join in-flight
        work, and release the open segments' host row stores (a later
        search reopens them).

        Deletion paths MUST call this before removing storage: an in-flight
        background merge or flush would otherwise recreate the removed
        directory."""
        self._closed = True
        with self._flush_serial:  # barrier: an in-flight flush completes
            pass
        self.merge_scheduler.await_all()
        with self._lock:
            self._retire(list(self._readers))

    # -- commit model --------------------------------------------------------

    def _commit(self) -> None:
        tmp = self.root / "commits.json.tmp"
        tmp.write_text(json.dumps({
            "config": self.config.to_meta(),
            "segments": self._segments,
            "segment_deletes": {
                name: sorted(docs)
                for name, docs in self._segment_deletes.items() if docs
            },
        }))
        tmp.rename(self.root / "commits.json")

    @property
    def segment_names(self) -> list[str]:
        with self._lock:
            return list(self._segments)

    def _segment_docs(self, name: str) -> np.ndarray:
        """ord_to_doc of a segment WITHOUT loading its tensors (delete-time
        membership and merge sizing need only the docmap). Cached per name:
        segments are immutable until a merge drops them."""
        r = self._readers.get(name)
        if r is not None:
            return r.seg.docmap.ord_to_doc
        cached = self._docmap_cache.get(name)
        if cached is None:
            _, darr = store.read_container(
                self.root / name / "docmap.jvtpu", verify=False)
            cached = self._docmap_cache[name] = darr["ord_to_doc"]
        return cached

    def _tombstone(self, name: str, docs) -> None:
        """Add doc ids to segment `name`'s tombstones (under the lock)."""
        self._segment_deletes.setdefault(name, set()).update(
            int(d) for d in docs)
        self._deletes_frozen.pop(name, None)

    def deleted_docs_for(self, name: str) -> frozenset[int]:
        """Tombstoned doc ids scoped to segment `name`: an immutable
        snapshot, shared between searches until the set changes."""
        with self._lock:
            frozen = self._deletes_frozen.get(name)
            if frozen is None:
                frozen = self._deletes_frozen[name] = frozenset(
                    self._segment_deletes.get(name, ()))
            return frozen

    @property
    def has_deletes(self) -> bool:
        with self._lock:
            return any(self._segment_deletes.values())

    # -- ingest --------------------------------------------------------------

    def add(self, doc_id: int, vector, parent_id: int | None = None) -> None:
        self.writer.add_document(doc_id, vector, parent_id=parent_id)

    def add_batch(self, doc_ids, vectors, parent_ids=None) -> int:
        """Bulk ingest of a block of (doc_id, vector) rows."""
        return self.writer.add_batch(doc_ids, vectors, parent_ids=parent_ids)

    def delete(self, doc_ids) -> None:
        """Tombstone docs in the segments that currently contain them
        (Lucene deleteDocuments semantics: buffered copies are dropped, a
        LATER re-add of the same doc id is a fresh live doc). Folded into
        the graphs at the next merge."""
        arr = np.atleast_1d(np.asarray(doc_ids, np.int64))
        with self._lock:
            self.writer.delete_buffered(arr)
            if self._flush_pending is not None:
                # an in-flight flush already snapshotted the buffer: its
                # segment must mask these docs once it commits
                self._flush_pending.update(int(d) for d in arr)
            for name in self._segments:
                present = arr[np.isin(arr, self._segment_docs(name))]
                if present.size:
                    self._tombstone(name, present)
            self._commit()

    def flush(self, sort_map=None) -> str | None:
        """Write the buffered docs as a new segment, commit it, and let the
        merge policy schedule a background merge.

        A doc id flushed again supersedes its copies in earlier segments
        (they are tombstoned, as Lucene's updateDocument does)."""
        if self._closed:
            raise RuntimeError("index is closed")
        # one flush at a time: a second concurrent flush would replace
        # _flush_pending and lose deletes raced against the first
        with self._flush_serial:
            with self._lock:
                pending: set[int] = set()
                self._flush_pending = pending
            try:
                path = self.writer.flush(sort_map=sort_map)
            except BaseException:
                with self._lock:
                    self._flush_pending = None
                raise
            # _flush_pending stays armed until the SAME lock block that
            # appends the segment: a delete() in between either lands in
            # `pending` (resolved below) or sees the committed segment
            with self._lock:
                self._flush_pending = None
                if path is None:
                    return None
                self._segments.append(path.name)
                new_docs = self._segment_docs(path.name)
                if pending:
                    # deletes that raced this flush AFTER its buffer
                    # snapshot: scope them to the new segment
                    arr = np.fromiter(pending, np.int64)
                    if sort_map is not None:
                        # callers delete by PRE-sort id; the new segment's
                        # docmap holds post-sort ids (ids beyond the map
                        # cannot be in this flush)
                        smap = np.asarray(sort_map)
                        arr = smap[arr[(arr >= 0) & (arr < smap.shape[0])]]
                    present = arr[np.isin(arr, new_docs)]
                    if present.size:
                        self._tombstone(path.name, present)
                # update semantics ACROSS segments: the flushed copy
                # supersedes committed copies, so tombstone the new
                # segment's doc ids wherever a PRIOR segment holds them
                new_docs = new_docs[new_docs >= 0]
                for prior in self._segments[:-1]:
                    stale = new_docs[np.isin(new_docs,
                                             self._segment_docs(prior))]
                    if stale.size:
                        self._tombstone(prior, stale)
                self._commit()
        self.maybe_merge()
        return path.name

    # -- background merge ------------------------------------------------------

    def _live_sizes(self, names: list[str]) -> list[tuple[str, int]]:
        """(name, live docs) from the docmaps and tombstone sets alone:
        sizing must not load a segment. Folded docs are -1 in the docmap;
        un-folded tombstones are subtracted."""
        return [(n, max(0, int((self._segment_docs(n) >= 0).sum())
                        - len(self._segment_deletes.get(n, ()))))
                for n in names]

    def maybe_merge(self):
        """Consult the merge policy; schedule a background merge if it
        selects segments. Returns the Future or None. The merge runs on the
        niced merge pool, concurrent with further ingest and search."""
        if self._closed or not getattr(self.merge_policy, "auto", True):
            return None  # ForceMergesOnly: skip segment sizing entirely
        with self._lock:
            free = [n for n in self._segments if n not in self._merging]
            pick = self.merge_policy.select(self._live_sizes(free))
            if not pick:
                return None
            self._merging.update(pick)  # one owner per segment
        return self.merge_scheduler.submit(self._merge_owned, pick)

    def compact_to(self, max_segments: int):
        """Schedule a background merge of the smallest segments so the
        committed set shrinks to <= max_segments (a steady trickle of
        flushes never forms the same-size run the tiered policy waits
        for). Respects ForceMergesOnlyMergePolicy. Returns the Future or
        None."""
        if self._closed or max_segments < 1:
            return None
        if not getattr(self.merge_policy, "auto", True):
            return None
        with self._lock:
            if len(self._segments) <= max_segments:
                return None
            free = [n for n in self._segments if n not in self._merging]
            if len(free) < 2:
                return None  # a merge already in flight will shrink the set
            excess = len(self._segments) - max_segments
            sizes = sorted(
                ((n, int((self._segment_docs(n) >= 0).sum())) for n in free),
                key=lambda t: t[1])
            # merging (excess + 1) segments into one nets -excess
            pick = [n for n, _ in sizes[: excess + 1]]
            if len(pick) < 2:
                return None
            self._merging.update(pick)
        return self.merge_scheduler.submit(self._merge_owned, pick)

    def _merge_owned(self, names: list[str],
                     out_name: str | None = None) -> str:
        """Merge segments this caller put into `_merging`, then give them
        up."""
        try:
            return self._merge_now(names, out_name)
        finally:
            with self._lock:
                self._merging.difference_update(names)

    def await_merges(self, timeout: float | None = None) -> None:
        """Join in-flight background merges and re-raise their failures
        (`timeout` seconds per merge)."""
        self.merge_scheduler.await_all(timeout=timeout)

    # -- counts ---------------------------------------------------------------

    def _live_docs(self) -> list[np.ndarray]:
        """Per segment, the live doc ids from the cached docmaps and the
        tombstone sets (no segment load). Folded docs are -1 in the docmap
        and written with live=False, so `docs >= 0` is the stored live
        set."""
        out = []
        for name in self.segment_names:
            docs = self._segment_docs(name)
            ok = docs >= 0
            dead = self.deleted_docs_for(name)
            if dead:
                ok &= ~np.isin(docs, np.fromiter(dead, np.int64))
            out.append(docs[ok])
        return out

    def doc_count(self) -> int:
        """Live doc count; never loads a segment's tensors."""
        return sum(int(d.size) for d in self._live_docs())

    def live_doc_ids(self) -> np.ndarray:
        """Live doc ids, sorted and unique (same source as doc_count)."""
        out = self._live_docs()
        if not out:
            return np.empty(0, np.int64)
        return np.unique(np.concatenate(out))

    # -- search ---------------------------------------------------------------

    def _reader(self, name: str) -> SegmentReader:
        """The open reader of a committed segment (kept until a merge or
        `close()` drops it). Searches go through `_pinned_reader`."""
        with self._pinned_reader(name) as reader:
            return reader

    def _retire(self, names: list[str]) -> None:
        """Drop the readers of `names` (under the lock): closed now, or by
        the last search still inside them."""
        for n in names:
            reader = self._readers.pop(n, None)
            if reader is None:
                continue
            if reader in self._pins:
                self._retired.add(reader)
            else:
                reader.close()

    @contextmanager
    def _pinned_reader(self, name: str):
        """A segment's reader, kept open for the length of the block: a
        merge's swap or `close()` may drop it from the index meanwhile, and
        closing its host row store under a running search would be a use
        after free."""
        with self._lock:
            reader = self._readers.get(name)
            if reader is not None:
                self._pins[reader] = self._pins.get(reader, 0) + 1
        if reader is None:
            # load outside the lock: it can take seconds
            opened = SegmentReader.open(self.root / name, self.device,
                                        stats=self.stats)
            with self._lock:
                reader = self._readers.get(name)
                if reader is not None:  # another thread opened it meanwhile
                    opened.close()
                else:
                    reader = opened
                    if name in self._segments:
                        self._readers[name] = reader
                    else:  # merged away since the caller's snapshot
                        self._retired.add(reader)
                self._pins[reader] = self._pins.get(reader, 0) + 1
        try:
            yield reader
        finally:
            with self._lock:
                left = self._pins.pop(reader) - 1
                if left:
                    self._pins[reader] = left
                last = not left and reader in self._retired
                if last:
                    self._retired.discard(reader)
            if last:
                reader.close()

    def search(self, queries, sc: SearchConfig,
               accept_docs=None) -> QueryResult:
        """Search every segment, then merge into the global top-k."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        qn = queries.shape[0]
        ids, scores = [], []
        visited = expanded = reranked = 0
        # one snapshot of the segment set and its tombstones: merges swap
        # both underneath, and tombstones ride the accept mask INTO the
        # search so dead docs never consume the k result slots
        with self._lock:
            snapshot = [(n, self.deleted_docs_for(n)) for n in self._segments]
        for name, deleted in snapshot:
            with self._pinned_reader(name) as reader:
                res = reader.search(queries, sc, accept_docs=accept_docs,
                                    deleted_docs=deleted)
            ids.append(res.doc_ids)
            scores.append(res.scores)
            visited += res.visited
            expanded += res.expanded
            reranked += res.reranked
        if not ids:
            return QueryResult(
                doc_ids=np.full((qn, sc.k), -1, np.int64),
                scores=np.full((qn, sc.k), -np.inf, np.float32),
                visited=0, expanded=0, reranked=0,
            )
        all_ids = np.concatenate(ids, axis=1)
        all_scores = np.concatenate(scores, axis=1)
        order = np.argsort(-all_scores, axis=1, kind="stable")[:, : sc.k]
        top_ids = np.take_along_axis(all_ids, order, axis=1)
        top_scores = np.take_along_axis(all_scores, order, axis=1)
        if top_ids.shape[1] < sc.k:
            pad = sc.k - top_ids.shape[1]
            top_ids = np.pad(top_ids, ((0, 0), (0, pad)), constant_values=-1)
            top_scores = np.pad(top_scores, ((0, 0), (0, pad)),
                                constant_values=-np.inf)
        return QueryResult(doc_ids=top_ids, scores=top_scores,
                           visited=visited, expanded=expanded,
                           reranked=reranked)


    # -- merge ----------------------------------------------------------------

    @staticmethod
    def _fold_tombstones(seg: Segment, deleted: np.ndarray):
        """Apply doc tombstones to a loaded segment's live mask + docmap.

        Returns (segment, folded_doc_ids). The nested-parent map is kept
        (dropping it would silently un-nest the index)."""
        dead_ords = seg.docmap.mark_deleted_docs(deleted)
        if not dead_ords.size:
            return seg, np.empty(0, np.int64)
        folded = seg.docmap.ord_to_doc[dead_ords].copy()
        live = seg.graph.live.clone()
        live[torch.as_tensor(dead_ords, device=live.device)] = False
        docs = seg.docmap.ord_to_doc.copy()
        docs[dead_ords] = -1
        parents = seg.docmap.ord_to_parent
        if parents is not None:
            parents = parents.copy()
            parents[dead_ords] = -1
        return dataclasses.replace(
            seg, graph=dataclasses.replace(seg.graph, live=live),
            docmap=DocMap(docs, parents)), folded

    def _merge_now(self, names: list[str], out_name: str | None = None) -> str:
        """Merge `names` into one segment (on the caller or the merge pool).

        Works on a snapshot: searches keep serving the old segment set
        until the atomic swap at the end. Tombstones of the snapshot are
        folded into the output and cleared; deletes arriving mid-merge
        migrate onto the output, where they keep masking until the next
        merge."""
        with self._lock:
            per_seg = {
                n: np.fromiter(self._segment_deletes.get(n, ()), np.int64)
                for n in names
            }
            if out_name is None:
                self._merge_counter += 1
                out_name = f"merged_{len(names)}segs_m{self._merge_counter}"
        if (self.root / out_name).exists():
            # never write a merge into ANY existing directory: in-place
            # container writes would corrupt a committed segment (a merge
            # input included) if the merge crashed midway
            raise ValueError(
                f"merge output name {out_name!r} collides with an existing "
                "segment directory")
        segs = []
        timings = {} if self.time_merge_stages else None
        try:
            for name in names:
                seg = read_segment(self.root / name, self.device)
                segs.append(seg)
                if per_seg[name].size:
                    segs[-1], _ = self._fold_tombstones(seg, per_seg[name])
            path = merge_segments(
                self.root, segs, out_name, stats=self.stats,
                quantized_build_min_capacity=(
                    self.writer.quantized_build_min_capacity),
                timings=timings)
        finally:
            for seg in segs:  # the merge's own row stores, not the readers'
                if seg.row_store is not None:
                    seg.row_store.close()
        with self._lock:
            idx = self._segments.index(names[0])
            kept = [n for n in self._segments if n not in names]
            kept.insert(min(idx, len(kept)), path.name)
            self._segments = kept
            leftover: set[int] = set()
            for n in names:
                remaining = self._segment_deletes.pop(n, set())
                leftover |= remaining - set(per_seg[n].tolist())
                self._deletes_frozen.pop(n, None)
                self._docmap_cache.pop(n, None)
            if leftover:
                self._tombstone(path.name, leftover)
            self._retire(names)
            self.last_merge_timings = timings
            self._commit()
        return path.name

    def force_merge(self, out_name: str | None = None) -> str:
        """Merge ALL segments into one (deterministic, test-friendly).

        Owns its segments via `_merging` like background merges do, so a
        flush-triggered merge cannot grab the same set. The default output
        name is counter-unique (a fixed name would be reused by successive
        force_merges and overwrite a committed segment's files in place)."""
        if self._closed:
            raise RuntimeError("index is closed")
        self.await_merges()
        with self._lock:
            names = [n for n in self._segments if n not in self._merging]
            assert names, "nothing to merge"
            self._merging.update(names)
        return self._merge_owned(names, out_name)
