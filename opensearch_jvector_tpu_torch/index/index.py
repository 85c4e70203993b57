"""VectorIndex: the multi-segment index facade (one "shard").

Port of `opensearch_jvector_tpu/index/index.py` for the ingest and search
path: buffered ingest, flush-to-segment, cross-segment search with a global
top-k merge, and the commit model (`commits.json` lists the live segment
set and the per-segment tombstones). An index directory written by either
package opens in the other.

Segments of either mode (in_memory, on_disk) are searched in a plain
loop; the readers own the on_disk segments' host row stores and `close()`
releases them. Deletes, merges and the merge
scheduler wait (ROADMAP queue 1 item 8); tombstones already committed by
the reference are honoured at search time and kept on commit.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig, SearchConfig
from opensearch_jvector_tpu_torch.api.stats import STATS, StatsRegistry
from opensearch_jvector_tpu_torch.index import store
from opensearch_jvector_tpu_torch.index.reader import QueryResult, SegmentReader
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
        self._lock = threading.RLock()  # guards _segments/_segment_deletes
        self._flush_serial = threading.Lock()  # one flush at a time
        self._closed = False

    def close(self) -> None:
        """Refuse new flushes, wait for an in-flight one, and release the
        open segments' host row stores (a later search reopens them)."""
        self._closed = True
        with self._flush_serial:
            pass
        with self._lock:
            readers, self._readers = self._readers, {}
        for reader in readers.values():
            reader.close()

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
        """ord_to_doc of a segment without loading its tensors."""
        r = self._readers.get(name)
        if r is not None:
            return r.seg.docmap.ord_to_doc
        _, darr = store.read_container(self.root / name / "docmap.jvtpu",
                                       verify=False)
        return darr["ord_to_doc"]

    def deleted_docs_for(self, name: str) -> set[int]:
        with self._lock:
            return set(self._segment_deletes.get(name, ()))

    # -- ingest --------------------------------------------------------------

    def add(self, doc_id: int, vector, parent_id: int | None = None) -> None:
        self.writer.add_document(doc_id, vector, parent_id=parent_id)

    def add_batch(self, doc_ids, vectors, parent_ids=None) -> int:
        """Bulk ingest of a block of (doc_id, vector) rows."""
        return self.writer.add_batch(doc_ids, vectors, parent_ids=parent_ids)

    def flush(self, sort_map=None) -> str | None:
        """Write the buffered docs as a new segment and commit it.

        A doc id flushed again supersedes its copies in earlier segments
        (they are tombstoned, as Lucene's updateDocument does)."""
        if self._closed:
            raise RuntimeError("index is closed")
        with self._flush_serial:
            path = self.writer.flush(sort_map=sort_map)
            if path is None:
                return None
            with self._lock:
                self._segments.append(path.name)
                new_docs = self._segment_docs(path.name)
                new_docs = new_docs[new_docs >= 0]
                for prior in self._segments[:-1]:
                    stale = new_docs[np.isin(new_docs,
                                             self._segment_docs(prior))]
                    if stale.size:
                        self._segment_deletes.setdefault(prior, set()).update(
                            int(d) for d in stale)
                self._commit()
        return path.name

    # -- search ---------------------------------------------------------------

    def _reader(self, name: str) -> SegmentReader:
        if name not in self._readers:
            self._readers[name] = SegmentReader.open(
                self.root / name, self.device, stats=self.stats)
        return self._readers[name]

    def search(self, queries, sc: SearchConfig,
               accept_docs=None) -> QueryResult:
        """Search every segment, then merge into the global top-k."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        qn = queries.shape[0]
        ids, scores = [], []
        visited = expanded = reranked = 0
        for name in self.segment_names:
            res = self._reader(name).search(
                queries, sc, accept_docs=accept_docs,
                deleted_docs=self.deleted_docs_for(name))
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
