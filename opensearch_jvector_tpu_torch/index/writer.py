"""Index writer: buffer -> quantize -> graph build -> segment flush.

Port of the flush of `opensearch_jvector_tpu/index/writer.py`:
  * buffers (docId, float vector) blocks; byte vectors are rejected
  * below `min_batch_size_for_quantization` builds fp32 only; otherwise
    trains PQ and encodes (`_quantize_for_flush`), then builds the Vamana
    graph over the fp32 rows
  * `index_type: flat` builds no graph and keeps the corpus on the host:
    PQ trains on a host sample and the encode streams host chunks
  * in_memory segments keep their fp32 rows on the device for the rerank;
    on_disk PQ segments write them to the raw row file (`rows.f32`), and a
    vamana on_disk flush scores its build's beam candidates from the
    decoded-PQ cache (prunes stay exact fp32)
  * writes the segment with versioned, checksummed containers

Pure quantized construction (on_disk graph flushes of capacity >=
`quantized_build_min_capacity`), NVQ, scalar quantization and the
hierarchy layer are not ported yet and raise NotImplementedError naming
their ROADMAP item by its title. The reference's device-resident row
provider (`flush(device_rows=...)`) is not ported either.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import (
    QUANT_NONE,
    QUANT_PQ,
    DiskAnnConfig,
    ValidationError,
)
from opensearch_jvector_tpu_torch.api.stats import STATS, Counter, StatsRegistry
from opensearch_jvector_tpu_torch.index.docmap import DocMap
from opensearch_jvector_tpu_torch.index.segment import (
    OTHER_QUANTIZERS,
    Segment,
    write_segment,
)
from opensearch_jvector_tpu_torch.models import pq as pq_mod
from opensearch_jvector_tpu_torch.models.builder import GraphIndexBuilder
from opensearch_jvector_tpu_torch.models.graph import (
    VamanaGraph,
    bucket_capacity,
    pad_rows,
)
from opensearch_jvector_tpu_torch.utils.circuit_breaker import BREAKER
from opensearch_jvector_tpu_torch.utils.profiling import phase


def check_config_ported(cfg: DiskAnnConfig) -> None:
    """Raise NotImplementedError for configurations the port lacks."""
    if cfg.quantization_type not in (QUANT_NONE, QUANT_PQ):
        raise NotImplementedError(
            f"{cfg.quantization_type} quantization is not ported yet "
            f"({OTHER_QUANTIZERS})")
    if cfg.pq_anisotropic_threshold:
        raise NotImplementedError(
            f"anisotropic PQ is not ported yet ({OTHER_QUANTIZERS})")
    if cfg.hierarchy_enabled:
        raise NotImplementedError(
            f"the hierarchy layer is not ported yet ({OTHER_QUANTIZERS})")


# on_disk PQ graph segments at or above this pow2 capacity take the
# reference's pure quantized construction (no fp32 rows on the device),
# which is not ported
QUANTIZED_BUILD_MIN_CAPACITY = 1 << 22


def check_quantized_build_gate(cfg: DiskAnnConfig, n: int, cap: int,
                               gate: int, what: str) -> None:
    """Raise NotImplementedError where an on_disk PQ graph segment of `n`
    rows and capacity `cap` would need the quantized build."""
    if (cfg.mode == "on_disk" and cfg.index_type != "flat"
            and cfg.quantization_type == QUANT_PQ
            and n >= cfg.min_batch_size_for_quantization and cap >= gate):
        raise NotImplementedError(
            f"an on_disk graph {what} of capacity {cap} (>= {gate}) takes "
            "the quantized build, which is not ported yet (ROADMAP queue 1, "
            '"on_disk remnants: the quantized build"; the reference\'s '
            "quantized build writes a dead-entry graph for non-pow2 "
            "flushes, ROADMAP queue 3)")


class IndexWriter:
    def __init__(
        self,
        root: str | Path,
        config: DiskAnnConfig,
        device: torch.device | str,
        stats: StatsRegistry = STATS,
    ):
        check_config_ported(config)
        self.quantized_build_min_capacity = QUANTIZED_BUILD_MIN_CAPACITY
        self.root = Path(root)
        self.config = config
        self.device = torch.device(device)
        self.stats = stats
        self._blocks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._buffered = 0
        self._buf_lock = threading.Lock()
        # resume the counter past existing segments: a reopened index must
        # never reuse a segment name
        counter = -1
        for p in self.root.glob("seg_*"):
            parts = p.name.split("_")
            if len(parts) >= 2 and parts[1].isdigit():
                counter = max(counter, int(parts[1]))
        self._flush_counter = counter + 1

    def add_document(self, doc_id: int, vector,
                     parent_id: int | None = None) -> None:
        """Buffer one document's vector (float only, dim-checked)."""
        v = np.asarray(vector)
        if v.shape != (self.config.dim,):
            raise ValueError(
                f"vector shape {v.shape} != (dim={self.config.dim},)")
        self.add_batch([doc_id], v[None, :],
                       None if parent_id is None else [parent_id])

    def add_batch(self, doc_ids, vectors, parent_ids=None) -> int:
        """Bulk-buffer a block of documents; returns the count buffered.

        A float32 `vectors` array is buffered without copying: the caller
        must not mutate it before the flush."""
        ids = np.asarray(doc_ids, np.int64).reshape(-1)
        v = np.asarray(vectors)
        if v.dtype.kind != "f":
            raise TypeError(
                "only float vectors are supported by the disk_ann engine "
                f"(got dtype {v.dtype})")
        if v.ndim != 2 or v.shape != (ids.shape[0], self.config.dim):
            raise ValueError(
                f"vectors shape {v.shape} != ({ids.shape[0]}, "
                f"{self.config.dim})")
        parents = (np.full(ids.shape[0], -1, np.int64) if parent_ids is None
                   else np.asarray(parent_ids, np.int64).reshape(-1))
        if parents.shape != ids.shape:
            raise ValueError("parent_ids must align with doc_ids")
        with self._buf_lock:
            self._blocks.append(
                (ids, parents, v.astype(np.float32, copy=False)))
            self._buffered += ids.shape[0]
        return ids.shape[0]

    def num_buffered(self) -> int:
        return self._buffered

    def delete_buffered(self, doc_ids) -> int:
        """Drop buffered (un-flushed) docs matching `doc_ids`; returns the
        number of buffered entries removed. Docs already snapshotted by an
        in-flight flush are not here anymore: `VectorIndex.delete` covers
        those through its pending set."""
        dead = np.atleast_1d(np.asarray(doc_ids, np.int64))
        removed = 0
        with self._buf_lock:
            new_blocks = []
            for ids, parents, vecs in self._blocks:
                keep = ~np.isin(ids, dead)
                removed += int((~keep).sum())
                if keep.all():
                    new_blocks.append((ids, parents, vecs))
                elif keep.any():
                    new_blocks.append((ids[keep], parents[keep], vecs[keep]))
            if removed:
                self._blocks = new_blocks
                self._buffered -= removed
        return removed

    def _quantize_for_flush(self, vectors: torch.Tensor | np.ndarray):
        """Train PQ and encode when n >= min batch; else None. A numpy
        corpus trains on a host sample and streams its encode."""
        cfg = self.config
        n = vectors.shape[0]
        if cfg.quantization_type == QUANT_NONE:
            return None
        if n < cfg.min_batch_size_for_quantization:
            return None
        t0 = time.monotonic()
        pq = pq_mod.train_pq(vectors, cfg.similarity,
                             num_subspaces=cfg.num_pq_subspaces,
                             device=self.device)
        codes = pq_mod.encode(pq, vectors, cfg.similarity)
        self.stats.increment(Counter.KNN_QUANTIZATION_TRAINING_TIME,
                             int((time.monotonic() - t0) * 1000))
        return pq_mod.PQVectors(pq=pq, codes=codes)

    def flush(self, name: str | None = None, sort_map=None) -> Path | None:
        """Build + persist a segment from the buffered docs; clears buffer.

        `sort_map` (old_doc -> new_doc) applies index sorting to the doc
        map. A failed build restores the buffer so the flush can be
        retried."""
        with self._buf_lock:
            blocks, count = self._blocks, self._buffered
            self._blocks, self._buffered = [], 0
        if not count:
            return None
        try:
            with phase("flush", stats=self.stats):
                return self._build_and_write(blocks, count, name, sort_map)
        except BaseException:
            with self._buf_lock:
                self._blocks = blocks + self._blocks
                self._buffered += count
            raise

    def _build_and_write(self, blocks, count: int, name: str | None,
                         sort_map) -> Path:
        cfg = self.config
        with self._buf_lock:
            counter = self._flush_counter
            self._flush_counter += 1
        flat = cfg.index_type == "flat"
        on_disk = cfg.mode == "on_disk"
        BREAKER.check(
            BREAKER.estimate_segment_bytes(
                count, cfg.dim, 0 if flat else cfg.m, cfg.neighbor_overflow,
                cfg.num_pq_subspaces
                if cfg.quantization_type != QUANT_NONE else None,
                keep_fp32=not (flat and on_disk)),
            self.device,
        )
        vectors_np = (blocks[0][2] if len(blocks) == 1
                      else np.concatenate([b[2] for b in blocks]))
        doc_ids = np.concatenate([b[0] for b in blocks])
        parent_ids = np.concatenate([b[1] for b in blocks])
        if np.unique(doc_ids).size != doc_ids.size:
            # update semantics within the buffer: keep the LAST occurrence
            # of each doc id, preserving ingest order
            _, last_rev = np.unique(doc_ids[::-1], return_index=True)
            keep = np.sort(doc_ids.size - 1 - last_rev)
            doc_ids, parent_ids = doc_ids[keep], parent_ids[keep]
            vectors_np = vectors_np[keep]
        n = int(doc_ids.size)
        name = name or f"seg_{counter:06d}_{n}"
        cap = bucket_capacity(n)
        check_quantized_build_gate(cfg, n, cap,
                                   self.quantized_build_min_capacity, "flush")
        # flat segments keep the corpus on the host (train on a host
        # sample, streamed encode); graph builds need the rows on the device
        vectors = np.ascontiguousarray(vectors_np, np.float32)
        if not flat:
            vectors = torch.from_numpy(vectors).to(self.device)

        pqv = self._quantize_for_flush(vectors)

        t0 = time.monotonic()
        if flat:
            graph = VamanaGraph.flat(cap, n, self.device)
        else:
            builder = GraphIndexBuilder(
                dim=cfg.dim, max_degree=cfg.m,
                beam_width=cfg.ef_construction, alpha=cfg.alpha,
                neighbor_overflow=cfg.neighbor_overflow,
            )
            build_pq = None
            if on_disk and pqv is not None:
                build_pq = {"decoded": pqv.decode_bf16()}
            graph = builder.build(vectors, cfg.similarity, capacity=cap,
                                  pq=build_pq)
            del build_pq
        self.stats.increment(Counter.KNN_GRAPH_BUILD_TIME,
                             int((time.monotonic() - t0) * 1000))

        docmap = DocMap(doc_ids,
                        parent_ids if (parent_ids >= 0).any() else None)
        if sort_map is not None:
            docmap = docmap.apply_sort(_checked_sort_map(sort_map, doc_ids))

        cap = graph.capacity
        if pqv is not None:
            pqv = pq_mod.PQVectors(pq=pqv.pq, codes=pad_rows(pqv.codes, cap))
        if flat and not (on_disk and pqv is not None):
            # in-memory flat rows serve the scan and its rerank on device
            vectors = torch.from_numpy(vectors).to(self.device)
        # on_disk rows (host or device) go to the row file, sliced to the
        # used prefix: no padding needed
        seg = Segment(name=name, config=cfg, graph=graph, docmap=docmap,
                      vectors=(vectors if on_disk and pqv is not None
                               else pad_rows(vectors, cap)),
                      pqv=pqv)
        path = write_segment(self.root, seg)
        self.stats.increment(Counter.KNN_FLUSH_COUNT)
        return path


def _checked_sort_map(sort_map, doc_ids: np.ndarray) -> np.ndarray:
    smap = np.asarray(sort_map)
    if smap.ndim != 1 or not np.issubdtype(smap.dtype, np.integer):
        raise ValidationError(
            "sort_map must be a 1-D integer array (old doc id -> new doc "
            f"id); got shape {smap.shape} dtype {smap.dtype}")
    hi = int(doc_ids.max(initial=-1))
    if hi >= smap.shape[0]:
        raise ValidationError(
            f"sort_map (len {smap.shape[0]}) does not cover buffered doc "
            f"id {hi}")
    if np.unique(smap).size != smap.size:
        raise ValidationError(
            "sort_map must be injective (no duplicate new doc ids)")
    return smap
