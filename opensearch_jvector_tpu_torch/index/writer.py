"""Index writer: buffer -> quantize -> graph build -> segment flush.

Port of the flush of `opensearch_jvector_tpu/index/writer.py`:
  * buffers (docId, float vector) blocks; byte vectors are rejected
  * below `min_batch_size_for_quantization` builds fp32 only; otherwise
    trains the configured quantizer and encodes (`_quantize_for_flush`:
    PQ, plain or anisotropic; NVQ beside its auxiliary PQ; 1/2/4-bit
    scalar codes), then builds the Vamana graph over the fp32 rows, with
    the hierarchy layer when the config enables it
  * `index_type: flat` builds no graph and keeps the corpus on the host:
    PQ trains on a host sample and the encode streams host chunks
  * in_memory segments keep their fp32 rows on the device for the rerank;
    NVQ segments keep the NVQ bytes instead, in either mode; on_disk PQ
    segments write the rows to the raw row file (`rows.f32`) from the host
    buffer; a vamana on_disk flush scores its build's beam candidates from
    the decoded-PQ cache (prunes stay exact fp32)
  * the quantized build: an on_disk PQ graph flush of capacity >=
    `quantized_build_min_capacity` (2^22) never uploads its fp32 rows. PQ
    trains on a host sample and encodes streamed chunks, and the graph
    builds from the decoded-bf16 rows `decoded[:n]` (the builder upcasts
    only the rows each prune gathers) at the segment's capacity. The
    reference passes the capacity-padded cache instead, so its medoid can
    land on a pad row. The gate is decided after the in-buffer dedup, so a
    dedup that falls under the minimum batch takes the fp32 build
  * `flush(device_rows=...)`: a provider of the same rows already on the
    device (`device_rows(lo, hi)` -> [hi - lo, d], ingest order, asked for
    in DEVICE_ROWS_BLOCK-row blocks) feeds the PQ encode and, for an fp32
    graph build, the upload; the row file is still written from the host
    buffer. It is ignored after an in-buffer dedup and after a buffered
    delete compacted the blocks (positions moved)
  * writes the segment with versioned, checksummed containers
  * each step of a flush is a span (`utils/profiling.phase`) inside the
    `flush` range: `writer.upload`, `writer.quantize` (`writer.pq_train`,
    `writer.pq_encode`, `writer.nvq_train`), `writer.build` (with
    `GraphIndexBuilder`'s `builder.*` spans inside) and `writer.write`; a
    graph build adds its nodes, rows scored, nodes expanded, reverse edges
    and overflow rows to the `knn_graph_build_*` counters
"""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import (
    QUANT_NONE,
    QUANT_NVQ,
    QUANT_PQ,
    SCALAR_BITS,
    SCALAR_QUANTS,
    DiskAnnConfig,
    ValidationError,
)
from opensearch_jvector_tpu_torch.api.stats import STATS, Counter, StatsRegistry
from opensearch_jvector_tpu_torch.index.docmap import DocMap
from opensearch_jvector_tpu_torch.index.segment import Segment, write_segment
from opensearch_jvector_tpu_torch.models import nvq as nvq_mod
from opensearch_jvector_tpu_torch.models import pq as pq_mod
from opensearch_jvector_tpu_torch.models import scalar as scalar_mod
from opensearch_jvector_tpu_torch.models.builder import GraphIndexBuilder
from opensearch_jvector_tpu_torch.models.graph import (
    VamanaGraph,
    bucket_capacity,
    pad_rows,
)
from opensearch_jvector_tpu_torch.utils.circuit_breaker import BREAKER
from opensearch_jvector_tpu_torch.utils.profiling import phase


# on_disk PQ graph segments at or above this pow2 capacity take the
# quantized build (no fp32 rows on the device)
QUANTIZED_BUILD_MIN_CAPACITY = 1 << 22
# Rows a flush(device_rows=...) provider is asked for at a time, by the PQ
# encode and by an fp32 build's upload alike
DEVICE_ROWS_BLOCK = 1 << 20


def quantized_build(cfg: DiskAnnConfig, n: int, cap: int, gate: int) -> bool:
    """Whether an on_disk graph segment of `n` rows and capacity `cap`
    builds from its decoded-PQ rows instead of its fp32 rows."""
    return (cfg.mode == "on_disk" and cfg.index_type != "flat"
            and cfg.quantization_type == QUANT_PQ
            and n >= cfg.min_batch_size_for_quantization and cap >= gate)


def _provider_blocks(device_rows, n: int):
    """The `n` rows of a device_rows provider, DEVICE_ROWS_BLOCK at a time."""
    for lo in range(0, n, DEVICE_ROWS_BLOCK):
        yield device_rows(lo, min(lo + DEVICE_ROWS_BLOCK, n))


class IndexWriter:
    def __init__(
        self,
        root: str | Path,
        config: DiskAnnConfig,
        device: torch.device | str,
        stats: StatsRegistry = STATS,
    ):
        self.quantized_build_min_capacity = QUANTIZED_BUILD_MIN_CAPACITY
        # the graph build's insert batch (flushes and merges); None: the
        # builder sizes it
        self.build_batch_size: int | None = None
        self.root = Path(root)
        self.config = config
        self.device = torch.device(device)
        self.stats = stats
        self._blocks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._buffered = 0
        self._buf_lock = threading.Lock()
        # set when a buffered delete compacts the blocks: the buffer's
        # positions no longer match the ingest order a device_rows provider
        # was built against, so the next flush ignores its provider
        self._buffer_positions_dirty = False
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
                self._buffer_positions_dirty = True
        return removed

    def _quantize_for_flush(self, vectors: torch.Tensor | np.ndarray,
                            device_rows=None):
        """Train the configured quantizer and encode when n >= min batch
        -> (pqv, nvq, scalar), each None where it does not apply; `scalar`
        is a (QuantizationState, packed codes) pair for the 1/2/4-bit
        modes. A numpy corpus (flat segments, the quantized build) trains
        PQ on a host sample and streams its encode, from `device_rows`
        blocks where a provider is given."""
        cfg = self.config
        n = vectors.shape[0]
        if (cfg.quantization_type == QUANT_NONE
                or n < cfg.min_batch_size_for_quantization):
            return None, None, None
        pqv = nvq = scalar = None
        with phase("writer.quantize", Counter.KNN_QUANTIZATION_TRAINING_TIME,
                   self.stats):
            if cfg.quantization_type in SCALAR_QUANTS:
                state = scalar_mod.train_scalar_quantizer(
                    vectors, bits=SCALAR_BITS[cfg.quantization_type])
                scalar = (state, scalar_mod.quantize_vectors(state, vectors))
                return pqv, nvq, scalar
            with phase("writer.pq_train"):
                pq = pq_mod.train_pq(
                    vectors, cfg.similarity,
                    num_subspaces=cfg.num_pq_subspaces, device=self.device,
                    anisotropic_eta=pq_mod.eta_from_config(cfg, vectors))
            with phase("writer.pq_encode"):
                if device_rows is not None:
                    codes = torch.cat([
                        pq_mod.encode(pq, rows, cfg.similarity)
                        for rows in _provider_blocks(device_rows, n)])
                else:
                    codes = pq_mod.encode(pq, vectors, cfg.similarity)
            pqv = pq_mod.PQVectors(pq=pq, codes=codes)
            if cfg.quantization_type == QUANT_NVQ:
                with phase("writer.nvq_train"):
                    nvq = nvq_mod.train_nvq(vectors, cfg.nvq_num_subvectors)
        return pqv, nvq, scalar

    def flush(self, name: str | None = None, sort_map=None,
              device_rows=None) -> Path | None:
        """Build + persist a segment from the buffered docs; clears buffer.

        `sort_map` (old_doc -> new_doc) applies index sorting to the doc
        map. `device_rows(lo, hi)` optionally returns the same rows as a
        tensor on the device (see the module docstring); it must hold the
        buffered values, which stay the durable copy. A failed build
        restores the buffer so the flush can be retried."""
        with self._buf_lock:
            blocks, count = self._blocks, self._buffered
            dirty = self._buffer_positions_dirty
            self._blocks, self._buffered = [], 0
            self._buffer_positions_dirty = False
        if not count:
            return None
        try:
            with phase("flush", stats=self.stats):
                return self._build_and_write(
                    blocks, count, name, sort_map,
                    None if dirty else device_rows)
        except BaseException:
            with self._buf_lock:
                self._blocks = blocks + self._blocks
                self._buffered += count
                self._buffer_positions_dirty |= dirty
            raise

    def _build_and_write(self, blocks, count: int, name: str | None,
                         sort_map, device_rows) -> Path:
        cfg = self.config
        with self._buf_lock:
            counter = self._flush_counter
            self._flush_counter += 1
        flat = cfg.index_type == "flat"
        on_disk = cfg.mode == "on_disk"
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
            device_rows = None  # positions moved: the provider misaligns
        n = int(doc_ids.size)
        name = name or f"seg_{counter:06d}_{n}"
        cap = bucket_capacity(n)
        quantized = quantized_build(cfg, n, cap,
                                    self.quantized_build_min_capacity)
        est = BREAKER.estimate_segment_bytes(
            n, cfg.dim, 0 if flat else cfg.m, cfg.neighbor_overflow,
            cfg.num_pq_subspaces
            if cfg.quantization_type != QUANT_NONE else None,
            keep_fp32=not (quantized or (flat and on_disk)))
        if quantized:
            est += n * cfg.dim * 2  # the decoded-bf16 build source
        BREAKER.check(est, self.device)
        # flat segments and the quantized build keep the corpus on the
        # host (train on a host sample, streamed encode); an fp32 graph
        # build needs the rows on the device
        with phase("writer.upload"):
            host = np.ascontiguousarray(vectors_np, np.float32)
            vectors = host
            if not (flat or quantized):
                vectors = (torch.cat(list(_provider_blocks(device_rows, n)))
                           if device_rows is not None
                           else torch.from_numpy(host).to(self.device))
                device_rows = None  # the rows are on the device now

        pqv, nvq, scalar = self._quantize_for_flush(vectors, device_rows)

        with phase("writer.build", Counter.KNN_GRAPH_BUILD_TIME, self.stats):
            if flat:
                graph = VamanaGraph.flat(cap, n, self.device)
            else:
                builder = GraphIndexBuilder(
                    dim=cfg.dim, max_degree=cfg.m,
                    beam_width=cfg.ef_construction, alpha=cfg.alpha,
                    neighbor_overflow=cfg.neighbor_overflow,
                    hierarchy_enabled=cfg.hierarchy_enabled,
                    batch_size=self.build_batch_size,
                )
                build_pq = None
                if on_disk and pqv is not None:
                    build_pq = {"decoded": pqv.decode_bf16()}
                # the quantized build's only corpus on the device: the
                # decoded rows of the n real ordinals, built at the
                # segment's capacity
                src = build_pq["decoded"] if quantized else vectors
                graph = builder.build(src, cfg.similarity, capacity=cap,
                                      pq=build_pq)
                del build_pq, src
                c = builder.counters
                self.stats.increment(Counter.KNN_GRAPH_BUILD_NODES,
                                     c.nodes_inserted)
                self.stats.increment(Counter.KNN_GRAPH_BUILD_ROWS_SCORED,
                                     c.rows_scored)
                self.stats.increment(Counter.KNN_GRAPH_BUILD_EXPANDED_NODES,
                                     c.expanded)
                self.stats.increment(Counter.KNN_GRAPH_BUILD_REVERSE_EDGES,
                                     c.reverse_edges)
                self.stats.increment(Counter.KNN_GRAPH_BUILD_OVERFLOW_NODES,
                                     c.overflow_nodes)
        with phase("writer.write"):
            docmap = DocMap(doc_ids,
                            parent_ids if (parent_ids >= 0).any() else None)
            if sort_map is not None:
                docmap = docmap.apply_sort(
                    _checked_sort_map(sort_map, doc_ids))

            cap = graph.capacity
            if pqv is not None:
                pqv = pq_mod.PQVectors(pq=pqv.pq,
                                       codes=pad_rows(pqv.codes, cap))
            if nvq is not None:
                # NVQ replaces the inline fp32 rows, in either mode
                nvq = nvq_mod.NVQVectors(bytes_=pad_rows(nvq.bytes_, cap),
                                         params=pad_rows(nvq.params, cap),
                                         global_mean=nvq.global_mean)
                vectors = None
            elif on_disk and pqv is not None:
                # the row file is written from the host buffer, sliced to
                # the used prefix: no padding needed
                vectors = host
            else:
                if flat:  # in-memory flat rows serve the scan on the device
                    vectors = torch.from_numpy(host).to(self.device)
                vectors = pad_rows(vectors, cap)
            seg = Segment(
                name=name, config=cfg, graph=graph, docmap=docmap,
                vectors=vectors, nvq=nvq, pqv=pqv,
                scalar_state=scalar[0] if scalar else None,
                scalar_codes=pad_rows(scalar[1], cap) if scalar else None)
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
