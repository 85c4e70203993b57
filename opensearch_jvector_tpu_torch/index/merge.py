"""Segment merging: incremental leading-segment merge + codebook reuse.

Port of `opensearch_jvector_tpu/index/merge.py`:

  * leading-segment election = the segment with the most live vectors
  * incremental "leading segment merge": keep the leading graph, append
    the other segments' live vectors as delta inserts, fold deletes in at
    cleanup; skipped when disabled, for flat indexes, on ordinal overflow,
    when the lead's live density is below 0.4 or when the lead has no live
    vector, and then everything is rebuilt from the live rows (which
    compacts the ordinal space)
  * PQ codebook reuse: the lead's codebooks are refined by a few Lloyd
    iterations over the merged rows (`refine_pq`) and every row is
    re-encoded; a lead without codebooks trains afresh once the merged
    size reaches the minimum batch (with the config's anisotropic weight)
  * NVQ merges always rebuild, and NVQ is recomputed from the merged rows
    (decoded from the sources' NVQ bytes); scalar thresholds and codes are
    recomputed from the merged rows as well

The merged segment's ordinal space is [leading ordinals | appended
ordinals]; new ordinals start at the lead's USED count, inside the lead's
capacity padding while there is room.

on_disk merges follow this package's flush, not the reference's merge
(which uploads the whole fp32 corpus even for on_disk segments): rows are
gathered from the host row stores and concatenated on the host. A flat
on_disk merge refines its codebooks on a host sample, streams the encode
and writes the rows to the merged segment's row file, so the corpus never
reaches the device. A vamana on_disk merge uploads the rows for the build
(beam candidates scored from the decoded-bf16 cache, prunes on the fp32
rows) as a vamana on_disk flush does; at a merged capacity at or above the
quantized-build gate it takes that flush's quantized build instead: codes
from the host rows, the graph from the decoded-bf16 rows of the merged
ordinals, no fp32 rows on the device. An on_disk nvq+pq
segment has no row file (NVQ replaces the rows), so its merge runs on the
device like an in_memory one, with the decoded-PQ beam source.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import (
    QUANT_NONE,
    QUANT_NVQ,
    SCALAR_BITS,
    SCALAR_QUANTS,
    DiskAnnConfig,
)
from opensearch_jvector_tpu_torch.api.stats import STATS, Counter, StatsRegistry
from opensearch_jvector_tpu_torch.index.docmap import DocMap
from opensearch_jvector_tpu_torch.index.segment import Segment, write_segment
from opensearch_jvector_tpu_torch.index.writer import (
    QUANTIZED_BUILD_MIN_CAPACITY,
    quantized_build,
)
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

MIN_LEADING_DENSITY = 0.4  # reference guard (JVectorWriter.java:1202-1222)
MAX_ORDINALS = 2**31 - 1


def _materialize_vectors(seg: Segment, ids: np.ndarray | None = None):
    """fp32 rows of a segment's USED ordinals, or of the ordinals `ids`:
    a device tensor for in-memory rows and for rows decoded from NVQ, a
    host array paged from the row store for an on_disk segment. Rows
    beyond `docmap.num_ordinals` are capacity padding, never real
    vectors."""
    used = seg.docmap.num_ordinals
    if seg.vectors is not None:
        if ids is None:
            return seg.vectors[:used]
        return seg.vectors[torch.as_tensor(ids, device=seg.vectors.device)]
    if seg.row_store is not None:
        return seg.row_store.gather(np.arange(used) if ids is None else ids)
    assert seg.nvq is not None
    return seg.nvq.decode_rows(torch.as_tensor(
        np.arange(used) if ids is None else ids, device=seg.nvq.device))


def _elect_leading(segments: list[Segment]) -> int:
    """Index of the segment with the most live vectors."""
    return int(np.argmax([s.live_count() for s in segments]))


@contextmanager
def _stage(timings: dict | None, name: str, device: torch.device):
    """With `timings`, add the stage's seconds (host clock, after the
    device has drained) under `name`."""
    if timings is None:
        yield
        return
    t0 = time.monotonic()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings[name] = timings.get(name, 0.0) + time.monotonic() - t0


class _Merge:
    """What every merge needs: the config, the device, the gathered live
    rows of the non-leading segments and the helpers over them."""

    def __init__(self, cfg: DiskAnnConfig, device: torch.device,
                 batch_size: int | None, quantized: bool,
                 timings: dict | None):
        self.cfg = cfg
        self.device = device
        self.batch_size = batch_size
        # the quantized build: the graph builds from the decoded-PQ rows
        self.quantized = quantized
        self.timings = timings
        # on_disk merges keep the gathered rows on the host; NVQ segments
        # have no host rows in either mode
        self.on_disk = cfg.mode == "on_disk"
        self.host = self.on_disk and cfg.quantization_type != QUANT_NVQ
        self.flat = cfg.index_type == "flat"

    def stage(self, name: str):
        return _stage(self.timings, name, self.device)

    def live_blocks(self, segments: list[Segment]):
        """(rows, docs, parents) of every segment's live, mapped ordinals:
        rows as host arrays for an on_disk merge, else device tensors."""
        rows, docs, parents = [], [], []
        for s in segments:
            o2d = s.docmap.ord_to_doc
            keep = s.graph.live[: o2d.shape[0]].cpu().numpy() & (o2d >= 0)
            ids = np.nonzero(keep)[0]
            if ids.size == 0:
                continue
            rows.append(self.as_merge_rows(_materialize_vectors(s, ids)))
            docs.append(o2d[ids])
            parents.append(s.docmap.ord_to_parent[ids]
                           if s.docmap.ord_to_parent is not None
                           else np.full(ids.size, -1, np.int64))
        return rows, docs, parents

    def as_merge_rows(self, rows):
        """Rows where this merge concatenates them: host or device."""
        if self.host:
            return (rows.cpu().numpy() if isinstance(rows, torch.Tensor)
                    else rows)
        return _to_device(rows, self.device)

    def concat(self, blocks):
        if len(blocks) == 1:
            return blocks[0]
        return np.concatenate(blocks) if self.host else torch.cat(blocks)

    def builder(self) -> GraphIndexBuilder:
        cfg = self.cfg
        return GraphIndexBuilder(
            dim=cfg.dim, max_degree=cfg.m, beam_width=cfg.ef_construction,
            alpha=cfg.alpha, neighbor_overflow=cfg.neighbor_overflow,
            hierarchy_enabled=cfg.hierarchy_enabled,
            batch_size=self.batch_size)

    def merged_pq(self, lead: Segment, rows, n_live: int):
        """PQ policy on merge: reuse the lead's codebooks + refine +
        re-encode; train afresh when the lead has none and n >= min batch.
        Host rows train on a host sample and stream their encode."""
        cfg = self.cfg
        if (cfg.quantization_type == QUANT_NONE
                or cfg.quantization_type in SCALAR_QUANTS):
            return None
        if lead.pqv is not None:
            pq = pq_mod.refine_pq(lead.pqv.pq, rows, cfg.similarity)
        elif n_live >= cfg.min_batch_size_for_quantization:
            pq = pq_mod.train_pq(
                rows, cfg.similarity, num_subspaces=cfg.num_pq_subspaces,
                device=self.device,
                anisotropic_eta=pq_mod.eta_from_config(cfg, rows))
        else:
            return None
        return pq_mod.PQVectors(
            pq=pq, codes=pq_mod.encode(pq, rows, cfg.similarity))

    def build_source(self, pqv) -> dict | None:
        """The decoded-bf16 beam source of the memory-constrained tier."""
        if pqv is None or not self.on_disk:
            return None
        return {"decoded": pqv.decode_bf16()}

    def segment(self, name: str, graph: VamanaGraph, docmap: DocMap, exact,
                build_rows, pqv) -> Segment:
        """The merged segment: codes padded to the capacity; its fp32 rows
        cut to the used prefix for the row file (on_disk PQ), else on the
        device and padded; scalar thresholds and codes, and in a rebuild
        NVQ, recomputed from the merged rows `exact` (NVQ then replaces
        the fp32 rows)."""
        cfg = self.cfg
        cap = graph.capacity
        n = exact.shape[0]
        if pqv is not None:
            pqv = pq_mod.PQVectors(pq=pqv.pq, codes=pad_rows(pqv.codes, cap))
        if self.host and pqv is not None:
            return Segment(name=name, config=cfg, graph=graph, docmap=docmap,
                           vectors=exact, pqv=pqv)
        if build_rows is None:
            build_rows = _to_device(exact, self.device)
        nvq = scalar_state = scalar_codes = None
        vectors = pad_rows(build_rows, cap)
        if (cfg.quantization_type == QUANT_NVQ
                and n >= cfg.min_batch_size_for_quantization):
            nvq = nvq_mod.train_nvq(build_rows[:n], cfg.nvq_num_subvectors)
            nvq = nvq_mod.NVQVectors(bytes_=pad_rows(nvq.bytes_, cap),
                                     params=pad_rows(nvq.params, cap),
                                     global_mean=nvq.global_mean)
            vectors = None
        if cfg.quantization_type in SCALAR_QUANTS:
            scalar_state = scalar_mod.train_scalar_quantizer(
                build_rows[:n], bits=SCALAR_BITS[cfg.quantization_type])
            scalar_codes = pad_rows(
                scalar_mod.quantize_vectors(scalar_state, build_rows[:n]),
                cap)
        return Segment(name=name, config=cfg, graph=graph, docmap=docmap,
                       vectors=vectors, nvq=nvq, pqv=pqv,
                       scalar_state=scalar_state, scalar_codes=scalar_codes)


def _to_device(rows, device: torch.device) -> torch.Tensor:
    """Rows as a float32 tensor on `device` (host rows are uploaded)."""
    if isinstance(rows, torch.Tensor):
        return rows.to(device)
    return torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(device)


def merge_segments(
    root: str | Path,
    segments: list[Segment],
    out_name: str,
    stats: StatsRegistry = STATS,
    builder_batch_size: int | None = None,  # None -> builder sizes by dim
    quantized_build_min_capacity: int = QUANTIZED_BUILD_MIN_CAPACITY,
    timings: dict | None = None,  # filled with seconds per stage when given
) -> Path:
    """Merge segments into one; incremental when the guards allow."""
    with phase("merge", stats=stats):
        t0 = time.monotonic()
        assert segments, "nothing to merge"
        cfg = segments[0].config
        device = segments[0].device
        flat = cfg.index_type == "flat"
        lead_idx = _elect_leading(segments)
        lead = segments[lead_idx]
        others = [s for i, s in enumerate(segments) if i != lead_idx]

        # density over USED ordinals (docmap length): capacity padding is
        # free tail space, not fragmentation; only delete holes count
        lead_used = lead.docmap.num_ordinals
        lead_live = lead.live_count()
        use_incremental = (
            not cfg.leading_segment_merge_disabled
            and cfg.quantization_type != QUANT_NVQ  # NVQ always rebuilds
            and not flat  # flat merges are concat-only rebuilds
            and lead_used + sum(s.live_count() for s in others) < MAX_ORDINALS
            and lead_live / max(lead_used, 1) >= MIN_LEADING_DENSITY
            and lead_live > 0
        )
        # the merged size and capacity the gate reads (live counts: an
        # upper bound on the live, mapped rows the merge gathers)
        n_live = sum(s.live_count() for s in segments)
        cap = (max(bucket_capacity(lead_used + n_live - lead_live),
                   lead.capacity())
               if use_incremental else bucket_capacity(n_live))
        quantized = quantized_build(cfg, n_live, cap,
                                    quantized_build_min_capacity)
        # the merged segment and its sources coexist on the device while
        # the new graph builds
        est = BREAKER.estimate_segment_bytes(
            sum(s.capacity() for s in segments), cfg.dim,
            0 if flat else cfg.m, cfg.neighbor_overflow,
            cfg.num_pq_subspaces
            if cfg.quantization_type != QUANT_NONE else None,
            keep_fp32=not (quantized or (flat and cfg.mode == "on_disk")))
        if quantized:
            est += n_live * cfg.dim * 2  # the decoded-bf16 build source
        BREAKER.check(est, device)
        m = _Merge(cfg, device, builder_batch_size, quantized, timings)
        if use_incremental:
            seg = _incremental_merge(m, lead, others, out_name)
        else:
            seg = _full_rebuild_merge(m, segments, lead, out_name)
        with m.stage("write"):
            path = write_segment(root, seg)
        stats.increment(Counter.KNN_GRAPH_MERGE_TIME,
                        int((time.monotonic() - t0) * 1000))
        stats.increment(Counter.KNN_MERGE_COUNT)
        return path


def _docmap(doc_blocks, parent_blocks) -> DocMap:
    parents = np.concatenate(parent_blocks)
    return DocMap(np.concatenate(doc_blocks),
                  parents if (parents >= 0).any() else None)


def _incremental_merge(m: _Merge, lead: Segment, others: list[Segment],
                       out_name: str) -> Segment:
    """Append the other segments' live vectors into the leading graph.

    New ordinals start at the lead's USED count (docmap length): the lead
    graph's capacity may be larger, and that padded tail is free slot space
    the delta inserts occupy first. Codes, the decoded-bf16 build source
    and the fp32 rows are all laid out on these ordinals before the
    inserts."""
    cfg = m.cfg
    lead_used = lead.docmap.num_ordinals
    with m.stage("materialise"):
        rows, docs, parents = m.live_blocks(others)
        n_new = sum(b.shape[0] for b in rows)
        used = lead_used + n_new
        capacity = max(bucket_capacity(used), lead.capacity())
        n_live = lead.live_count() + n_new
        # [used, d] real rows only, the lead's tombstoned ordinals included
        exact = m.concat([m.as_merge_rows(_materialize_vectors(lead))] + rows)
        build_rows = (None if m.quantized
                      else pad_rows(_to_device(exact, m.device), capacity))
    with m.stage("pq"):
        pqv = m.merged_pq(lead, exact if m.quantized else build_rows[:used],
                          n_live)
        build_pq = m.build_source(pqv)
        if m.quantized:  # the decoded rows of the used ordinals
            build_rows = build_pq["decoded"]
    builder = m.builder()
    graph = lead.graph.with_capacity(capacity)
    if n_new:
        with m.stage("delta_inserts"):
            graph = builder.add_nodes(graph, build_rows,
                                      np.arange(lead_used, used),
                                      cfg.similarity, pq=build_pq)
    del build_pq
    # deletes in the leading segment are tombstoned in `live` already; fold
    # them into the adjacency now
    with m.stage("cleanup"):
        graph = builder.cleanup(graph, build_rows, cfg.similarity)
    lead_parents = (lead.docmap.ord_to_parent
                    if lead.docmap.ord_to_parent is not None
                    else np.full(lead_used, -1, np.int64))
    docmap = _docmap([lead.docmap.ord_to_doc] + docs,
                     [lead_parents] + parents)
    return m.segment(out_name, graph, docmap, exact, build_rows, pqv)


def _full_rebuild_merge(m: _Merge, segments: list[Segment], lead: Segment,
                        out_name: str) -> Segment:
    """Rebuild from scratch over all live vectors (compacts ordinals); a
    flat index only concatenates."""
    cfg = m.cfg
    with m.stage("materialise"):
        rows, docs, parents = m.live_blocks(segments)
        if not rows:
            return Segment(
                name=out_name, config=cfg,
                graph=VamanaGraph.empty(0, max(cfg.m, 1), m.device),
                docmap=DocMap(np.empty(0, np.int64)),
                vectors=torch.zeros((0, cfg.dim), dtype=torch.float32,
                                    device=m.device))
        exact = m.concat(rows)
        n = exact.shape[0]
        cap = bucket_capacity(n)
        # a flat on_disk merge and the quantized build keep the corpus on
        # the host throughout
        build_rows = (None if (m.flat and m.host) or m.quantized
                      else _to_device(exact, m.device))
    with m.stage("pq"):
        pqv = m.merged_pq(lead, exact if build_rows is None else build_rows,
                          n)
    with m.stage("build"):
        if m.flat:
            graph = VamanaGraph.flat(cap, n, m.device)
        else:
            build_pq = m.build_source(pqv)
            src = build_pq["decoded"] if m.quantized else build_rows
            graph = m.builder().build(src, cfg.similarity,
                                      capacity=cap, pq=build_pq)
            del build_pq, src
    return m.segment(out_name, graph, _docmap(docs, parents), exact,
                     build_rows, pqv)
