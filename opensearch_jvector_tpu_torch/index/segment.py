"""Segment model + on-disk layout.

Port of `opensearch_jvector_tpu/index/segment.py`. The on-disk format is
the contract between the two packages: a segment written by either opens in
the other, byte for byte. A segment is a directory of checksummed
containers (index/store.py):

  meta.jvtpu     config + counts + quantization type byte
  graph.jvtpu    adjacency/degrees/live/entry (+ hierarchy layer if any)
  vectors.jvtpu  fp32 rows; NVQ bytes/params/global_mean ({"kind": "nvq"})
                 when the config is nvq+pq, in either mode: NVQ replaces
                 the inline rows, so such a segment has no row file; for
                 on_disk PQ segments only the marker
                 {"kind": "fp32_ondisk"}, the rows being in:
  rows.f32       raw row-major fp32 rows (+ rows.f32.crc: crc32, bytes),
                 read through the host row store (utils/native_store.py)
  pq.jvtpu       PQ codebooks + center + codes (+ aniso_eta when the
                 codebooks were trained with the anisotropic loss)
  scalar.jvtpu   1/2/4-bit thresholds + bit-packed codes
  docmap.jvtpu   ordinal->doc map

Files store the used-ordinal prefix; `read_segment` re-pads the device
tensors to the pow2 capacity.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import (
    QUANT_NONE,
    QUANT_NVQ,
    QUANT_PQ,
    DiskAnnConfig,
)
from opensearch_jvector_tpu_torch.index import store
from opensearch_jvector_tpu_torch.index.docmap import DocMap
from opensearch_jvector_tpu_torch.models.graph import (
    VamanaGraph,
    bucket_capacity,
)
from opensearch_jvector_tpu_torch.models.nvq import NVQVectors
from opensearch_jvector_tpu_torch.models.pq import PQVectors, ProductQuantization
from opensearch_jvector_tpu_torch.models.scalar import (
    SCALAR_STATE_CACHE,
    QuantizationState,
)
from opensearch_jvector_tpu_torch.utils.circuit_breaker import BREAKER
from opensearch_jvector_tpu_torch.utils.native_store import (
    PagedVectorStore,
    verify_row_file,
    write_row_file,
)

# NONE/PQ/NVQ bytes mirror the reference (JVectorIndexQuantization.java:
# 51-53); 3-5 are the scalar modes
QUANT_TYPE_BYTE = {QUANT_NONE: 0, QUANT_PQ: 1, QUANT_NVQ: 2,
                   "1bit": 3, "2bit": 4, "4bit": 5}


@dataclasses.dataclass
class Segment:
    """In-memory (device-resident) segment.

    `row_store` (on_disk mode) replaces `vectors`: the fp32 rows stay in
    the host row store and only rerank candidates are paged. A segment
    built for writing may carry its on_disk rows as a host numpy array in
    `vectors`; `write_segment` puts them into the row file."""

    name: str
    config: DiskAnnConfig
    graph: VamanaGraph
    docmap: DocMap
    vectors: torch.Tensor | np.ndarray | None = None  # fp32 [capacity, d]
    nvq: NVQVectors | None = None
    pqv: PQVectors | None = None
    row_store: PagedVectorStore | None = None
    scalar_state: QuantizationState | None = None
    scalar_codes: torch.Tensor | None = None  # [capacity, B] uint8 packed
    # doc->ordinal inverse (sorted docs, their ordinals), built on first
    # use; not an init field, so a `dataclasses.replace` with a new docmap
    # starts without it
    _doc_sort: tuple[np.ndarray, np.ndarray] | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def ords_for_docs(self, doc_ids) -> np.ndarray:
        """Doc ids -> graph ordinals (-1 where absent), by binary search
        over the sorted docmap."""
        if self._doc_sort is None:
            docs = self.docmap.ord_to_doc
            order = np.argsort(docs, kind="stable")
            self._doc_sort = (docs[order], order.astype(np.int64))
        sdocs, sords = self._doc_sort
        shape = np.shape(doc_ids)
        flat = np.asarray(doc_ids, np.int64).reshape(-1)
        if not sdocs.size:
            return np.full(shape, -1, np.int64)
        pos = np.minimum(np.searchsorted(sdocs, flat), sdocs.size - 1)
        ok = (sdocs[pos] == flat) & (flat >= 0)
        return np.where(ok, sords[pos], -1).reshape(shape)

    @property
    def quantization_type(self) -> str:
        if self.nvq is not None:
            return QUANT_NVQ
        if self.scalar_state is not None:
            return {1: "1bit", 2: "2bit", 4: "4bit"}[self.scalar_state.bits]
        if self.pqv is not None:
            return QUANT_PQ
        return QUANT_NONE

    @property
    def device(self) -> torch.device:
        return self.graph.live.device

    def live_count(self) -> int:
        return int(self.graph.live.sum())

    def capacity(self) -> int:
        return self.graph.capacity

    def rerank_source(self):
        """(vectors, nvq) pair for the searcher's rerank phase."""
        if self.vectors is not None:
            return self.vectors, None
        assert self.nvq is not None
        return None, self.nvq


def write_segment(root: str | Path, seg: Segment) -> Path:
    root = Path(root)
    d = root / seg.name
    d.mkdir(parents=True, exist_ok=True)
    used = seg.docmap.num_ordinals

    meta = {
        "config": seg.config.to_meta(),
        "quantization_type_byte": QUANT_TYPE_BYTE[seg.quantization_type],
        "capacity": seg.capacity(),
        "live_count": seg.live_count(),
    }
    store.write_container(d / "meta.jvtpu", meta, {})

    graph_arrays = {
        "adjacency": seg.graph.adjacency[:used].cpu().numpy().astype(np.int32),
        "degrees": seg.graph.degrees[:used].cpu().numpy().astype(np.int32),
        "live": seg.graph.live[:used].cpu().numpy().astype(bool),
    }
    if seg.graph.upper_adjacency is not None:
        graph_arrays["upper_adjacency"] = (
            seg.graph.upper_adjacency[:used].cpu().numpy().astype(np.int32))
    store.write_container(
        d / "graph.jvtpu", {"entry": int(seg.graph.entry)}, graph_arrays
    )
    on_disk = (seg.config.mode == "on_disk" and seg.pqv is not None
               and seg.nvq is None)
    if seg.row_store is not None or (on_disk and seg.vectors is not None):
        if seg.vectors is not None:
            write_row_file(d / "rows.f32", _host_rows(seg.vectors[:used]))
        store.write_container(d / "vectors.jvtpu", {"kind": "fp32_ondisk"},
                              {})
    elif seg.vectors is not None:
        store.write_container(
            d / "vectors.jvtpu",
            {"kind": "fp32"},
            {"vectors": _host_rows(seg.vectors[:used])},
        )
    if seg.nvq is not None:
        store.write_container(d / "vectors.jvtpu", {"kind": "nvq"}, {
            "bytes": seg.nvq.bytes_[:used].cpu().numpy().astype(np.uint8),
            "params": seg.nvq.params[:used].cpu().numpy(),
            "global_mean": seg.nvq.global_mean.cpu().numpy(),
        })
    if seg.pqv is not None:
        arrays = {
            "codebooks": seg.pqv.pq.codebooks.cpu().numpy(),
            "center": seg.pqv.pq.center.cpu().numpy(),
            "codes": seg.pqv.codes[:used].cpu().numpy().astype(np.uint8),
        }
        if seg.pqv.pq.aniso_eta is not None:
            # the assignment metric is part of the state: a merge's
            # re-encode must use the same loss
            arrays["aniso_eta"] = np.asarray(
                seg.pqv.pq.aniso_eta, np.float32).reshape(1)
        store.write_container(d / "pq.jvtpu", {}, arrays)
    if seg.scalar_state is not None:
        store.write_container(
            d / "scalar.jvtpu", {"bits": seg.scalar_state.bits}, {
                "thresholds": np.asarray(seg.scalar_state.thresholds),
                "codes": seg.scalar_codes[:used].cpu().numpy().astype(
                    np.uint8),
            })
    docmap_arrays = {"ord_to_doc": seg.docmap.ord_to_doc}
    if seg.docmap.ord_to_parent is not None:
        docmap_arrays["ord_to_parent"] = seg.docmap.ord_to_parent
    store.write_container(d / "docmap.jvtpu", {}, docmap_arrays)
    return d


def _host_rows(rows: torch.Tensor | np.ndarray) -> np.ndarray:
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    return np.asarray(rows, np.float32)


def read_segment(path: str | Path, device: torch.device | str,
                 verify: bool = True) -> Segment:
    """Load a segment directory onto `device` (checksums verified)."""
    d = Path(path)
    device = torch.device(device)
    meta, _ = store.read_container(d / "meta.jvtpu", verify=verify)
    config = DiskAnnConfig.from_meta(meta["config"])
    BREAKER.check(
        BREAKER.estimate_segment_bytes(
            int(meta.get("capacity", 0)), config.dim, config.m,
            config.neighbor_overflow,
            config.num_pq_subspaces
            if config.quantization_type != QUANT_NONE else None,
            keep_fp32=config.mode != "on_disk",
        ),
        device,
    )
    gmeta, garr = store.read_container(d / "graph.jvtpu", verify=verify)
    used = garr["live"].shape[0]
    cap = bucket_capacity(used) if used else 0

    def _dev(a: np.ndarray, fill) -> torch.Tensor:
        if a.shape[0] < cap:
            widths = [(0, cap - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            a = np.pad(a, widths, constant_values=fill)
        return torch.from_numpy(np.array(a)).to(device)  # copy: mmap is read-only

    graph = VamanaGraph(
        adjacency=_dev(garr["adjacency"], -1),
        degrees=_dev(garr["degrees"], 0),
        live=_dev(garr["live"], False),
        entry=int(gmeta["entry"]),
        upper_adjacency=(_dev(garr["upper_adjacency"], -1)
                         if "upper_adjacency" in garr else None),
    )
    _, darr = store.read_container(d / "docmap.jvtpu", verify=verify)
    docmap = DocMap(darr["ord_to_doc"], darr.get("ord_to_parent"))

    vectors = None
    nvq = None
    row_store = None
    vpath = d / "vectors.jvtpu"
    if vpath.exists():
        vmeta, varr = store.read_container(vpath, verify=verify)
        if vmeta["kind"] == "fp32":
            vectors = _dev(varr["vectors"], 0)
        elif vmeta["kind"] == "fp32_ondisk":
            row_store = PagedVectorStore(d / "rows.f32", dim=config.dim)
        else:
            nvq = NVQVectors(
                bytes_=_dev(varr["bytes"], 0),
                params=_dev(varr["params"], 0),
                global_mean=torch.from_numpy(
                    varr["global_mean"].copy()).to(device),
            )

    scalar_state = None
    scalar_codes = None
    spath = d / "scalar.jvtpu"
    if spath.exists():
        key = str(d.resolve())
        smeta, sarr = store.read_container(spath, verify=verify)
        scalar_state = SCALAR_STATE_CACHE.get(key)
        if scalar_state is None:
            scalar_state = QuantizationState(
                bits=int(smeta["bits"]),
                thresholds=np.array(sarr["thresholds"]))
            SCALAR_STATE_CACHE.put(key, scalar_state)
        scalar_codes = _dev(sarr["codes"], 0)

    pqv = None
    ppath = d / "pq.jvtpu"
    if ppath.exists():
        _, parr = store.read_container(ppath, verify=verify)
        pqv = PQVectors(
            pq=ProductQuantization(
                codebooks=torch.from_numpy(parr["codebooks"].copy()).to(device),
                center=torch.from_numpy(parr["center"].copy()).to(device),
                aniso_eta=(float(parr["aniso_eta"][0])
                           if "aniso_eta" in parr else None),
            ),
            codes=_dev(parr["codes"], 0),
        )
    return Segment(name=d.name, config=config, graph=graph, docmap=docmap,
                   vectors=vectors, nvq=nvq, pqv=pqv, row_store=row_store,
                   scalar_state=scalar_state, scalar_codes=scalar_codes)


def check_integrity(path: str | Path) -> bool:
    """Re-verify every container checksum and every raw row file against
    its CRC sidecar (checkIntegrity parity)."""
    d = Path(path)
    for f in sorted(d.glob("*.jvtpu")):
        store.read_container(f, verify=True)
    for f in sorted(d.glob("*.f32")):
        verify_row_file(f)
    return True
