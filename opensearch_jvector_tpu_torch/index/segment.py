"""Segment model + on-disk layout (fp32 and PQ segments).

Port of `opensearch_jvector_tpu/index/segment.py`. The on-disk format is
the contract between the two packages: a segment written by either opens in
the other, byte for byte. A segment is a directory of checksummed
containers (index/store.py):

  meta.jvtpu     config + counts + quantization type byte
  graph.jvtpu    adjacency/degrees/live/entry (+ hierarchy layer if any)
  vectors.jvtpu  fp32 rows
  pq.jvtpu       PQ codebooks + center + codes
  docmap.jvtpu   ordinal->doc map

Files store the used-ordinal prefix; `read_segment` re-pads the device
tensors to the pow2 capacity. NVQ and scalar segments, anisotropic PQ state
and on_disk row files are not ported yet: reading one raises
NotImplementedError naming its ROADMAP item.
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
from opensearch_jvector_tpu_torch.models.pq import PQVectors, ProductQuantization
from opensearch_jvector_tpu_torch.utils.circuit_breaker import BREAKER

# NONE/PQ/NVQ bytes mirror the reference (JVectorIndexQuantization.java:
# 51-53); 3-5 are the scalar modes
QUANT_TYPE_BYTE = {QUANT_NONE: 0, QUANT_PQ: 1, QUANT_NVQ: 2,
                   "1bit": 3, "2bit": 4, "4bit": 5}

NOT_PORTED = {
    "nvq": "NVQ segments are not ported yet (ROADMAP queue 1 item 9)",
    "scalar": "scalar (1/2/4-bit) segments are not ported yet "
              "(ROADMAP queue 1 item 9)",
    "aniso": "anisotropic PQ is not ported yet (ROADMAP queue 1 item 9)",
    "on_disk": "on_disk segments are not ported yet "
               "(ROADMAP queue 1 item 10)",
}


@dataclasses.dataclass
class Segment:
    """In-memory (device-resident) segment."""

    name: str
    config: DiskAnnConfig
    graph: VamanaGraph
    docmap: DocMap
    vectors: torch.Tensor | None = None  # fp32 [capacity, d]
    pqv: PQVectors | None = None

    @property
    def quantization_type(self) -> str:
        return QUANT_PQ if self.pqv is not None else QUANT_NONE

    @property
    def device(self) -> torch.device:
        return self.graph.live.device

    def live_count(self) -> int:
        return int(self.graph.live.sum())

    def capacity(self) -> int:
        return self.graph.capacity


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
    if seg.vectors is not None:
        store.write_container(
            d / "vectors.jvtpu",
            {"kind": "fp32"},
            {"vectors": seg.vectors[:used].cpu().numpy().astype(np.float32)},
        )
    if seg.pqv is not None:
        store.write_container(d / "pq.jvtpu", {}, {
            "codebooks": seg.pqv.pq.codebooks.cpu().numpy(),
            "center": seg.pqv.pq.center.cpu().numpy(),
            "codes": seg.pqv.codes[:used].cpu().numpy().astype(np.uint8),
        })
    docmap_arrays = {"ord_to_doc": seg.docmap.ord_to_doc}
    if seg.docmap.ord_to_parent is not None:
        docmap_arrays["ord_to_parent"] = seg.docmap.ord_to_parent
    store.write_container(d / "docmap.jvtpu", {}, docmap_arrays)
    return d


def read_segment(path: str | Path, device: torch.device | str,
                 verify: bool = True) -> Segment:
    """Load a segment directory onto `device` (checksums verified)."""
    d = Path(path)
    device = torch.device(device)
    meta, _ = store.read_container(d / "meta.jvtpu", verify=verify)
    config = DiskAnnConfig.from_meta(meta["config"])
    if config.mode == "on_disk":
        raise NotImplementedError(NOT_PORTED["on_disk"])
    if (d / "scalar.jvtpu").exists():
        raise NotImplementedError(NOT_PORTED["scalar"])
    BREAKER.check(
        BREAKER.estimate_segment_bytes(
            int(meta.get("capacity", 0)), config.dim, config.m,
            config.neighbor_overflow,
            config.num_pq_subspaces
            if config.quantization_type != QUANT_NONE else None,
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
    vpath = d / "vectors.jvtpu"
    if vpath.exists():
        vmeta, varr = store.read_container(vpath, verify=verify)
        if vmeta["kind"] == "fp32_ondisk":
            raise NotImplementedError(NOT_PORTED["on_disk"])
        if vmeta["kind"] != "fp32":
            raise NotImplementedError(NOT_PORTED["nvq"])
        vectors = _dev(varr["vectors"], 0)

    pqv = None
    ppath = d / "pq.jvtpu"
    if ppath.exists():
        _, parr = store.read_container(ppath, verify=verify)
        if "aniso_eta" in parr:
            raise NotImplementedError(NOT_PORTED["aniso"])
        pqv = PQVectors(
            pq=ProductQuantization(
                codebooks=torch.from_numpy(parr["codebooks"].copy()).to(device),
                center=torch.from_numpy(parr["center"].copy()).to(device),
            ),
            codes=_dev(parr["codes"], 0),
        )
    return Segment(name=d.name, config=config, graph=graph, docmap=docmap,
                   vectors=vectors, pqv=pqv)


def check_integrity(path: str | Path) -> bool:
    """Re-verify every container checksum (checkIntegrity parity)."""
    for f in sorted(Path(path).glob("*.jvtpu")):
        store.read_container(f, verify=True)
    return True
