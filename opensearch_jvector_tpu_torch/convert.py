"""Build the port's objects from state given as numpy arrays.

The reference package's state (PQ codebooks, graphs, whole segments) is
handed across as numpy arrays — the same arrays its segment files hold — so
both packages compute on identical codebooks, codes and graphs. The other
route for the same state is a segment directory (index/segment.py).
"""

from __future__ import annotations

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig
from opensearch_jvector_tpu_torch.index.docmap import DocMap
from opensearch_jvector_tpu_torch.index.segment import Segment
from opensearch_jvector_tpu_torch.models.graph import VamanaGraph
from opensearch_jvector_tpu_torch.models.nvq import NVQVectors
from opensearch_jvector_tpu_torch.models.pq import PQVectors, ProductQuantization
from opensearch_jvector_tpu_torch.models.scalar import QuantizationState
from opensearch_jvector_tpu_torch.utils.native_store import PagedVectorStore


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype)).to(device)


def pq_from_numpy(codebooks, center, *, device: torch.device | str,
                  aniso_eta=None) -> ProductQuantization:
    """[M, K, dsub] codebooks + [d] center (+ the anisotropic weight the
    codebooks were trained with) -> ProductQuantization."""
    return ProductQuantization(
        codebooks=_t(codebooks, np.float32, device),
        center=_t(center, np.float32, device),
        aniso_eta=(None if aniso_eta is None
                   else float(np.asarray(aniso_eta, np.float32).reshape(-1)[0])))


def nvq_from_numpy(bytes_, params, global_mean, *,
                   device: torch.device | str) -> NVQVectors:
    """bytes [n, d] u8 / params [n, M, 4] / global_mean [d] -> NVQVectors."""
    return NVQVectors(bytes_=_t(bytes_, np.uint8, device),
                      params=_t(params, np.float32, device),
                      global_mean=_t(global_mean, np.float32, device))


def scalar_from_numpy(bits: int, thresholds, codes, *,
                      device: torch.device | str):
    """bits / thresholds [levels, d] / packed codes [n, B] ->
    (QuantizationState, codes tensor)."""
    return (QuantizationState(bits=int(bits),
                              thresholds=np.array(thresholds, np.float32)),
            _t(codes, np.uint8, device))


def graph_from_numpy(adjacency, degrees, live, entry, *,
                     device: torch.device | str,
                     upper_adjacency=None) -> VamanaGraph:
    """Adjacency [N, deg] / degrees [N] / live [N] / entry (+ the hierarchy
    layer [N, m_up]) -> VamanaGraph."""
    return VamanaGraph(adjacency=_t(adjacency, np.int32, device),
                       degrees=_t(degrees, np.int32, device),
                       live=_t(live, bool, device),
                       entry=int(np.asarray(entry)),
                       upper_adjacency=(
                           None if upper_adjacency is None
                           else _t(upper_adjacency, np.int32, device)))


def segment_from_numpy(
    name: str,
    config_meta: dict,  # DiskAnnConfig.to_meta() of either package
    adjacency, degrees, live, entry,
    ord_to_doc,
    vectors=None,  # [capacity, d] f32
    codebooks=None, center=None, codes=None,  # PQ state, codes [capacity, M]
    ord_to_parent=None,
    *,
    device: torch.device | str,
    rows_path=None,  # on_disk: the segment's raw row file, not `vectors`
    aniso_eta=None,  # with the PQ state
    upper_adjacency=None,  # hierarchy layer [capacity, m_up]
    nvq_bytes=None, nvq_params=None, nvq_global_mean=None,  # NVQ state
    scalar_bits=None, scalar_thresholds=None, scalar_codes=None,
) -> Segment:
    """A whole segment from numpy arrays. An on_disk segment gives the path
    of its raw fp32 row file (`rows.f32`) in place of device rows; an NVQ
    segment gives its NVQ state in place of `vectors`."""
    if rows_path is not None and vectors is not None:
        raise ValueError("an on_disk segment takes rows_path, not vectors")
    config = DiskAnnConfig.from_meta(config_meta)
    pqv = None
    if codes is not None:
        pqv = PQVectors(
            pq=pq_from_numpy(codebooks, center, device=device,
                            aniso_eta=aniso_eta),
            codes=_t(codes, np.uint8, device))
    scalar = (None, None)
    if scalar_codes is not None:
        scalar = scalar_from_numpy(scalar_bits, scalar_thresholds,
                                   scalar_codes, device=device)
    return Segment(
        name=name,
        config=config,
        graph=graph_from_numpy(adjacency, degrees, live, entry,
                               device=device,
                               upper_adjacency=upper_adjacency),
        docmap=DocMap(ord_to_doc, ord_to_parent),
        vectors=None if vectors is None else _t(vectors, np.float32, device),
        nvq=(None if nvq_bytes is None else nvq_from_numpy(
            nvq_bytes, nvq_params, nvq_global_mean, device=device)),
        pqv=pqv,
        scalar_state=scalar[0],
        scalar_codes=scalar[1],
        row_store=(None if rows_path is None
                   else PagedVectorStore(rows_path, dim=config.dim)),
    )
