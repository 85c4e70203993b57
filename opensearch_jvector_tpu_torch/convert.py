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
from opensearch_jvector_tpu_torch.models.pq import PQVectors, ProductQuantization
from opensearch_jvector_tpu_torch.utils.native_store import PagedVectorStore


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype)).to(device)


def pq_from_numpy(codebooks, center,
                  device: torch.device | str = "cpu") -> ProductQuantization:
    """[M, K, dsub] codebooks + [d] center -> ProductQuantization."""
    return ProductQuantization(codebooks=_t(codebooks, np.float32, device),
                               center=_t(center, np.float32, device))


def graph_from_numpy(adjacency, degrees, live, entry,
                     device: torch.device | str = "cpu") -> VamanaGraph:
    """Adjacency [N, deg] / degrees [N] / live [N] / entry -> VamanaGraph."""
    return VamanaGraph(adjacency=_t(adjacency, np.int32, device),
                       degrees=_t(degrees, np.int32, device),
                       live=_t(live, bool, device),
                       entry=int(np.asarray(entry)))


def segment_from_numpy(
    name: str,
    config_meta: dict,  # DiskAnnConfig.to_meta() of either package
    adjacency, degrees, live, entry,
    ord_to_doc,
    vectors=None,  # [capacity, d] f32
    codebooks=None, center=None, codes=None,  # PQ state, codes [capacity, M]
    ord_to_parent=None,
    device: torch.device | str = "cpu",
    rows_path=None,  # on_disk: the segment's raw row file, not `vectors`
) -> Segment:
    """A whole segment from numpy arrays. An on_disk segment gives the path
    of its raw fp32 row file (`rows.f32`) in place of device rows."""
    if rows_path is not None and vectors is not None:
        raise ValueError("an on_disk segment takes rows_path, not vectors")
    config = DiskAnnConfig.from_meta(config_meta)
    pqv = None
    if codes is not None:
        pqv = PQVectors(pq=pq_from_numpy(codebooks, center, device),
                        codes=_t(codes, np.uint8, device))
    return Segment(
        name=name,
        config=config,
        graph=graph_from_numpy(adjacency, degrees, live, entry, device),
        docmap=DocMap(ord_to_doc, ord_to_parent),
        vectors=None if vectors is None else _t(vectors, np.float32, device),
        pqv=pqv,
        row_store=(None if rows_path is None
                   else PagedVectorStore(rows_path, dim=config.dim)),
    )
