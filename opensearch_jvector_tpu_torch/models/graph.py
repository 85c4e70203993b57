"""Vamana graph data model (device-resident tensors).

Port of `opensearch_jvector_tpu/models/graph.py`:

  adjacency : int32 [capacity, max_degree]   (-1 padded neighbor lists)
  degrees   : int32 [capacity]
  live      : bool  [capacity]               (False = deleted / hole)
  entry     : int                            (medoid ordinal)

Capacities stay powers of two: the on-disk format stores the used prefix
and readers re-pad to `bucket_capacity`, so both packages see the same
ordinal space.
"""

from __future__ import annotations

import dataclasses

import torch


def bucket_capacity(n: int, minimum: int = 64) -> int:
    """Graph capacity for n ordinals: next power of two (min `minimum`)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_rows(arr: torch.Tensor, capacity: int) -> torch.Tensor:
    """Zero-pad a row-indexed tensor to `capacity` rows."""
    n = arr.shape[0]
    if n >= capacity:
        return arr
    pad = arr.new_zeros((capacity - n, *arr.shape[1:]))
    return torch.cat([arr, pad])


@dataclasses.dataclass
class VamanaGraph:
    """Device-resident Vamana graph state.

    `upper_adjacency` is the hierarchy layer of the reference's format. It
    is read and written so segments round-trip, but searching it waits for
    the hierarchy port (ROADMAP queue 1, "Other quantizers").
    """

    adjacency: torch.Tensor  # int32 [capacity, max_degree], -1 padded
    degrees: torch.Tensor  # int32 [capacity]
    live: torch.Tensor  # bool [capacity]
    entry: int
    upper_adjacency: torch.Tensor | None = None  # int32 [capacity, m_up]

    @property
    def capacity(self) -> int:
        return self.adjacency.shape[0]

    @property
    def max_degree(self) -> int:
        return self.adjacency.shape[1]

    @staticmethod
    def flat(capacity: int, n_live: int,
             device: torch.device | str) -> "VamanaGraph":
        """Graph-less ('flat' index_type) placeholder: degree-1 all-(-1)
        rows, the first `n_live` ordinals live."""
        live = torch.zeros((capacity,), dtype=torch.bool, device=device)
        live[:n_live] = True
        return VamanaGraph(
            adjacency=torch.full((capacity, 1), -1, dtype=torch.int32,
                                 device=device),
            degrees=torch.zeros((capacity,), dtype=torch.int32,
                                device=device),
            live=live,
            entry=0,
        )

    @staticmethod
    def empty(capacity: int, max_degree: int,
              device: torch.device | str) -> "VamanaGraph":
        return VamanaGraph(
            adjacency=torch.full((capacity, max_degree), -1,
                                 dtype=torch.int32, device=device),
            degrees=torch.zeros((capacity,), dtype=torch.int32,
                                device=device),
            live=torch.zeros((capacity,), dtype=torch.bool, device=device),
            entry=0,
        )

    def with_capacity(self, new_capacity: int) -> "VamanaGraph":
        """Grow (never shrink) capacity, preserving contents."""
        if new_capacity <= self.capacity:
            return self
        pad = new_capacity - self.capacity

        def grown(t: torch.Tensor, fill) -> torch.Tensor:
            tail = t.new_full((pad, *t.shape[1:]), fill)
            return torch.cat([t, tail])

        return VamanaGraph(
            adjacency=grown(self.adjacency, -1),
            degrees=grown(self.degrees, 0),
            live=grown(self.live, False),
            entry=self.entry,
            upper_adjacency=(None if self.upper_adjacency is None
                             else grown(self.upper_adjacency, -1)),
        )
