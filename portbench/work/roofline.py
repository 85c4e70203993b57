"""Operations and bytes of the measured kernels and phases, from shapes
and counts alone, and the least time they allow on the card.

Each input byte is counted once and each output byte once, whatever a
kernel reads again; where the work depends on the data (a graph walk), it
is what these inputs needed (the rows the walk scored), not the most it
could.
"""

from __future__ import annotations

from portbench.work import peaks

F32, I32, I64 = 4, 4, 8


def least_seconds(nbytes: float, ops: float = 0.0,
                  peak_ops: float = peaks.BF16_FLOP_S) -> float:
    """The larger of bytes over the memory rate and operations over the
    peak rate for their type."""
    return max(nbytes / peaks.BYTES_S, ops / peak_ops)


def beam_search_bytes(visited: int, expanded: int, queries: int, dim: int,
                      degree: int, pool: int) -> float:
    """One beam-search launch set: every row the walks scored (float32),
    every adjacency row they expanded (int32 ids), the queries read once
    and the pools written once (int64 ids and float32 scores)."""
    return (visited * dim * F32 + expanded * degree * I32
            + queries * dim * F32 + queries * pool * (I64 + F32))


def scan_ops(queries: int, rows: int, dim: int) -> float:
    """A dense scan of every row by every query: 2 * Q * N * d."""
    return 2.0 * queries * rows * dim


def pq_scan_bytes(queries: int, rows: int, dim: int, subspaces: int,
                  centroids: int = 256) -> float:
    """An approximate phase over PQ codes: the codes (one byte a subspace
    a row), the float32 codebooks and the float32 queries, each read once."""
    return (rows * subspaces + centroids * dim * F32 + queries * dim * F32)
