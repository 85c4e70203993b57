"""Operations and bytes of the graph walk over PQ codes (the `pq`
provider: NVQ segments' auxiliary PQ), from the walk's counts and the
configuration's shapes alone, whatever runs the walk (the plain loop
today, a kernel later).

Bytes: every row the walk scored read as its M code bytes, every
adjacency row it expanded (int32 ids), the queries read once (float32)
and the pools written once (int64 ids and float32 scores). Operations: a
score of d products and d sums a scored row, on float32 units outside the
tensor cores. `roofline.least_seconds` takes the larger over the card's
peaks (`peaks`).
"""

from __future__ import annotations

from portbench.work.roofline import F32, I32, I64


def codes_walk_bytes(visited: int, expanded: int, queries: int, dim: int,
                     subspaces: int, degree: int, pool: int) -> float:
    return (visited * subspaces + expanded * degree * I32
            + queries * dim * F32 + queries * pool * (I64 + F32))


def codes_walk_ops(visited: int, dim: int) -> float:
    return 2.0 * visited * dim
