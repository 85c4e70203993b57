"""Plain reference for euclidean k-NN: exact top-k and exact scores.

Plain PyTorch, independent of the program under test: it imports nothing
of it and takes only the rows and queries the benchmark made. Distances
are computed in float64, in blocks, so the ground truth is exact; the
score of a row is the engine's euclidean score 1 / (1 + ||q - x||^2).
TF32 is off for every product here.

`control_topk` is the same search in TF32 (inputs rounded to TF32's
10-bit mantissa, float32 sums): the precision just below the float32 that
the configurations state, put in the program's place to show that the
comparison fails it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

Q_BLOCK = 1024
ROW_BLOCK = 1 << 17
GATHER_BYTES = 1 << 29  # float64 bytes of gathered rows per chunk


@contextlib.contextmanager
def _tf32(enabled: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _topk_blocks(rows: torch.Tensor, queries: torch.Tensor, k: int,
                 d2_block):
    """Smallest-k of d2_block(q, x) over row blocks -> (d2 [Q, k], ids)."""
    n = rows.shape[0]
    out_d, out_i = [], []
    for qs in range(0, queries.shape[0], Q_BLOCK):
        q = queries[qs: qs + Q_BLOCK]
        best_d = best_i = None
        for rs in range(0, n, ROW_BLOCK):
            d2 = d2_block(q, rows[rs: rs + ROW_BLOCK])
            td, ti = torch.topk(d2, min(k, d2.shape[1]), dim=1,
                                largest=False)
            ti = ti + rs
            if best_d is not None:
                td = torch.cat([best_d, td], 1)
                ti = torch.cat([best_i, ti], 1)
                td, order = torch.topk(td, min(k, td.shape[1]), dim=1,
                                       largest=False)
                ti = torch.gather(ti, 1, order)
            best_d, best_i = td, ti
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def _d2_float64(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    q, x = q.double(), x.double()
    with _tf32(False):
        return ((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
                - 2.0 * (q @ x.T))


def _d2_tf32(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if q.is_cuda:
        with _tf32(True):
            ip = q @ x.T
    else:  # no TF32 unit on the host: round the inputs as the card does
        with _tf32(False):
            ip = round_to_tf32(q) @ round_to_tf32(x).T
    return (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * ip


def exact_topk(rows: np.ndarray, queries: np.ndarray, k: int, device):
    """Exact top-k rows by euclidean distance -> (ids [Q, k] int64,
    squared distances [Q, k] float64), nearest first."""
    dev = torch.device(device)
    x = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    d2, ids = _topk_blocks(x, q, k, _d2_float64)
    return ids.cpu().numpy(), d2.cpu().numpy()


def control_topk(rows: np.ndarray, queries: np.ndarray, k: int, device):
    """The TF32 control: top-k and scores -> (ids [Q, k] int64, scores
    [Q, k] float32)."""
    dev = torch.device(device)
    x = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    d2, ids = _topk_blocks(x, q, k, _d2_tf32)
    scores = 1.0 / (1.0 + d2.clamp_min(0.0))
    return ids.cpu().numpy(), scores.float().cpu().numpy()


def exact_scores(rows: np.ndarray, queries: np.ndarray, qidx: np.ndarray,
                 ids: np.ndarray, device) -> np.ndarray:
    """float64 scores of rows `ids` [A, k] for queries `qidx` [A], by
    direct differences; NaN where an id is not a row."""
    dev = torch.device(device)
    n, dim = rows.shape
    x = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    out = np.empty(ids.shape, np.float64)
    k = max(1, ids.shape[1])
    chunk = max(1, GATHER_BYTES // (8 * k * dim))
    for lo in range(0, ids.shape[0], chunk):
        i = torch.from_numpy(ids[lo: lo + chunk]).to(dev)
        valid = (i >= 0) & (i < n)
        xi = x[i.clamp(0, n - 1)].double()
        qi = q[torch.from_numpy(qidx[lo: lo + chunk]).to(dev)].double()
        d2 = ((xi - qi[:, None, :]) ** 2).sum(-1)
        s = torch.where(valid, 1.0 / (1.0 + d2),
                        torch.full_like(d2, float("nan")))
        out[lo: lo + chunk] = s.cpu().numpy()
    return out
