"""Plain reference for cosine k-NN over an NVQ-encoded corpus.

Plain PyTorch, independent of the program under test: it imports nothing
of it and takes only the rows and queries the benchmark made. TF32 is off
for every product here.

- `exact_topk`: the float64 cosine top k over the raw rows, recall's truth.
- `exact_scores`: the engine's cosine score (1 + cos) / 2, in float64, of
  each query and the NVQ reconstruction of each returned row. The rows
  are encoded here anew by NVQ's published definition (jVector's
  `NVQuantization` with the dequantizer of OpenSearch jVector's
  `JVectorIndexQuantization.java:319-361`):
  - the corpus's float32 mean is subtracted, and each row is cut into
    NUM_SUBVECTORS contiguous equal subvectors;
  - each subvector keeps its min and max, and the (growth rate, midpoint)
    of the 7 x 5 grid below whose reconstruction has the least mean
    squared error, the first in growth-rate-major order among ties;
  - a value's byte is round((logistic(x) - bias) / scale), half to even,
    through the bit-level fast logistic; the decode runs the bit-level
    fast logit back. Every float32 operation is rounded on its own (no
    fused multiply-add), as the program computes it.
- `control_topk`: the same search over the reconstructions in TF32
  (inputs rounded to TF32's 10-bit mantissa, float32 sums), the precision
  just below the float32 that the configuration states, put in the
  program's place to show that the comparison fails it.

The configurations that name this reference are one segment each, so the
corpus's mean is the segment's.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

NUM_SUBVECTORS = 2  # jVector's default, as the configuration states
GROWTH_RATES = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0)
MIDPOINTS = (0.25, 0.375, 0.5, 0.625, 0.75)
Q_BLOCK = 1024
ROW_BLOCK = 1 << 17
ENCODE_ROWS = 1 << 16  # rows a step of the encode and the decode holds
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


# -- NVQ ------------------------------------------------------------------

def logistic(x: torch.Tensor, alpha: torch.Tensor,
             x0: torch.Tensor) -> torch.Tensor:
    """The fast logistic of float32 `x`: t = alpha x - alpha x0, 2^t built
    from t's integer part p = floor(t + 1) (Java's round(t + 0.5)) in the
    exponent and (t - p) / 2 + 1 in the mantissa, then y / (y + 1)."""
    t = x * alpha - alpha * x0
    p = torch.floor(t + 1.0).to(torch.int32)
    m = ((t - p.float()) * 0.5 + 1.0).view(torch.int32)
    y = (m + (p << 23)).view(torch.float32)
    return y / (y + 1.0)


def logit(s: torch.Tensor, inv_alpha: torch.Tensor,
          x0: torch.Tensor) -> torch.Tensor:
    """The fast logit of float32 `s`: log2 of z = s / (1 - s) read from
    its bits (exponent - 128 plus the mantissa in [1, 2)), over alpha,
    plus x0."""
    z = s / (1.0 - s)
    bits = z.view(torch.int32)
    p = (((bits & 0x7F800000) >> 23) - 128).float()
    m = ((bits & 0x007FFFFF) + 0x3F800000).view(torch.float32)
    return (m + p) * inv_alpha + x0


def _curve(gr, mid, lo, hi):
    """(alpha, x0, bias, scale) of a subvector's companding curve."""
    span = hi - lo
    alpha = gr / torch.where(span == 0, 1.0, span)
    x0 = mid * span
    bias = logistic(lo, alpha, x0)
    scale = (logistic(hi, alpha, x0) - bias) / 255.0
    return alpha, x0, bias, scale


def _encode(x, gr, mid, lo, hi) -> torch.Tensor:
    """Bytes, as float32 in [0, 255], of subvectors `x` [..., dsub]."""
    alpha, x0, bias, scale = _curve(gr, mid, lo, hi)
    y = logistic(x, alpha, x0)
    return torch.clamp(torch.round(
        (y - bias) / torch.where(scale == 0, 1.0, scale)), 0, 255)


def _decode(b, gr, mid, lo, hi) -> torch.Tensor:
    alpha, x0, bias, scale = _curve(gr, mid, lo, hi)
    inv = 1.0 / torch.where(alpha == 0, 1.0, alpha)
    return logit(b * scale + bias, inv, x0)


def global_mean(rows: torch.Tensor) -> torch.Tensor:
    """The corpus's mean [d] in float32 (`torch.mean` over the rows)."""
    return torch.mean(rows.float(), 0)


def encode(rows: torch.Tensor, mean: torch.Tensor):
    """NVQ of float32 rows [n, d] -> (bytes [n, d] uint8, params [n, M, 4]
    float32: growth rate, midpoint, min, max)."""
    n, d = rows.shape
    m = NUM_SUBVECTORS
    out_b = torch.empty((n, d), dtype=torch.uint8, device=rows.device)
    out_p = torch.empty((n, m, 4), dtype=torch.float32, device=rows.device)
    for s in range(0, n, ENCODE_ROWS):
        x = (rows[s: s + ENCODE_ROWS].float() - mean).reshape(-1, m, d // m)
        lo = x.amin(-1, keepdim=True)
        hi = x.amax(-1, keepdim=True)
        best = torch.full_like(lo, float("inf"))
        gr = torch.zeros_like(lo)
        mid = torch.zeros_like(lo)
        for g in GROWTH_RATES:
            for c in MIDPOINTS:
                g_, c_ = lo.new_tensor(g), lo.new_tensor(c)
                rec = _decode(_encode(x, g_, c_, lo, hi), g_, c_, lo, hi)
                err = ((rec - x) ** 2).mean(-1, keepdim=True)
                take = err < best  # strictly: the first among ties stays
                best = torch.where(take, err, best)
                gr = torch.where(take, g_, gr)
                mid = torch.where(take, c_, mid)
        out_b[s: s + ENCODE_ROWS] = _encode(x, gr, mid, lo, hi).to(
            torch.uint8).reshape(-1, d)
        out_p[s: s + ENCODE_ROWS] = torch.cat([gr, mid, lo, hi], -1)
    return out_b, out_p


def decode(codes: torch.Tensor, params: torch.Tensor,
           mean: torch.Tensor) -> torch.Tensor:
    """Bytes [n, d] and params [n, M, 4] -> float32 rows [n, d]."""
    n, d = codes.shape
    m = params.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=codes.device)
    for s in range(0, n, ENCODE_ROWS):
        b = codes[s: s + ENCODE_ROWS].float().reshape(-1, m, d // m)
        p = params[s: s + ENCODE_ROWS]
        rec = _decode(b, p[..., 0:1], p[..., 1:2], p[..., 2:3], p[..., 3:4])
        out[s: s + ENCODE_ROWS] = rec.reshape(-1, d) + mean
    return out


def reconstruct(rows: torch.Tensor, ids: torch.Tensor | None = None,
                mean: torch.Tensor | None = None) -> torch.Tensor:
    """The NVQ reconstructions of rows `ids` (all rows by default) of the
    corpus `rows` [n, d] -> float32 [len(ids), d]."""
    mean = global_mean(rows) if mean is None else mean
    sel = rows if ids is None else rows[ids]
    return decode(*encode(sel, mean), mean)


# -- search -----------------------------------------------------------------

def _topk_blocks(rows: torch.Tensor, queries: torch.Tensor, k: int, score):
    """Largest-k of score(q, x) over row blocks -> (scores [Q, k], ids)."""
    out_s, out_i = [], []
    for qs in range(0, queries.shape[0], Q_BLOCK):
        q = queries[qs: qs + Q_BLOCK]
        best_s = best_i = None
        for rs in range(0, rows.shape[0], ROW_BLOCK):
            s = score(q, rows[rs: rs + ROW_BLOCK])
            ts, ti = torch.topk(s, min(k, s.shape[1]), dim=1)
            ti = ti + rs
            if best_s is not None:
                ts, order = torch.topk(torch.cat([best_s, ts], 1),
                                       min(k, best_s.shape[1] + ts.shape[1]),
                                       dim=1)
                ti = torch.gather(torch.cat([best_i, ti], 1), 1, order)
            best_s, best_i = ts, ti
        out_s.append(best_s)
        out_i.append(best_i)
    return torch.cat(out_s), torch.cat(out_i)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-300)


def _ip_float64(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    with _tf32(False):
        return q @ x.T


def _ip_tf32(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if q.is_cuda:
        with _tf32(True):
            return q @ x.T
    with _tf32(False):  # no TF32 unit on the host: round as the card does
        return round_to_tf32(q) @ round_to_tf32(x).T


def _on(device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.device(device))


def exact_topk(rows: np.ndarray, queries: np.ndarray, k: int, device):
    """Exact top-k rows by cosine over the raw rows -> (ids [Q, k] int64,
    cosines [Q, k] float64), nearest first."""
    x = _unit(_on(device, rows).double())
    q = _unit(_on(device, queries).double())
    cos, ids = _topk_blocks(x, q, k, _ip_float64)
    return ids.cpu().numpy(), cos.cpu().numpy()


def control_topk(rows: np.ndarray, queries: np.ndarray, k: int, device):
    """The TF32 control: top-k and scores over the NVQ reconstructions ->
    (ids [Q, k] int64, scores [Q, k] float32)."""
    rec = _unit(reconstruct(_on(device, rows)))
    q = _unit(_on(device, queries).float())
    ip, ids = _topk_blocks(rec, q, k, _ip_tf32)
    return ids.cpu().numpy(), ((1.0 + ip) / 2.0).float().cpu().numpy()


def exact_scores(rows: np.ndarray, queries: np.ndarray, qidx: np.ndarray,
                 ids: np.ndarray, device) -> np.ndarray:
    """float64 scores (1 + cos) / 2 of queries `qidx` [A] and the NVQ
    reconstructions of rows `ids` [A, k]; NaN where an id is not a row."""
    x = _on(device, rows)
    n, dim = x.shape
    i = torch.from_numpy(np.ascontiguousarray(ids)).to(x.device)
    valid = (i >= 0) & (i < n)
    uniq, slot = torch.unique(torch.where(valid, i, 0), return_inverse=True)
    rec = _unit(reconstruct(x, uniq).double())
    q = _unit(_on(device, queries).double())
    qi_all = torch.from_numpy(np.ascontiguousarray(qidx)).to(x.device)
    out = np.empty(ids.shape, np.float64)
    k = max(1, ids.shape[1])
    chunk = max(1, GATHER_BYTES // (8 * k * dim))
    for lo in range(0, ids.shape[0], chunk):
        r = rec[slot[lo: lo + chunk]]  # [a, k, d]
        qi = q[qi_all[lo: lo + chunk]]
        s = (1.0 + (r * qi[:, None, :]).sum(-1)) / 2.0
        s = torch.where(valid[lo: lo + chunk], s,
                        torch.full_like(s, float("nan")))
        out[lo: lo + chunk] = s.cpu().numpy()
    return out
