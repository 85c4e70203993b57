"""NVQ (non-uniform vector quantization) transcode on tensors.

Port of `opensearch_jvector_tpu/ops/nvq.py`: the fast-sigmoid math of the
NVQ dequantizer (`logisticNQT` / `logitNQT`, bit-level) quantizes each
subvector's floats to bytes along a logistic companding curve; each
vector's subvector carries its own (growthRate, midpoint, minValue,
maxValue) and the global mean is subtracted before encoding.

Everything is elementwise over [n, M, dsub]. The parameter fit is the
reference's 7 x 5 grid search for the least reconstruction error, but the
grid is walked one point at a time with a running best (the first minimum
in growth-rate-major order, as the reference's argmin takes it) and the
rows are taken NVQ_CHUNK_BYTES of float32 at a time, so a large flush
never holds 35 copies of its corpus.

Parity with the reference: the two transforms and the decode of given
bytes and parameters agree to float32 rounding. The encode can differ
from the reference's compiled program where that program contracts
`value * alpha - alpha * x0` into a fused multiply-add: a last-place
difference that moves a `floor` or a `round` changes a byte by one, and
two grid points whose errors tie to rounding can swap.
"""

from __future__ import annotations

import torch

GR_GRID = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0)
MID_GRID = (0.25, 0.375, 0.5, 0.625, 0.75)
# float32 bytes of the rows one fit/encode/decode step works on
NVQ_CHUNK_BYTES = 1 << 26


def logistic_nqt(value: torch.Tensor, alpha: torch.Tensor,
                 x0: torch.Tensor) -> torch.Tensor:
    """Fast logistic: y = 2^p * m' with the fractional part folded through
    the mantissa, then y / (y + 1)."""
    temp = value * alpha - alpha * x0
    # Java Math.round(temp + 0.5f) == floor(temp + 1.0)
    p = torch.floor(temp + 1.0).to(torch.int32)
    m = ((temp - p.float()) * 0.5 + 1.0).view(torch.int32)
    t2 = (m + (p << 23)).view(torch.float32)
    return t2 / (t2 + 1.0)


def logit_nqt(scaled_value: torch.Tensor, inverse_alpha: torch.Tensor,
              x0: torch.Tensor) -> torch.Tensor:
    """Fast inverse logistic."""
    z = scaled_value / (1.0 - scaled_value)
    bits = z.view(torch.int32)
    p = (((bits & 0x7F800000) >> 23) - 128).float()
    m = ((bits & 0x007FFFFF) + 0x3F800000).view(torch.float32)
    return (m + p) * inverse_alpha + x0


def _sub_params(growth_rate, midpoint, min_v, max_v):
    """Derived per-subvector constants shared by encode and decode."""
    delta = max_v - min_v
    sgr = growth_rate / torch.where(delta == 0, 1.0, delta)
    smid = midpoint * delta
    bias = logistic_nqt(min_v, sgr, smid)
    scale = (logistic_nqt(max_v, sgr, smid) - bias) / 255.0
    return sgr, smid, bias, scale


def nvq_encode_subvector(x, growth_rate, midpoint, min_v, max_v):
    """Bytes (as float32 in [0, 255]) of subvectors x [..., dsub]; the
    parameters broadcast against x ([..., 1]).

    Forward transform: byte = round((logistic(x) - bias) / scale), rounded
    half to even."""
    sgr, smid, bias, scale = _sub_params(growth_rate, midpoint, min_v, max_v)
    y = logistic_nqt(x, sgr, smid)
    return torch.clamp(
        torch.round((y - bias) / torch.where(scale == 0, 1.0, scale)),
        0, 255)


def nvq_decode_subvector(b, growth_rate, midpoint, min_v, max_v):
    """Bytes b [..., dsub] (float32 values) back to floats."""
    sgr, smid, bias, scale = _sub_params(growth_rate, midpoint, min_v, max_v)
    scaled = b * scale + bias
    inv = 1.0 / torch.where(sgr == 0, 1.0, sgr)
    return logit_nqt(scaled, inv, smid)


def _chunk_rows(d: int) -> int:
    return max(1, NVQ_CHUNK_BYTES // (4 * max(d, 1)))


def _fit(xs: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor):
    """(growthRate, midpoint) [n, M, 1] each, for subvectors xs [n, M, dsub]
    with their min/max: the grid point of least mean squared reconstruction
    error, the first one where several tie."""
    best_err = torch.full_like(mn, float("inf"))
    best_gr = torch.zeros_like(mn)
    best_mid = torch.zeros_like(mn)
    for gr in GR_GRID:
        for mid in MID_GRID:
            g, c = mn.new_tensor(gr), mn.new_tensor(mid)
            b = nvq_encode_subvector(xs, g, c, mn, mx)
            rec = nvq_decode_subvector(b, g, c, mn, mx)
            err = torch.mean((rec - xs) ** 2, -1, keepdim=True)
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            best_gr = torch.where(take, g, best_gr)
            best_mid = torch.where(take, c, best_mid)
    return best_gr, best_mid


def nvq_encode(centered: torch.Tensor, num_subvectors: int):
    """Encode a corpus [n, d] (global mean removed) ->
    (bytes [n, d] uint8, params [n, M, 4] float32 =
    (growthRate, midpoint, minValue, maxValue)). The subvector split is
    contiguous equal slices: `num_subvectors` must divide d."""
    n, d = centered.shape
    m = num_subvectors
    dsub = d // m
    bytes_ = torch.empty((n, d), dtype=torch.uint8, device=centered.device)
    params = torch.empty((n, m, 4), dtype=torch.float32,
                         device=centered.device)
    step = _chunk_rows(d)
    for s in range(0, n, step):
        xs = centered[s: s + step].float().reshape(-1, m, dsub)
        mn = torch.amin(xs, -1, keepdim=True)
        mx = torch.amax(xs, -1, keepdim=True)
        gr, mid = _fit(xs, mn, mx)
        b = nvq_encode_subvector(xs, gr, mid, mn, mx)
        bytes_[s: s + step] = b.to(torch.uint8).reshape(-1, d)
        params[s: s + step] = torch.cat([gr, mid, mn, mx], -1)
    return bytes_, params


def nvq_decode(bytes_: torch.Tensor, params: torch.Tensor,
               global_mean: torch.Tensor, num_subvectors: int) -> torch.Tensor:
    """Reconstruct [n, d] float32 rows (adds the global mean back)."""
    n, d = bytes_.shape
    m = num_subvectors
    out = torch.empty((n, d), dtype=torch.float32, device=bytes_.device)
    step = _chunk_rows(d)
    for s in range(0, n, step):
        b = bytes_[s: s + step].reshape(-1, m, d // m).float()
        p = params[s: s + step]
        rec = nvq_decode_subvector(b, p[..., 0:1], p[..., 1:2], p[..., 2:3],
                                   p[..., 3:4])
        out[s: s + step] = rec.reshape(-1, d) + global_mean
    return out
