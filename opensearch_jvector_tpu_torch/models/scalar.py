"""Scalar (binary / multi-bit) quantization.

Port of `opensearch_jvector_tpu/models/scalar.py`: a one-bit quantizer
(per-dimension mean threshold trained on a reservoir sample, 25,000 rows
by default), 2- and 4-bit quantizers (per-dimension quantile thresholds,
thermometer coded), the bit packer, the serializable `QuantizationState`
and the node-level `QuantizationStateCache` (bounded weight, expiry).

Training is host numpy, exactly the reference's, so thresholds are
bit-identical. Encoding runs on tensors (`thermometer_codes`), rows taken
a slab at a time, and gives the reference's bytes: d-major bit order, most
significant bit first, zero padded to whole bytes. Codes are scored by
Hamming distance (`ops.distances.hamming_scores`).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from opensearch_jvector_tpu_torch.ops.distances import hamming_scores

DEFAULT_SAMPLE_SIZE = 25_000  # reservoir sample default (reference)
# bytes of the [rows, levels, d] comparison one encode step holds
ENCODE_SLAB_BYTES = 1 << 28


def reservoir_sample(n: int, sample_size: int, seed: int = 0) -> np.ndarray:
    """Deterministic sample of row indices (Sampler parity)."""
    if n <= sample_size:
        return np.arange(n)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, sample_size, replace=False))


@dataclasses.dataclass
class QuantizationState:
    """Serializable trained thresholds: [levels, d] f32, levels = 2^bits - 1.

    For 1-bit this is the per-dimension mean; for 2/4-bit, evenly spaced
    quantiles of the training sample per dimension.
    """

    bits: int  # 1, 2 or 4
    thresholds: np.ndarray  # [levels, d]

    def nbytes(self) -> int:
        return self.thresholds.nbytes + 8

    def to_arrays(self) -> dict:
        return {"thresholds": self.thresholds,
                "bits": np.asarray([self.bits], np.int32)}

    @staticmethod
    def from_arrays(arrays: dict) -> "QuantizationState":
        return QuantizationState(
            bits=int(arrays["bits"][0]), thresholds=arrays["thresholds"]
        )


def train_scalar_quantizer(
    vectors: np.ndarray | torch.Tensor, bits: int = 1,
    sample_size: int = DEFAULT_SAMPLE_SIZE, seed: int = 0,
) -> QuantizationState:
    """Train per-dimension thresholds on a reservoir sample, on the host.
    Of a tensor only the sampled rows are copied to the host."""
    if bits not in (1, 2, 4):
        raise ValueError(f"bits must be 1, 2 or 4: {bits}")
    rows = reservoir_sample(vectors.shape[0], sample_size, seed)
    if isinstance(vectors, torch.Tensor):
        sample = vectors[torch.as_tensor(rows, device=vectors.device)]
        sample = sample.float().cpu().numpy()
    else:
        sample = np.asarray(vectors, np.float32)[rows]
    if bits == 1:
        thr = sample.mean(axis=0, keepdims=True)  # mean threshold (parity)
    else:
        levels = 2**bits - 1
        qs = np.linspace(0, 100, levels + 2)[1:-1]
        thr = np.percentile(sample, qs, axis=0).astype(np.float32)
    return QuantizationState(bits=bits, thresholds=thr.astype(np.float32))


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a [n, nb] 0/1 tensor into [n, ceil(nb/8)] uint8, most
    significant bit first (BitPacker)."""
    n, nb = bits.shape
    pad = (-nb) % 8
    b = torch.nn.functional.pad(bits.to(torch.uint8), (0, pad))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=bits.device)
    # eight distinct powers of two: the uint8 sum cannot overflow
    return (b.reshape(n, -1, 8) * weights).sum(-1, dtype=torch.uint8)


def thermometer_codes(vectors: torch.Tensor,
                      thresholds: torch.Tensor) -> torch.Tensor:
    """Rows [n, d] against thresholds [levels, d] -> bit-packed uint8 codes
    [n, ceil(d*levels/8)] on the rows' device.

    Multi-bit uses unary ("thermometer") coding across levels so Hamming
    distance approximates L2 rank order; bits are laid out d-major (all
    levels of dimension 0, then dimension 1, ...). Queries and stored rows
    are both encoded here, so their codes align."""
    levels, d = thresholds.shape
    n = vectors.shape[0]
    out = torch.empty((n, -(-(d * levels) // 8)), dtype=torch.uint8,
                      device=vectors.device)
    step = max(1, ENCODE_SLAB_BYTES // (levels * d))
    for s in range(0, n, step):
        v = vectors[s: s + step].float()
        above = v[:, :, None] > thresholds.T[None, :, :]  # [rows, d, levels]
        out[s: s + step] = _pack_bits(above.reshape(v.shape[0], -1))
    return out


def quantize_vectors(state: QuantizationState,
                     vectors: torch.Tensor) -> torch.Tensor:
    """Encode rows with a trained state -> packed uint8 codes (a tensor on
    the rows' device)."""
    thr = torch.from_numpy(np.ascontiguousarray(state.thresholds)).to(
        vectors.device)
    return thermometer_codes(vectors, thr)


def hamming_search(query_code: torch.Tensor, codes: torch.Tensor,
                   k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-k (ids, scores) by Hamming score over packed codes."""
    scores = hamming_scores(query_code, codes)
    top_s, top_i = torch.topk(scores, min(k, scores.shape[0]))
    return top_i.cpu().numpy(), top_s.cpu().numpy()


class QuantizationStateCache:
    """Bounded, expiring cache of trained quantization states.

    Max weight in bytes + time-based expiry, mirroring the node-level
    QuantizationStateCache (Guava maximumWeight + expireAfterAccess).
    """

    def __init__(self, max_bytes: int = 64 << 20, ttl_seconds: float = 3600.0):
        self.max_bytes = max_bytes
        self.ttl = ttl_seconds
        self._lock = threading.Lock()
        self._entries: dict[str, tuple[QuantizationState, float]] = {}
        self._weight = 0

    def get(self, key: str) -> QuantizationState | None:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                return None
            state, _ = hit
            self._entries[key] = (state, time.monotonic())
            return state

    def put(self, key: str, state: QuantizationState) -> None:
        with self._lock:
            if key in self._entries:
                self._weight -= self._entries[key][0].nbytes()
            self._entries[key] = (state, time.monotonic())
            self._weight += state.nbytes()
            self._evict_locked()

    def _evict_locked(self) -> None:
        now = time.monotonic()
        expired = [k for k, (_, t) in self._entries.items()
                   if now - t > self.ttl]
        for k in expired:
            self._weight -= self._entries.pop(k)[0].nbytes()
        while self._weight > self.max_bytes and self._entries:
            k = min(self._entries, key=lambda k: self._entries[k][1])
            self._weight -= self._entries.pop(k)[0].nbytes()

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "weight_bytes": self._weight}


# Node-level singleton (QuantizationStateCache parity): read_segment caches
# trained scalar states here so re-opens skip threshold deserialization.
SCALAR_STATE_CACHE = QuantizationStateCache()
