"""Product quantization model (codebooks + codes).

Port of `opensearch_jvector_tpu/models/pq.py` for plain (isotropic) PQ:
  * k-means++ per subspace, <=256 clusters => 1 byte/code
  * global-mean centering for EUCLIDEAN, normalized training for COSINE
  * the reference's dimension-adaptive default subspace count
  * host-resident corpora (numpy) train on a host sample and encode in
    streamed chunks, so the corpus never has to fit on the device
  * `refine_pq` adapts a merge's leading codebooks to the merged rows
Anisotropic codebooks wait (ROADMAP queue 1, "Other quantizers").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opensearch_jvector_tpu_torch.ops import adc as adc_ops
from opensearch_jvector_tpu_torch.ops.adc_kernel import adc_scan
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.ops.kmeans import (
    lloyd_iters,
    train_kmeans_subspaces,
)


def default_num_subspaces(dim: int) -> int:
    """Dimension-adaptive PQ subspace count (bytes/vector strictly
    increasing with dim), snapped down to a divisor of dim."""
    if dim <= 32:
        m = dim
    elif dim <= 64:
        m = 32
    elif dim <= 200:
        m = int(dim * 0.5)
    elif dim <= 400:
        m = 100
    elif dim <= 768:
        m = int(dim * 0.25)
    elif dim <= 1536:
        m = 192
    else:
        m = int(dim * 0.125)
    while dim % m != 0:
        m -= 1
    return max(m, 1)


@dataclasses.dataclass
class ProductQuantization:
    """Trained PQ state: codebooks + the global centering vector."""

    codebooks: torch.Tensor  # [M, K, dsub] f32
    center: torch.Tensor  # [d] f32 (zeros when centering disabled)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.sum(v * v, -1, keepdim=True) + 1e-30)


def _preprocess(vectors: torch.Tensor, simf: SimilarityFunction):
    """Training-space transform: centering (L2) / normalize (cosine)."""
    zeros = torch.zeros((vectors.shape[1],), dtype=torch.float32,
                        device=vectors.device)
    if simf is SimilarityFunction.COSINE:
        return _normalize(vectors), zeros
    if simf is SimilarityFunction.EUCLIDEAN:
        c = torch.mean(vectors, 0)
        return vectors - c, c
    return vectors, zeros


TRAIN_ITERS = 8  # Lloyd iterations after k-means++ seeding
TRAIN_SEED = 0


def _train_sample(n: int, max_train: int,
                  seed: int = TRAIN_SEED) -> np.ndarray:
    """The sorted row sample training reads (the reference's draw)."""
    return np.sort(np.random.default_rng(seed).choice(
        n, max_train, replace=False))


def train_pq(
    vectors: torch.Tensor | np.ndarray,  # [n, d] float32
    simf: SimilarityFunction,
    num_subspaces: int | None = None,
    max_train: int = 131072,
    device: torch.device | str | None = None,  # for a numpy corpus
) -> ProductQuantization:
    """Train PQ codebooks (k-means++ + Lloyd per subspace), K = min(256, n).

    Training samples `max_train` rows with
    `np.random.default_rng(TRAIN_SEED)`, as the reference does. For a
    tensor the center is the mean of ALL rows. A numpy (host-resident)
    corpus is sampled on the host BEFORE centering and only the sample is
    uploaded to `device`, so its center is the sample mean — the
    reference's rule for host corpora (flat ingest)."""
    n, d = vectors.shape
    m = num_subspaces or default_num_subspaces(d)
    if d % m != 0:
        raise ValueError(f"num_subspaces {m} must divide dim {d}")
    k = min(256, n)
    if isinstance(vectors, np.ndarray):
        if n > max_train:
            vectors = vectors[_train_sample(n, max_train)]
        vectors = torch.from_numpy(
            np.ascontiguousarray(vectors, np.float32)).to(device)
    x, center = _preprocess(vectors.float(), simf)
    if x.shape[0] > max_train:
        x = x[torch.as_tensor(_train_sample(n, max_train), device=x.device)]
    x_sub = x.reshape(-1, m, d // m).transpose(0, 1).contiguous()
    gen = torch.Generator(device=vectors.device).manual_seed(TRAIN_SEED)
    codebooks = train_kmeans_subspaces(x_sub, k, TRAIN_ITERS, gen)
    return ProductQuantization(codebooks=codebooks, center=center)


def refine_pq(
    pq: ProductQuantization,
    vectors: torch.Tensor | np.ndarray,  # [n, d] float32
    simf: SimilarityFunction,
    iters: int = 2,
    max_train: int = 131072,
    seed: int = 0,
) -> ProductQuantization:
    """Codebook refinement: `iters` Lloyd iterations seeded from `pq`'s
    codebooks over at most `max_train` rows (the reference's draw), so a
    merge adapts the leading segment's codebooks to the merged rows
    instead of reusing them verbatim or training afresh.

    As in `train_pq`, a numpy (host) corpus is sampled on the host and only
    the sample is uploaded to the codebooks' device, so its center is the
    sample mean; a tensor's center is the mean of all its rows."""
    n, d = vectors.shape
    m, _, dsub = pq.codebooks.shape
    if isinstance(vectors, np.ndarray):
        if n > max_train:
            vectors = vectors[_train_sample(n, max_train, seed)]
        vectors = torch.from_numpy(np.ascontiguousarray(
            vectors, np.float32)).to(pq.codebooks.device)
    x, center = _preprocess(vectors.float(), simf)
    if x.shape[0] > max_train:
        x = x[torch.as_tensor(_train_sample(n, max_train, seed),
                              device=x.device)]
    x_sub = x.reshape(-1, m, dsub).transpose(0, 1).contiguous()
    return ProductQuantization(
        codebooks=lloyd_iters(x_sub, pq.codebooks, iters), center=center)


DECODE_ROWS = 1 << 18  # rows per decode step

# Rows per encode step: bounds the [M, rows, K] distance slab (~512 MiB at
# M=64, K=256). The codes do not depend on it.
ENCODE_SLAB_BYTES = 1 << 29


def encode_pq(pq: ProductQuantization, vectors: torch.Tensor) -> torch.Tensor:
    """Encode [n, d] -> codes [n, M] uint8 (nearest centroid per subspace).

    argmin over ||c||^2 - 2 x.c (||x||^2 is constant in the argmin), the
    reference's formula, in full float32."""
    n = vectors.shape[0]
    m, k, dsub = pq.codebooks.shape
    c2 = torch.sum(pq.codebooks * pq.codebooks, -1).unsqueeze(1)  # [M, 1, K]
    step = max(1, ENCODE_SLAB_BYTES // (m * k * 4))
    out = torch.empty((n, m), dtype=torch.uint8, device=vectors.device)
    for s in range(0, n, step):
        x = vectors[s: s + step] - pq.center
        x_sub = x.reshape(-1, m, dsub).transpose(0, 1)  # [M, rows, dsub]
        dots = torch.bmm(x_sub, pq.codebooks.transpose(1, 2))  # [M, rows, K]
        out[s: s + step] = torch.argmin(c2 - 2.0 * dots, dim=2).T.to(
            torch.uint8)
    return out


# Rows of a host (numpy) corpus uploaded per encode step.
HOST_ENCODE_ROWS = 1 << 16


def encode(pq: ProductQuantization, vectors: torch.Tensor | np.ndarray,
           simf: SimilarityFunction) -> torch.Tensor:
    """Encode a corpus on the codebooks' device; cosine corpora are encoded
    normalized. A numpy corpus is streamed to the device in chunks of
    HOST_ENCODE_ROWS rows."""
    if isinstance(vectors, np.ndarray):
        dev = pq.codebooks.device
        out = torch.empty((vectors.shape[0], pq.codebooks.shape[0]),
                          dtype=torch.uint8, device=dev)
        for s in range(0, vectors.shape[0], HOST_ENCODE_ROWS):
            chunk = torch.from_numpy(np.ascontiguousarray(
                vectors[s: s + HOST_ENCODE_ROWS], np.float32)).to(dev)
            out[s: s + chunk.shape[0]] = encode(pq, chunk, simf)
        return out
    if simf is SimilarityFunction.COSINE:
        vectors = _normalize(vectors)
    return encode_pq(pq, vectors)


@dataclasses.dataclass
class PQVectors:
    """PQ-encoded corpus: the device-resident approximate phase storage."""

    pq: ProductQuantization
    codes: torch.Tensor  # [n, M] uint8

    def decode(self, dtype=torch.float32) -> torch.Tensor:
        """Approximate reconstruction [n, d] (centroid lookup + un-center).

        Decoded DECODE_ROWS rows at a time: the float32 gather is 4*d
        bytes per row, so a one-shot decode of a large segment would hold
        several copies of the corpus."""
        m, _, dsub = self.pq.codebooks.shape
        n = self.codes.shape[0]
        sub = torch.arange(m, device=self.codes.device)
        out = torch.empty((n, m * dsub), dtype=dtype,
                          device=self.codes.device)
        for s in range(0, n, DECODE_ROWS):
            idx = self.codes[s: s + DECODE_ROWS].long()  # not a bool mask
            flat = self.pq.codebooks[sub, idx].reshape(idx.shape[0], -1)
            out[s: s + idx.shape[0]] = flat + self.pq.center
        return out

    def decode_bf16(self) -> torch.Tensor:
        """Decoded-candidate cache [n, d] bf16: the on_disk tier's scan
        and beam scoring source when device memory allows (2*d bytes per
        row against 4*d for fp32 rows, which stay on the host)."""
        return self.decode(dtype=torch.bfloat16)

    def build_query_luts(self, queries: torch.Tensor,
                         simf: SimilarityFunction) -> torch.Tensor:
        """Per-query ADC lookup tables [Q, M, K]: center/normalize the
        queries, score every centroid."""
        q = queries - self.pq.center
        if simf is SimilarityFunction.COSINE:
            q = _normalize(q)
        m, _, dsub = self.pq.codebooks.shape
        qsub = q.reshape(q.shape[0], m, dsub)
        return adc_ops.build_luts(qsub, self.pq.codebooks, simf.is_euclidean)

    def score_scan(self, queries: torch.Tensor, simf: SimilarityFunction,
                   lo: int = 0, hi: int | None = None) -> torch.Tensor:
        """Full-scan ADC scores [Q, hi-lo] through the fused ADC scan, the
        score map in its epilogue."""
        luts = self.build_query_luts(queries, simf)
        return adc_scan(luts, self.codes[lo:hi], simf)
