"""ADC (asymmetric distance computation) for PQ search.

Port of `opensearch_jvector_tpu/ops/adc.py`:
  1. `build_luts` — per-query lookup tables [Q, M, K]: partial scores of
     each query subvector against every centroid of its subspace.
  2. `lookup_scan` — the plain PyTorch version of the fused ADC scan
     (`out[q, n] = sum_m luts[q, m, codes[n, m]]`). The CUDA kernel in
     `ops/adc_kernel.py` computes the same thing and is held against it.
     `lookup_candidates` does the same over per-query candidate codes.

Raw accumulated value convention (matches the PQ training space):
  EUCLIDEAN:    sum of per-subspace squared distances  -> score 1/(1+sum)
  DOT_PRODUCT:  sum of per-subspace dots               -> score (1+sum)/2
  COSINE:       handled as DOT_PRODUCT over pre-normalized vectors
"""

from __future__ import annotations

import torch

from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction


def build_luts(
    query_sub: torch.Tensor,  # [Q, M, dsub] query split into subvectors
    codebooks: torch.Tensor,  # [M, K, dsub]
    euclidean: bool,
) -> torch.Tensor:
    """Per-query ADC lookup tables [Q, M, K] (full float32)."""
    # [M, Q, dsub] @ [M, dsub, K] -> [M, Q, K]: one batched matmul
    dots = torch.bmm(query_sub.transpose(0, 1),
                     codebooks.transpose(1, 2)).transpose(0, 1)
    if not euclidean:
        return dots.contiguous()
    q2 = torch.sum(query_sub * query_sub, -1).unsqueeze(-1)  # [Q, M, 1]
    c2 = torch.sum(codebooks * codebooks, -1).unsqueeze(0)  # [1, M, K]
    return torch.clamp(q2 + c2 - 2.0 * dots, min=0.0)


def lookup_scan(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Accumulate ADC values for ALL code rows: [Q, M, K] x [N, M] -> [Q, N].

    Sums the subspaces in order 0..M-1 in float32, as the reference's
    `lookup_scan` does. Codes are widened with `.long()`: a uint8 index
    tensor would be read as a boolean mask, not gathered.
    """
    q, m, _ = luts.shape
    idx = codes.long()
    acc = torch.zeros((q, codes.shape[0]), dtype=torch.float32,
                      device=luts.device)
    for mi in range(m):
        acc += luts[:, mi, :][:, idx[:, mi]]
    return acc


def lookup_candidates(luts: torch.Tensor,
                      codes: torch.Tensor) -> torch.Tensor:
    """Accumulate ADC values for per-query candidate code rows:
    luts [Q, M, K], codes [Q, C, M] -> [Q, C] float32."""
    idx = codes.long().transpose(1, 2)  # [Q, M, C]
    return torch.gather(luts.float(), 2, idx).sum(1)


def adc_value_to_score(values: torch.Tensor,
                       simf: SimilarityFunction) -> torch.Tensor:
    """Map accumulated ADC values to graph scores (higher = better)."""
    if simf is SimilarityFunction.EUCLIDEAN:
        return 1.0 / (1.0 + values)
    return (1.0 + values) / 2.0
