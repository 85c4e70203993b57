"""NVQ quantization model (per-vector nonlinear scalar quantization).

Port of `opensearch_jvector_tpu/models/nvq.py`. NVQ replaces a graph
segment's fp32 rows with 1 byte per dimension plus 16 bytes of parameters
per subvector; an auxiliary PQ is always trained beside it for the graph
traversal ("nvq+pq": there is no NVQ without PQ), and the NVQ-decoded rows
serve the rerank phase.
"""

from __future__ import annotations

import dataclasses

import torch

from opensearch_jvector_tpu_torch.ops import nvq as nvq_ops

DEFAULT_NUM_SUBVECTORS = 2  # reference default (KNNConstants.java:114)


@dataclasses.dataclass
class NVQVectors:
    """NVQ-encoded corpus, all three tensors on one device."""

    bytes_: torch.Tensor  # [n, d] uint8
    params: torch.Tensor  # [n, M, 4] f32 (growthRate, midpoint, min, max)
    global_mean: torch.Tensor  # [d] f32

    @property
    def num_subvectors(self) -> int:
        return self.params.shape[1]

    @property
    def device(self) -> torch.device:
        return self.bytes_.device

    def decode(self) -> torch.Tensor:
        """Dequantize the whole corpus -> [n, d] f32."""
        return nvq_ops.nvq_decode(self.bytes_, self.params, self.global_mean,
                                  self.num_subvectors)

    def decode_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """Dequantize the rows `ids` [...] -> [..., d] f32 (the rerank's
        source): the bytes and parameters are gathered, then decoded."""
        d = self.bytes_.shape[1]
        flat = ids.reshape(-1)
        out = nvq_ops.nvq_decode(self.bytes_[flat], self.params[flat],
                                 self.global_mean, self.num_subvectors)
        return out.reshape(*ids.shape, d)


def train_nvq(vectors: torch.Tensor,  # [n, d] on the target device
              num_subvectors: int = DEFAULT_NUM_SUBVECTORS) -> NVQVectors:
    """Fit + encode the corpus (global-mean centering, per-subvector fit)."""
    d = vectors.shape[1]
    m = num_subvectors
    while d % m != 0:  # the subvector split must tile the dimension evenly
        m -= 1
    vectors = vectors.float()
    mean = torch.mean(vectors, 0)
    bytes_, params = nvq_ops.nvq_encode(vectors - mean, m)
    return NVQVectors(bytes_=bytes_, params=params, global_mean=mean)


def reconstruction_mse(nvq: NVQVectors, vectors: torch.Tensor) -> torch.Tensor:
    return torch.mean((nvq.decode() - vectors.float()) ** 2)
