"""Memory circuit breaker: refuse work that would blow device memory.

Port of `opensearch_jvector_tpu/utils/circuit_breaker.py`. Before building
or loading a segment, estimate its device footprint and trip the breaker
when the configured fraction of device memory would be exceeded. Device
memory comes from `torch.cuda.mem_get_info` and the caching allocator's
counters; for CPU tensors there is no
device budget and the check passes.
"""

from __future__ import annotations

import torch

from opensearch_jvector_tpu_torch.api.settings import (
    GLOBAL_SETTINGS,
    SettingsRegistry,
)


class CircuitBreakerException(RuntimeError):
    pass


class MemoryCircuitBreaker:
    def __init__(self, settings: SettingsRegistry = GLOBAL_SETTINGS):
        self.settings = settings
        self.tripped = False  # the cluster-level "triggered" flag analog

    @staticmethod
    def device_memory(device: torch.device) -> tuple[int, int] | None:
        """(total, in use) bytes of a CUDA device; None for the CPU.

        In use = this process's live tensors plus what other processes
        hold; blocks PyTorch's caching allocator keeps free for reuse do
        not count."""
        if device.type != "cuda":
            return None
        free, total = torch.cuda.mem_get_info(device)
        others = total - free - torch.cuda.memory_reserved(device)
        return int(total), int(torch.cuda.memory_allocated(device) + others)

    @staticmethod
    def estimate_segment_bytes(n: int, dim: int, max_degree: int,
                               overflow: float = 1.2,
                               pq_subspaces: int | None = None,
                               keep_fp32: bool = True) -> int:
        """Device footprint of a segment: vectors + adjacency + codes."""
        total = 0
        if keep_fp32:
            total += n * dim * 4
        total += n * int(max_degree * overflow) * 4  # adjacency int32
        if pq_subspaces:
            total += n * pq_subspaces  # uint8 codes
            total += pq_subspaces * 256 * (dim // max(pq_subspaces, 1)) * 4
        return total

    def check(self, additional_bytes: int, device: torch.device) -> None:
        """Raise CircuitBreakerException if the allocation would trip."""
        if not self.settings.get("knn.memory.circuit_breaker.enabled"):
            return
        mem = self.device_memory(torch.device(device))
        if mem is None:
            return
        limit_total, in_use = mem
        frac = self.settings.get("knn.memory.circuit_breaker.limit") / 100.0
        budget = int(limit_total * frac)
        projected = in_use + additional_bytes
        if projected > budget:
            self.tripped = True
            raise CircuitBreakerException(
                f"knn memory circuit breaker: projected {projected >> 20} MiB "
                f"exceeds budget {budget >> 20} MiB "
                f"({self.settings.get('knn.memory.circuit_breaker.limit')}% "
                f"of {limit_total >> 20} MiB)"
            )
        self.tripped = False


BREAKER = MemoryCircuitBreaker()
