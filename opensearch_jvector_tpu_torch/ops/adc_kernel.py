"""Fused ADC scan: the wrapper of the CUDA kernel `csrc/adc_scan.cu`.

Port of `opensearch_jvector_tpu/ops/pallas/adc_kernel.py:fused_adc_scan`.
`adc_scan(luts, codes)` returns `out[q, n] = sum_m luts[q, m, codes[n, m]]`
as [Q, N] float32:

  * on CUDA tensors it launches the hand-written kernel on the current
    stream (tables rounded to bf16, sums in float32 — the TPU kernel's
    numerics) and raises on any input the kernel does not take;
  * on CPU tensors it runs the plain version, `ops.adc.lookup_scan`
    (float32 tables). That is the only case the plain version serves.

Tolerance of the kernel against the plain version: each table entry is
rounded to bf16 (relative error <= 2^-9), so a sum of M entries may move by
up to 2^-9 * sum_m |entry|. `kernel_error_bound` gives twice that per
output element (the margin covers the float32 summation order), and the
checks hold every element to it.

`adc_scan.launches` counts kernel launches (and nothing else), so a run can
show that its search path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from opensearch_jvector_tpu_torch.ops import _kernels
from opensearch_jvector_tpu_torch.ops.adc import lookup_scan

SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may opt in to
TABLE_SLOTS = 256  # table slots per subspace in the kernel (one per byte)
MAX_GRID_Y = 65535


def kernel_error_bound(luts: torch.Tensor,
                       codes: torch.Tensor) -> torch.Tensor:
    """[Q, N] bound on |kernel - plain|: 2^-8 * sum_m |luts[q, m, codes[n, m]]|,
    twice the bf16 rounding of the M entries each sum reads."""
    return lookup_scan(luts.abs(), codes) * 2.0**-8


def pick_group(m: int) -> int:
    """Queries per block: the largest of 4, 2, 1 whose bf16 tables fit."""
    for g in (4, 2, 1):
        if m * TABLE_SLOTS * g * 2 <= SMEM_LIMIT:
            return g
    raise ValueError(
        f"adc_scan: {m} subspaces need {m * TABLE_SLOTS * 2} bytes of "
        f"tables per query, more than a block's {SMEM_LIMIT}")


def _bind() -> ctypes.CDLL:
    lib = _kernels.load("adc_scan")
    fn = lib.adc_scan_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def adc_scan(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Accumulated ADC values for every code row: -> [Q, N] float32."""
    if luts.device.type == "cpu" and codes.device.type == "cpu":
        return lookup_scan(luts, codes)
    if not (luts.is_cuda and codes.is_cuda and luts.device == codes.device):
        raise ValueError(
            f"adc_scan: luts on {luts.device} and codes on {codes.device}; "
            "both must be on one CUDA device (or both on the CPU)")
    if luts.dtype != torch.float32 or luts.dim() != 3:
        raise ValueError(f"adc_scan: luts must be [Q, M, K] float32, got "
                         f"{tuple(luts.shape)} {luts.dtype}")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"adc_scan: codes must be [N, M] uint8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    q, m, k = luts.shape
    n = codes.shape[0]
    if codes.shape[1] != m:
        raise ValueError(f"adc_scan: codes have {codes.shape[1]} subspaces, "
                         f"luts {m}")
    if not 1 <= k <= TABLE_SLOTS:
        raise ValueError(f"adc_scan: K={k} must be in [1, {TABLE_SLOTS}]")
    if not (luts.is_contiguous() and codes.is_contiguous()):
        raise ValueError("adc_scan: luts and codes must be contiguous")
    group = pick_group(m)
    if -(-q // group) > MAX_GRID_Y or n >= 2**31 or m == 0:
        raise ValueError(f"adc_scan: shape Q={q} N={n} M={m} out of range")
    out = torch.empty((q, n), dtype=torch.float32, device=luts.device)
    if q == 0 or n == 0:
        return out
    lib = _bind()
    stream = torch.cuda.current_stream(luts.device).cuda_stream
    with torch.cuda.device(luts.device):
        err = lib.adc_scan_launch(luts.data_ptr(), codes.data_ptr(),
                                  out.data_ptr(), q, m, k, n, group, stream)
    if err != 0:
        raise RuntimeError(f"adc_scan: kernel launch failed, cudaError {err}")
    adc_scan.launches += 1
    return out


adc_scan.launches = 0
