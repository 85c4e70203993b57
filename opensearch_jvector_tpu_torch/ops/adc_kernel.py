"""Fused ADC scan: the wrapper of the CUDA kernel `csrc/adc_scan.cu`.

Port of `opensearch_jvector_tpu/ops/pallas/adc_kernel.py:fused_adc_scan`.
`adc_scan(luts, codes)` returns `out[q, n] = sum_m luts[q, m, codes[n, m]]`
as [Q, N] float32. With `simf` the epilogue maps each sum to its score
(`ops.adc.adc_value_to_score`), and with `valid` ([N] bool) rows whose entry
is False come out as -inf, so a caller's slab is written once, already
scored and masked:

  * on CUDA tensors it launches the hand-written kernel on the current
    stream (tables rounded to bf16, sums in float32 over m = 0 .. M-1 in
    order — the TPU kernel's numerics — then the map in float32 with IEEE
    division) and raises on any input the kernel does not take;
  * on CPU tensors it runs the plain version, `adc_scan_reference`
    (`lookup_scan` over float32 tables, then the map, then the mask). That
    is the only case the plain version serves.

What bounds the kernel on an H100 is the shared-memory pipe, not device
memory: its 8-byte table gathers (one entry for 4 queries) meet bank
conflicts on random codes, about 24 wavefronts per 512 lookups. The TPU's
one-hot tensor-core form (2 * K operations per lookup, 4.4 ms at the bf16
peak at Q=512, N=2^18, M=64) and a conflict-free form with one query per
lane (32 queries' tables of a subspace do not fit in shared memory at M=64)
were ruled out; the source note has the reckoning.

Tolerance of the kernel against the plain version: each table entry is
rounded to bf16 (relative error <= 2^-9), so a sum of M entries may move by
up to 2^-9 * sum_m |entry|. `kernel_error_bound` gives twice that per
output element (the margin covers the float32 summation order), and the
checks hold every raw element to it. The map is computed the same way by
the kernel and by `adc_value_to_score`, so the fused mode equals the raw
kernel mapped and masked exactly.

`adc_scan.launches` counts the calls that launched the kernels (one per
call: each launches the prep kernel, then the scan kernel) and nothing
else, so a run can show that its search path went through them.
"""

from __future__ import annotations

import ctypes

import torch

from opensearch_jvector_tpu_torch.ops import _kernels
from opensearch_jvector_tpu_torch.ops.adc import (
    adc_value_to_score,
    lookup_scan,
)
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction

SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may opt in to
TABLE_SLOTS = 256  # table slots per subspace in the kernel (one per byte)
MAX_GRID_Y = 65535
NEG_INF = float("-inf")


def kernel_error_bound(luts: torch.Tensor,
                       codes: torch.Tensor) -> torch.Tensor:
    """[Q, N] bound on |kernel - plain|: 2^-8 * sum_m |luts[q, m, codes[n, m]]|,
    twice the bf16 rounding of the M entries each sum reads."""
    return lookup_scan(luts.abs(), codes) * 2.0**-8


def pick_group(m: int, q: int | None = None) -> int:
    """Queries per block: the largest of 4, 2, 1 whose bf16 tables fit and
    that `q` queries fill more than half of (1 for one query, 2 for two)."""
    for g in (4, 2, 1):
        fill = q is None or 2 * q > g or g == 1
        if fill and m * TABLE_SLOTS * g * 2 <= SMEM_LIMIT:
            return g
    raise ValueError(
        f"adc_scan: {m} subspaces need {m * TABLE_SLOTS * 2} bytes of "
        f"tables per query, more than a block's {SMEM_LIMIT}")


def _score_mode(simf: SimilarityFunction | None) -> int:
    """The kernel's epilogue mode: 0 raw, 1 euclidean, 2 dot / cosine (the
    cases of `adc_value_to_score`)."""
    if simf is None:
        return 0
    return 1 if simf is SimilarityFunction.EUCLIDEAN else 2


def adc_scan_reference(luts: torch.Tensor, codes: torch.Tensor,
                       simf: SimilarityFunction | None = None,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: `lookup_scan`, then `adc_value_to_score` (with
    `simf`), then -inf where `valid` is False -> [Q, N] float32."""
    out = lookup_scan(luts, codes)
    if simf is not None:
        out = adc_value_to_score(out, simf)
    if valid is not None:
        out.masked_fill_(~valid[None, :], NEG_INF)
    return out


def prep_tables_reference(luts: torch.Tensor, group: int) -> torch.Tensor:
    """Plain version of the prep kernel's table layout: [ceil(Q / group),
    M, 256, group] bf16, query-minor, zero past K and past Q."""
    q, m, k = luts.shape
    groups = -(-q // group)
    padded = torch.zeros((groups * group, m, TABLE_SLOTS),
                         dtype=torch.bfloat16, device=luts.device)
    padded[:q, :, :k] = luts.to(torch.bfloat16)
    return padded.reshape(groups, group, m, TABLE_SLOTS).permute(
        0, 2, 3, 1).contiguous()


def _bind() -> ctypes.CDLL:
    """Build (once) and load the kernels, declaring their C signatures."""
    lib = _kernels.load("adc_scan")
    if lib.adc_scan_launch.argtypes is not None:  # declared before
        return lib
    lib.adc_prep_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.adc_prep_launch.restype = ctypes.c_int
    lib.adc_scan_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.adc_scan_launch.restype = ctypes.c_int
    return lib


def _check_inputs(luts: torch.Tensor, codes: torch.Tensor,
                  valid: torch.Tensor | None) -> None:
    """Raise on what neither version takes: shapes, types, devices."""
    if luts.dtype != torch.float32 or luts.dim() != 3:
        raise ValueError(f"adc_scan: luts must be [Q, M, K] float32, got "
                         f"{tuple(luts.shape)} {luts.dtype}")
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError(f"adc_scan: codes must be [N, M] uint8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    if codes.shape[1] != luts.shape[1]:
        raise ValueError(f"adc_scan: codes have {codes.shape[1]} subspaces, "
                         f"luts {luts.shape[1]}")
    if valid is not None and (valid.dtype != torch.bool or valid.dim() != 1
                              or valid.shape[0] != codes.shape[0]):
        raise ValueError(f"adc_scan: valid must be [{codes.shape[0]}] bool, "
                         f"got {tuple(valid.shape)} {valid.dtype}")
    tensors = [luts, codes] + ([] if valid is None else [valid])
    devices = {t.device for t in tensors}
    if len(devices) != 1 or not (luts.is_cuda or luts.device.type == "cpu"):
        raise ValueError(
            f"adc_scan: inputs on {[str(t.device) for t in tensors]}; all "
            "must be on one CUDA device (or all on the CPU)")


def adc_scan(luts: torch.Tensor, codes: torch.Tensor,
             simf: SimilarityFunction | None = None,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """ADC sums for every code row, scored with `simf` when given and -inf
    where `valid` is False: -> [Q, N] float32."""
    _check_inputs(luts, codes, valid)
    if luts.device.type == "cpu":
        return adc_scan_reference(luts, codes, simf, valid)
    q, m, k = luts.shape
    n = codes.shape[0]
    if not 1 <= k <= TABLE_SLOTS:
        raise ValueError(f"adc_scan: K={k} must be in [1, {TABLE_SLOTS}]")
    if not (luts.is_contiguous() and codes.is_contiguous()
            and (valid is None or valid.is_contiguous())):
        raise ValueError("adc_scan: luts, codes and valid must be contiguous")
    group = pick_group(m, q)
    if -(-q // group) > MAX_GRID_Y or n >= 2**31 or m == 0:
        raise ValueError(f"adc_scan: shape Q={q} N={n} M={m} out of range")
    out = torch.empty((q, n), dtype=torch.float32, device=luts.device)
    if q == 0 or n == 0:
        return out
    lb = torch.empty((-(-q // group), m, TABLE_SLOTS, group),
                     dtype=torch.bfloat16, device=luts.device)
    lib = _bind()
    stream = torch.cuda.current_stream(luts.device).cuda_stream
    with torch.cuda.device(luts.device):
        err = lib.adc_scan_launch(
            luts.data_ptr(), codes.data_ptr(),
            None if valid is None else valid.data_ptr(), lb.data_ptr(),
            out.data_ptr(), q, m, k, n, group, _score_mode(simf), stream)
    if err != 0:
        raise RuntimeError(f"adc_scan: kernel launch failed, cudaError {err}")
    adc_scan.launches += 1
    return out


adc_scan.launches = 0


def prep_tables(luts: torch.Tensor, group: int) -> torch.Tensor:
    """The prep kernel alone on a CUDA `luts` [Q, M, K] float32: the bf16
    layout a scan block stages (`prep_tables_reference` is its plain
    version)."""
    q, m, k = luts.shape
    if not (luts.is_cuda and luts.dtype == torch.float32
            and luts.is_contiguous() and 1 <= k <= TABLE_SLOTS
            and group in (1, 2, 4) and q > 0 and m > 0):
        raise ValueError(f"prep_tables: luts {tuple(luts.shape)} "
                         f"{luts.dtype} on {luts.device}, group {group}")
    lb = torch.empty((-(-q // group), m, TABLE_SLOTS, group),
                     dtype=torch.bfloat16, device=luts.device)
    lib = _bind()
    stream = torch.cuda.current_stream(luts.device).cuda_stream
    with torch.cuda.device(luts.device):
        err = lib.adc_prep_launch(luts.data_ptr(), lb.data_ptr(), q, m, k,
                                  group, stream)
    if err != 0:
        raise RuntimeError(f"prep_tables: launch failed, cudaError {err}")
    return lb
