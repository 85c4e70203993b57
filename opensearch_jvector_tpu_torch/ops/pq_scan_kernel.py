"""Fused PQ decode-then-score scan: the wrapper of `csrc/decode_scan.cu`.

Port of `opensearch_jvector_tpu/ops/pallas/pq_scan_kernel.py:
fused_decode_scan`. `decode_scan(q_c, codes, codebooks)` returns the raw
inner products `ip[q, n] = q_c[q] . decode_nocenter(codes[n])` as [Q, N]
float32, where `q_c` are queries already centered (and, for cosine,
normalized) by the caller:

  * on CUDA tensors it launches the hand-written kernel on the current
    stream (bf16 operands, float32 sums — the TPU kernel's numerics; the
    reconstruction never reaches device memory) and raises on any input
    the kernel does not take;
  * on CPU tensors it runs the plain version, `decode_scan_reference`.
    That is the only case the plain version serves.

Tolerance: both operands are rounded to bf16 (relative error <= 2^-9
each), so each product moves by at most ~2^-8 of |q_j| * |dec_j|.
`kernel_error_bound` gives 2^-7 * sum_j |q_j| * |dec_j| per element (twice
that, the margin covering the float32 summation order), and the checks
hold every element of the kernel, and of the plain version against an
unrounded float32 product, to it.

`decode_scan.launches` counts kernel launches (and nothing else), so a run
can show that its search path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from opensearch_jvector_tpu_torch.ops import _kernels

SLOTS = 256  # codebook slots per subspace (one per code byte)
CHUNK = 32  # dimensions per staged chunk in the kernel
TILE_Q = 128  # queries per block in the kernel
MAX_GRID_Y = 65535
REF_ROWS = 1 << 16  # code rows decoded at a time by the plain version


def _padded_codebooks(codebooks: torch.Tensor) -> torch.Tensor:
    """[M, 256, dsub] bf16-rounded codebooks, zero past K: a code >= K
    decodes to zero, as in the kernel."""
    m, k, dsub = codebooks.shape
    out = torch.zeros((m, SLOTS, dsub), dtype=torch.float32,
                      device=codebooks.device)
    out[:, :k] = codebooks.to(torch.bfloat16).float()
    return out


def decode_scan_reference(q_c: torch.Tensor, codes: torch.Tensor,
                          codebooks: torch.Tensor) -> torch.Tensor:
    """Plain version: bf16 queries times bf16 reconstructions, float32
    products and sums, decoded REF_ROWS rows at a time -> [Q, N] f32."""
    m, _, dsub = codebooks.shape
    cb = _padded_codebooks(codebooks)
    q = q_c.to(torch.bfloat16).float()
    sub = torch.arange(m, device=codes.device)
    out = torch.empty((q.shape[0], codes.shape[0]), dtype=torch.float32,
                      device=q.device)
    for s in range(0, codes.shape[0], REF_ROWS):
        idx = codes[s: s + REF_ROWS].long()  # uint8 would index as a mask
        dec = cb[sub, idx].reshape(idx.shape[0], m * dsub)
        out[:, s: s + idx.shape[0]] = q @ dec.T
    return out


def kernel_error_bound(q_c: torch.Tensor, codes: torch.Tensor,
                       codebooks: torch.Tensor) -> torch.Tensor:
    """[Q, N] bound on |kernel - exact|: 2^-7 * sum_j |q_j| * |dec_j|."""
    return decode_scan_reference(q_c.abs(), codes, codebooks.abs()) * 2.0**-7


def _bind() -> ctypes.CDLL:
    lib = _kernels.load("decode_scan")
    fn = lib.decode_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def decode_scan(q_c: torch.Tensor, codes: torch.Tensor,
                codebooks: torch.Tensor) -> torch.Tensor:
    """Raw inner products of centered queries with every code row's
    reconstruction (no center): -> [Q, N] float32."""
    tensors = (q_c, codes, codebooks)
    if all(t.device.type == "cpu" for t in tensors):
        return decode_scan_reference(q_c, codes, codebooks)
    dev = q_c.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(
            "decode_scan: q_c, codes and codebooks on "
            f"{[str(t.device) for t in tensors]}; all must be on one CUDA "
            "device (or all on the CPU)")
    if codebooks.dtype != torch.float32 or codebooks.dim() != 3:
        raise ValueError(f"decode_scan: codebooks must be [M, K, dsub] "
                         f"float32, got {tuple(codebooks.shape)} "
                         f"{codebooks.dtype}")
    m, k, dsub = codebooks.shape
    if q_c.dtype != torch.float32 or q_c.dim() != 2 or q_c.shape[1] != m * dsub:
        raise ValueError(f"decode_scan: q_c must be [Q, {m * dsub}] float32, "
                         f"got {tuple(q_c.shape)} {q_c.dtype}")
    if codes.dtype != torch.uint8 or codes.dim() != 2 or codes.shape[1] != m:
        raise ValueError(f"decode_scan: codes must be [N, {m}] uint8, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_scan: inputs must be contiguous")
    q, n = q_c.shape[0], codes.shape[0]
    if not 1 <= k <= SLOTS or m == 0 or dsub == 0:
        raise ValueError(f"decode_scan: M={m}, K={k}, dsub={dsub}: need "
                         f"M, dsub >= 1 and 1 <= K <= {SLOTS}")
    if -(-q // TILE_Q) > MAX_GRID_Y or n >= 2**31 or m * dsub >= 2**31:
        raise ValueError(f"decode_scan: shape Q={q} N={n} out of range")
    out = torch.empty((q, n), dtype=torch.float32, device=dev)
    if q == 0 or n == 0:
        return out
    d_pad = -(-(m * dsub) // CHUNK) * CHUNK
    qb = torch.empty((q, d_pad), dtype=torch.bfloat16, device=dev)
    cbt = torch.empty((d_pad, SLOTS), dtype=torch.bfloat16, device=dev)
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.decode_scan_launch(
            q_c.data_ptr(), codes.data_ptr(), codebooks.data_ptr(),
            qb.data_ptr(), cbt.data_ptr(), out.data_ptr(), q, n, m, k, dsub,
            stream)
    if err != 0:
        raise RuntimeError(f"decode_scan: kernel launch failed, cudaError "
                           f"{err}")
    decode_scan.launches += 1
    return out


decode_scan.launches = 0
