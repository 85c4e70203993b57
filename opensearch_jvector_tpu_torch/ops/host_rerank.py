"""ctypes binding of the host rerank kernel (`csrc/host_rerank.cpp`).

The on_disk tier's exact rerank: the gathered candidate rows [Q, r, d] are
scored against their queries and each query's top k selected in one
multi-threaded pass of hand-written C++, with the formulas of
`ops/distances.py:host_candidate_scores` in float32 (euclidean by direct
difference). The library is built by `ops/_kernels.py` with the host
compiler and portable flags; where it cannot be built here,
`rerank_topk` returns None and the caller keeps its numpy path.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from opensearch_jvector_tpu_torch.ops import _kernels
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction

SIMILARITY_CODES = {
    SimilarityFunction.EUCLIDEAN: 0,
    SimilarityFunction.DOT_PRODUCT: 1,
    SimilarityFunction.COSINE: 2,
}
# as the row store's gather: the kernel itself keeps to one thread for a
# block under 1 MiB (a one-query REST search)
THREADS = min(os.cpu_count() or 1, 16)


@functools.cache
def _load_lib():
    """The bound library, or None when it cannot be built here (tried
    once a process)."""
    try:
        lib = _kernels.load("host_rerank")
    except (OSError, RuntimeError):
        return None
    f32 = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.hr_rerank.restype = ctypes.c_int64
    lib.hr_rerank.argtypes = [
        f32, f32, i64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, i64, f32,
    ]
    return lib


def rerank_topk(queries: np.ndarray, rows: np.ndarray, cand_ids: np.ndarray,
                qualify: np.ndarray, k: int, threshold: float,
                simf: SimilarityFunction):
    """Score rows [Q, r, d] against queries [Q, d] where `qualify` [Q, r]
    holds and keep each query's top min(k, r), score descending, ties to
    the lower candidate position; a score under `threshold` (when > 0), or
    -inf, leaves id -1 and score -inf.

    -> (ids [Q, min(k, r)] int64 from `cand_ids`, scores float32, rows
    scored), or None when the library cannot be built here. The call
    releases the interpreter lock."""
    lib = _load_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(queries, np.float32)
    c = np.ascontiguousarray(rows, np.float32)
    ids = np.ascontiguousarray(cand_ids, np.int64)
    ok = np.ascontiguousarray(qualify, np.bool_)
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    if c.ndim != 3 or q.shape != (c.shape[0], c.shape[2]) or (
            ids.shape != c.shape[:2] or ok.shape != c.shape[:2]):
        raise ValueError(
            f"shapes do not fit: queries {q.shape}, rows {c.shape}, "
            f"cand_ids {ids.shape}, qualify {ok.shape}")
    nq, r, d = c.shape
    kk = min(k, r)
    out_ids = np.empty((nq, kk), np.int64)
    out_scores = np.empty((nq, kk), np.float32)
    thr = np.float32(threshold) if threshold > 0.0 else np.float32(-np.inf)
    f32 = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.POINTER(ctypes.c_int64)
    scored = lib.hr_rerank(
        q.ctypes.data_as(f32), c.ctypes.data_as(f32),
        ids.ctypes.data_as(i64),
        ok.view(np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        nq, r, d, k, float(thr), SIMILARITY_CODES[simf], THREADS,
        out_ids.ctypes.data_as(i64), out_scores.ctypes.data_as(f32))
    if scored < 0:
        raise RuntimeError(f"hr_rerank failed ({scored}) at queries "
                           f"{q.shape}, rows {c.shape}, k {k}")
    return out_ids, out_scores, int(scored)
