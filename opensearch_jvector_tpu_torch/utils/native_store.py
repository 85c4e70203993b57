"""ctypes binding for the port's host row store (`csrc/vector_store.cpp`).

Port of `opensearch_jvector_tpu/utils/native_store.py`: the host tier of
on_disk segments. fp32 rows live in a raw row file, in the JAX package's
format; the rerank gathers rows by id over worker threads, each of which
advises the pages of its share of the ids that the page cache lacks (one
`mincore` call tells which) and then copies that share, into a block the
caller may reuse (`gather(ids, out=...)`). The library is built by
`ops/_kernels.py` into `build/torch_kernels/` with portable flags. Where
no host compiler is available the store falls back to a numpy memmap
(`is_native` says which one serves).
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib
from pathlib import Path

import numpy as np

from opensearch_jvector_tpu_torch.api.stats import STATS, Counter
from opensearch_jvector_tpu_torch.index.store import CorruptSegmentError
from opensearch_jvector_tpu_torch.ops import _kernels

@functools.cache
def _load_lib():
    """The bound native library, or None when it cannot be built here
    (tried once a process)."""
    try:
        lib = _kernels.load("vector_store")
    except (OSError, RuntimeError):
        return None
    lib.vs_open.restype = ctypes.c_void_p
    lib.vs_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.vs_num_rows.restype = ctypes.c_int64
    lib.vs_num_rows.argtypes = [ctypes.c_void_p]
    lib.vs_gather.restype = ctypes.c_int64
    lib.vs_gather.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.vs_close.restype = None
    lib.vs_close.argtypes = [ctypes.c_void_p]
    return lib


def _ids(ids) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(ids, np.int64).reshape(-1))


def _block(out: np.ndarray, n: int, dim: int) -> np.ndarray:
    """The [n, dim] view at the start of the caller's buffer `out`."""
    if not (isinstance(out, np.ndarray) and out.dtype == np.float32
            and out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("out must be a writeable C-contiguous float32 "
                         "array")
    if out.size < n * dim:
        raise ValueError(f"out holds {out.size} floats, the gather needs "
                         f"{n} x {dim} = {n * dim}")
    return out.reshape(-1)[: n * dim].reshape(n, dim)


class PagedVectorStore:
    """Row store over a raw binary file: rows of `dim` float32 values.

    The native gather adds the pages it advised to the node's
    `knn_query_row_store_pages_advised`."""

    def __init__(self, path: str | Path, dim: int,
                 threads: int | None = None):
        self.path = str(path)
        self.dim = int(dim)
        self.threads = threads or min(os.cpu_count() or 1, 16)
        self._lib = _load_lib()
        self._handle = None
        self._mm = None
        if self._lib is not None:
            h = self._lib.vs_open(self.path.encode(), self.dim * 4, 0)
            if h:
                self._handle = ctypes.c_void_p(h)
        if self._handle is None:
            self._mm = np.memmap(self.path, dtype=np.float32,
                                 mode="r").reshape(-1, self.dim)

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    @property
    def num_rows(self) -> int:
        if self._handle is not None:
            return int(self._lib.vs_num_rows(self._handle))
        return int(self._mm.shape[0])

    def gather(self, ids, out: np.ndarray | None = None) -> np.ndarray:
        """Fetch rows by id -> [n, dim] f32 (out-of-range ids zero-filled),
        a fresh array, or a view of the caller's float32 buffer `out` of
        at least n * dim floats (ValueError when it is smaller)."""
        ids = _ids(ids)
        n = ids.shape[0]
        if out is None:
            out = np.empty((n, self.dim), np.float32)
        else:
            out = _block(out, n, self.dim)
        if self._handle is not None:
            pages = self._lib.vs_gather(
                self._handle,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
                out.ctypes.data, self.threads)
            if pages < 0:
                raise RuntimeError(f"vs_gather failed on {self.path}")
            STATS.increment(Counter.KNN_QUERY_ROW_STORE_PAGES_ADVISED, pages)
            return out
        valid = (ids >= 0) & (ids < self._mm.shape[0])
        out[:] = 0.0
        out[valid] = self._mm[ids[valid]]
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.vs_close(self._handle)
            self._handle = None
        self._mm = None


def write_row_file(path: str | Path, vectors: np.ndarray) -> None:
    """Write vectors [n, d] to the raw row format the store reads, plus a
    CRC sidecar `{path}.crc` (`<QQ`: crc32, byte count) that
    `verify_row_file` checks. The checksum rides beside the file because a
    footer inside it would break the store's row arithmetic."""
    arr = np.ascontiguousarray(vectors, dtype=np.float32)
    arr.tofile(str(path))
    flat = memoryview(arr).cast("B")  # streamed: no copy of a multi-GB file
    crc, step = 0, 1 << 24
    for s in range(0, len(flat), step):
        crc = zlib.crc32(flat[s:s + step], crc)
    Path(str(path) + ".crc").write_bytes(
        struct.pack("<QQ", crc & 0xFFFFFFFF, arr.nbytes))


def verify_row_file(path: str | Path, chunk_bytes: int = 1 << 24) -> bool:
    """Stream-verify a row file against its CRC sidecar. A missing sidecar
    passes (row files written before sidecars existed stay readable); a
    mismatch or truncation raises CorruptSegmentError."""
    sidecar = Path(str(path) + ".crc")
    if not sidecar.exists():
        return True
    blob = sidecar.read_bytes()
    if len(blob) != 16:
        raise CorruptSegmentError(
            f"{sidecar}: malformed CRC sidecar ({len(blob)} bytes, want 16)")
    want_crc, want_bytes = struct.unpack("<QQ", blob)
    p = Path(path)
    if p.stat().st_size != want_bytes:
        raise CorruptSegmentError(
            f"{p}: row file is {p.stat().st_size} bytes, sidecar says "
            f"{want_bytes}")
    crc = 0
    with open(p, "rb") as f:
        while chunk := f.read(chunk_bytes):
            crc = zlib.crc32(chunk, crc)
    if (crc & 0xFFFFFFFF) != want_crc:
        raise CorruptSegmentError(
            f"{p}: row checksum mismatch ({crc & 0xFFFFFFFF:#x} != "
            f"{want_crc:#x})")
    return True
