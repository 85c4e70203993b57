"""Versioned, checksummed binary container format for segment files.

Plays the role of the reference's Lucene codec I/O conventions: every file
carries a header (magic + format version) and a footer checksum, verified on
open (CodecUtil headers/footers written at JVectorWriter.java:151-165,361,
464,508; verified by JVectorReader.checkIntegrity, JVectorReader.java:84-96).

Layout (little-endian):
  magic   8 bytes  b"JVTPU\\x00\\x00\\x01"
  version u32      FORMAT_VERSION
  metalen u32      length of the JSON metadata blob
  meta    bytes    JSON: {user metadata, "arrays": [{name, dtype, shape,
                   offset, nbytes, crc32}]}
  blobs   bytes    raw array data, 64-byte aligned each
  footer  u64      crc32 of everything before the footer (in low 32 bits)
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np

from opensearch_jvector_tpu_torch.api.version import (
    FORMAT_VERSION,
    MIN_SUPPORTED_FORMAT_VERSION,
)

MAGIC = b"JVTPU\x00\x00\x01"
ALIGN = 64


class CorruptSegmentError(RuntimeError):
    pass


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def write_container(
    path: str | Path, metadata: dict, arrays: dict[str, np.ndarray]
) -> None:
    """Write a checksummed container with JSON metadata + named arrays."""
    entries = []
    blobs = []
    offset = 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        raw = arr.tobytes()
        entries.append(
            {
                "name": name,
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
                "offset": offset,
                "nbytes": len(raw),
                "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
            }
        )
        pad = _align(len(raw)) - len(raw)
        blobs.append(raw + b"\x00" * pad)
        offset += len(raw) + pad

    meta = dict(metadata)
    meta["arrays"] = entries
    meta_bytes = json.dumps(meta).encode()

    buf = bytearray()
    buf += MAGIC
    buf += struct.pack("<II", FORMAT_VERSION, len(meta_bytes))
    buf += meta_bytes
    for b in blobs:
        buf += b
    crc = zlib.crc32(bytes(buf)) & 0xFFFFFFFF
    buf += struct.pack("<Q", crc)
    Path(path).write_bytes(bytes(buf))


def read_container(
    path: str | Path, verify: bool = True, mmap: bool = True
) -> tuple[dict, dict[str, np.ndarray]]:
    """Read a container -> (metadata, {name: array}).

    `verify=True` re-checksums the whole file and every array (the
    checkIntegrity path); `mmap=True` maps blobs lazily instead of copying.
    """
    path = Path(path)
    if mmap:
        data = np.memmap(path, dtype=np.uint8, mode="r")
        raw = data  # indexable like bytes
    else:
        raw = np.frombuffer(path.read_bytes(), dtype=np.uint8)
    if len(raw) < len(MAGIC) + 8 + 8:
        raise CorruptSegmentError(f"{path}: truncated")
    if bytes(raw[: len(MAGIC)]) != MAGIC:
        raise CorruptSegmentError(f"{path}: bad magic")
    version, metalen = struct.unpack(
        "<II", bytes(raw[len(MAGIC) : len(MAGIC) + 8])
    )
    if not MIN_SUPPORTED_FORMAT_VERSION <= version <= FORMAT_VERSION:
        raise CorruptSegmentError(
            f"{path}: unsupported format version {version} "
            f"(supported {MIN_SUPPORTED_FORMAT_VERSION}..{FORMAT_VERSION})"
        )
    # Verify the whole-file checksum BEFORE parsing metadata: a corrupt
    # metadata region must surface as CorruptSegmentError, not a JSON error.
    if verify:
        stored_crc = struct.unpack("<Q", bytes(raw[-8:]))[0]
        actual = zlib.crc32(bytes(raw[:-8])) & 0xFFFFFFFF
        if actual != stored_crc:
            raise CorruptSegmentError(
                f"{path}: file checksum mismatch ({actual:#x} != {stored_crc:#x})"
            )
    meta_start = len(MAGIC) + 8
    try:
        meta = json.loads(bytes(raw[meta_start : meta_start + metalen]))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CorruptSegmentError(f"{path}: corrupt metadata: {e}") from e
    blob_start = meta_start + metalen

    arrays = {}
    for e in meta["arrays"]:
        s = blob_start + e["offset"]
        chunk = raw[s : s + e["nbytes"]]
        if verify:
            crc = zlib.crc32(bytes(chunk)) & 0xFFFFFFFF
            if crc != e["crc32"]:
                raise CorruptSegmentError(
                    f"{path}: array {e['name']} checksum mismatch"
                )
        arr = np.frombuffer(bytes(chunk), dtype=np.dtype(e["dtype"]))
        arrays[e["name"]] = arr.reshape(e["shape"])
    meta_user = {k: v for k, v in meta.items() if k != "arrays"}
    return meta_user, arrays
