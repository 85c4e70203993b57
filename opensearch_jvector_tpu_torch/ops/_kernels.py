"""Build and load the port's native libraries.

Each kernel source under `csrc/` has a plain C entry point. At first use
it is compiled into a shared library under `build/torch_kernels/` at the
repository root and loaded with `ctypes`: a CUDA source (`.cu`) with
`nvcc`, with PyTorch's headers kept out, so a build takes seconds; a host
source (`.cpp`) with the host C++ compiler and portable flags, so a
library built on one machine never carries another machine's instruction
set (a host kernel that wants wider vectors picks them at load time with
`target_clones`); the host row store `csrc/vector_store.cpp` and the host
rerank `csrc/host_rerank.cpp` are such builds. Each library name carries a
hash of its source and flags, so an edited source is rebuilt and never
shadowed by a stale build. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-pthread"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # name -> compiler output (register/smem use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _cxx() -> str:
    for name in ("g++", "c++", "clang++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler found")


def _source(name: str) -> Path:
    host = CSRC / f"{name}.cpp"
    return host if host.exists() else CSRC / f"{name}.cu"


def _is_host(name: str) -> bool:
    """A `.cpp` source is built by the host compiler, a `.cu` by nvcc."""
    return _source(name).suffix == ".cpp"


def _flags(name: str) -> list[str]:
    return HOST_CXX_FLAGS if _is_host(name) else NVCC_FLAGS


def library_path(name: str) -> Path:
    """Where the library for source `name` is (or will be) built."""
    src = _source(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile source `name` (`csrc/<name>.cu` or `csrc/<name>.cpp`)
    unless a build of this exact source exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    compiler = _cxx() if _is_host(name) else _nvcc()
    cmd = [compiler, *_flags(name), "-o", str(tmp), str(_source(name))]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"{Path(compiler).name} failed for {_source(name).name} "
            f"(exit {proc.returncode}):\n{BUILD_LOGS[name]}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library `name` once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of an `nvcc -Xptxas -v` report: the kernel's
    name (demangled where `c++filt` is found), its registers and its spill
    bytes."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            rows.append((name, m.group(1), spill))
            name = None
    filt = shutil.which("c++filt")
    names = [r[0] for r in rows]
    if filt and names:
        proc = subprocess.run([filt], input="\n".join(names),
                              capture_output=True, text=True, check=False)
        if proc.returncode == 0 and len(proc.stdout.splitlines()) == len(
                names):
            names = proc.stdout.splitlines()
    out = []
    for short, (_, regs, spill) in zip(names, rows):
        short = short.replace("(anonymous namespace)::", "")
        short = short.removeprefix("void ").split("(")[0]
        out.append(f"{short}: {regs} registers; {spill}")
    return out
