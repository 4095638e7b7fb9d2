"""Build the port's CUDA kernels from the repo's sources, at first use.

Each kernel is a `.cu` file with a plain `extern "C"` interface, compiled
by `nvcc` into a shared library and loaded with `ctypes` (no PyTorch
headers, so a build takes seconds). Libraries land in `build/kernels/` at
the repo root, named by a hash of their sources and flags, so an edited
source rebuilds and an unchanged one is reused. The headers the sources
share (`csrc/*.cuh` anywhere in this package) are hashed into every
library's name, so an edited header rebuilds them all. A failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
HEADERS = sorted(Path(__file__).resolve().parent.glob("**/csrc/*.cuh"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> (library, ptxas report, build seconds); one entry per process
_LOADED: dict[str, tuple[ctypes.CDLL, str, float]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str, sources: list[Path],
                 headers: list[Path] = HEADERS) -> Path:
    """lib`name`-<hash>.so in BUILD_DIR, the hash over the flags, the
    sources and the headers."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [*sources, *headers]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: list[Path]) -> ctypes.CDLL:
    """Compile `sources` into lib`name`-<hash>.so (once) and load it."""
    if name in _LOADED:
        return _LOADED[name][0]
    lib_path = library_path(name, sources)
    report = ""
    t0 = time.perf_counter()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        report = proc.stderr
        tmp.replace(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = (lib, report, time.perf_counter() - t0)
    return lib


def build_info(name: str) -> dict:
    """Build seconds and nvcc's ptxas report (registers, spills) for a
    kernel built in this process; empty report when the library was cached."""
    _, report, seconds = _LOADED[name]
    return {"seconds": seconds, "ptxas": report}
