"""Builds the port's CUDA kernels with nvcc and loads them with ctypes
(no counterpart in ldpc_tpu, whose Pallas kernels compile through JAX).

Each library is compiled at first use, never on import, from the sources
in `kernels/csrc/` into `kernels/build/` (git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so a stale
build is never loaded; ptxas' register/shared-memory report is kept next
to it as `<lib>.log`. A missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, "Library"] = {}


@dataclass(frozen=True)
class Library:
    """A loaded kernel library and how it came to be."""
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was loaded
    ptxas_log: str


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the CUDA "
                           "kernels")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, out: Path) -> str:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename: concurrent processes never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(log)
    return log


def load(name: str, rebuild: bool = False) -> Library:
    """Build (if needed) and load `csrc/<name>.cu`. rebuild=True compiles
    even when a build with the same hash exists."""
    with _lock:
        if name in _loaded and not rebuild:
            return _loaded[name]
        path = library_path(name)
        seconds = 0.0
        if rebuild or not path.exists():
            t0 = time.perf_counter()
            log = _compile(name, path)
            seconds = time.perf_counter() - t0
        else:
            log_path = path.with_suffix(".log")
            log = log_path.read_text() if log_path.exists() else ""
        lib = Library(cdll=ctypes.CDLL(str(path)), path=path,
                      build_seconds=seconds, ptxas_log=log)
        _loaded[name] = lib
        return lib
