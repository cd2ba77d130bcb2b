"""Builds the port's CUDA kernels with nvcc and loads them with ctypes
(no counterpart in ldpc_tpu, whose Pallas kernels compile through JAX).

Each library is compiled at first use, never on import, from the sources
in `kernels/csrc/` into `kernels/build/` (git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

A library of several units (`UNITS`) compiles its source once a unit,
all at once, with `-c -DLDPC_UNIT=<u>`, and links the objects into the
library: the decoder libraries put their two-lane instances, their
four-lane instances of rows above 16 entries and their one-lane instances
(the layered library's in two units) in units of their own, which build
beside the rest.

The file name carries a hash of the source, of every header under
`csrc/` that it includes (`#include "..."`, followed recursively), of the
flags and of the units, so a stale build is never loaded; ptxas'
register/shared-memory report is kept next to it as `<lib>.log`. A missing
nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Libraries compiled as several units at once (LDPC_UNIT = 1 .. count): the
# same code as one unit (ptxas gives every instance the same registers) in
# about half the build time; nvcc's own --split-compile is as fast but
# changes the megakernels' code (PERF.md section 6).
UNITS = {"minsum_flood": 4, "minsum_layered": 5}

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

# One lock per library: two libraries build at the same time from two
# threads, one library never twice.
_locks: Dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()
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


def sources(name: str) -> List[Path]:
    """`csrc/<name>.cu` and the local headers it includes, transitively,
    in first-include order."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc
                 for inc in _INCLUDE.findall(path.read_text())
                 if (path.parent / inc).exists()]
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sources(name):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(f"units {UNITS.get(name, 1)}".encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _run(cmds: List[List[str]]) -> str:
    """Runs the commands at once; returns their output. The first failure
    stops the others and raises."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    log = ""
    try:
        for cmd, proc in zip(cmds, procs):
            stdout, stderr = proc.communicate()
            log += stdout + stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return log


def compile_library(name: str, out: Path) -> str:
    """Compiles `csrc/<name>.cu` into the library `out` (its `UNITS` at
    once) and writes ptxas' report beside it; returns the report. A failed
    build raises."""
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename: concurrent processes never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    src = str(CSRC / f"{name}.cu")
    units = range(1, UNITS.get(name, 1) + 1)
    objs = [f"{tmp[:-3]}.{u}.o" for u in units]
    try:
        if len(units) == 1:
            log = _run([[nvcc, *NVCC_FLAGS, "-o", tmp, src]])
        else:
            flags = [f for f in NVCC_FLAGS if f != "-shared"]
            log = _run([[nvcc, *flags, "-c", f"-DLDPC_UNIT={u}", "-o", obj,
                         src] for u, obj in zip(units, objs)])
            log += _run([[nvcc, *NVCC_FLAGS, "-o", tmp, *objs]])
        os.replace(tmp, out)
    finally:
        for path in [tmp, *objs]:
            if os.path.exists(path):
                os.unlink(path)
    out.with_suffix(".log").write_text(log)
    return log


def load(name: str, rebuild: bool = False) -> Library:
    """Build (if needed) and load `csrc/<name>.cu`. rebuild=True compiles
    even when a build with the same hash exists."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded and not rebuild:
            return _loaded[name]
        path = library_path(name)
        seconds = 0.0
        if rebuild or not path.exists():
            t0 = time.perf_counter()
            log = compile_library(name, path)
            seconds = time.perf_counter() - t0
        else:
            log_path = path.with_suffix(".log")
            log = log_path.read_text() if log_path.exists() else ""
        lib = Library(cdll=ctypes.CDLL(str(path)), path=path,
                      build_seconds=seconds, ptxas_log=log)
        _loaded[name] = lib
        return lib
