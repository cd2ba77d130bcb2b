"""Builds and loads the port's native C components (counterpart of
`ldpc_tpu/utils/native.py`: `load_native`).

The compile policy is the reference's: `$CC` (default `cc`, else `gcc` or
`clang`) with `-O3 -shared -fPIC -fopenmp`, and again without OpenMP when
that fails (the pragmas then degrade to serial). The load path is not: the reference
compares modification times and compiles in place, so two processes that
start together can load a half-written library, and a stale binary is
found only when `ctypes` refuses it. Here the library's file name carries a
hash of the source and of the compiler, so a stale build is never loaded,
and every build goes to a temporary name in the target directory and is
renamed into place (`os.replace` is atomic), as `kernels/build.py` does for
the CUDA libraries: any number of processes may build the same library at
once, and each loads a whole file.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

BASE_FLAGS = ("-O3", "-shared", "-fPIC")


def compiler() -> str:
    """`$CC`, else the first of cc, gcc and clang on the PATH."""
    cc = os.environ.get("CC")
    if cc:
        return cc
    for name in ("cc", "gcc", "clang"):
        if shutil.which(name):
            return name
    raise RuntimeError("no C compiler found ($CC, cc, gcc, clang): cannot "
                       "build the native library")


def library_path(src: str, build_dir: str) -> str:
    """`<build_dir>/<source stem>-<hash>.so`; the hash covers the source's
    bytes, the compiler and the flags."""
    cc = compiler()
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(("\0" + cc + "\0" + " ".join(BASE_FLAGS)).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir, f"{stem}-{h.hexdigest()[:16]}.so")


def _compile(src: str, so: str) -> None:
    cc = compiler()
    build_dir = os.path.dirname(so)
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        try:
            subprocess.run([cc, *BASE_FLAGS, "-fopenmp", src, "-o", tmp],
                           check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError:
            # no OpenMP toolchain: the pragmas degrade to serial
            try:
                subprocess.run([cc, *BASE_FLAGS, src, "-o", tmp], check=True,
                               capture_output=True, text=True)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(f"{cc} failed on {src}:\n{e.stderr}"
                                   ) from e
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_native(src: str, build_dir: str) -> ctypes.CDLL:
    """Build (when no build of this very source exists) and load a shared
    library from one C source; the library goes into `build_dir`."""
    so = library_path(src, build_dir)
    if not os.path.exists(so):
        _compile(src, so)
    return ctypes.CDLL(so)


@contextlib.contextmanager
def omp_threads(lib: ctypes.CDLL, threads: int):
    """The OpenMP thread count of `lib`'s runtime (and OMP_NUM_THREADS) set
    to `threads` inside the block and put back as they were after it. The
    runtime is the process's: every library that links it shares the
    count. The variable only matters to a runtime that has not started
    yet."""
    env = os.environ.get("OMP_NUM_THREADS")
    try:
        getter, setter = lib.omp_get_max_threads, lib.omp_set_num_threads
    except AttributeError:      # built without OpenMP: one thread anyway
        getter = setter = None
    if setter is not None:
        getter.restype = ctypes.c_int
        setter.argtypes, setter.restype = [ctypes.c_int], None
        before = getter()
        setter(int(threads))
    os.environ["OMP_NUM_THREADS"] = str(threads)
    try:
        yield
    finally:
        if setter is not None:
            setter(before)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env
