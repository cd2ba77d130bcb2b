"""ctypes bindings for the port's native C decoder oracle,
`ldpc_tpu_torch/csrc/ldpc_oracle.c` (counterpart of `ldpc_tpu/oracle.py`:
`decode_batch`, `decode_hard_batch`).

The C module is the sequential fixed-point message-passing loop, a fast
bit-exact witness independent of the torch decoders and the CUDA kernels
(the NumPy golden model is about 1000x slower). It is compiled on demand
with the system compiler into `ldpc_tpu_torch/csrc/build/`
(`utils.native.load_native`). Where the reference's library aborts the
process (a min* check of degree > 64, an allocation that fails), this one
returns a status and the functions here raise.
"""
from __future__ import annotations

import ctypes
import os
from functools import lru_cache
from typing import Tuple

import numpy as np

from .codes.code import LDPCCode

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCE = os.path.join(_CSRC, "ldpc_oracle.c")
BUILD_DIR = os.path.join(_CSRC, "build")
_ERR_NOMEM, _ERR_DEGREE = 1, 2        # ORACLE_ERR_* of the C source


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from .utils.native import load_native
    lib = load_native(SOURCE, BUILD_DIR)
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.ldpc_decode_batch.argtypes = [
        i8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i32p,
        ctypes.c_int, i32p, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, ctypes.c_int,  # min* threshold LUT (n_ms = 0: min-sum family)
        u8p, i32p, u8p,
    ]
    lib.ldpc_decode_batch.restype = ctypes.c_int
    lib.ldpc_decode_hard_batch.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p, i32p, u8p,
    ]
    lib.ldpc_decode_hard_batch.restype = ctypes.c_int
    return lib


def _check(status: int, code: LDPCCode) -> None:
    if status == _ERR_DEGREE:
        deg = max(len(vs) for vs in code.cn_adj)
        raise ValueError(f"{code.name}: the oracle's min* supports check "
                         f"degree <= 64, got {deg}")
    if status == _ERR_NOMEM:
        raise MemoryError(f"{code.name}: the oracle could not allocate its "
                          f"scratch")
    if status:
        raise RuntimeError(f"ldpc_oracle returned {status}")


_graph_cache: dict = {}


def _graph_arrays(code: LDPCCode):
    cached = _graph_cache.get(id(code))
    if cached is not None and cached[0] is code:
        return cached[1]
    arrays = _build_graph_arrays(code)
    _graph_cache[id(code)] = (code, arrays)
    return arrays


def _build_graph_arrays(code: LDPCCode):
    cn_ptr = np.zeros(code.m + 1, np.int32)
    for c, vs in enumerate(code.cn_adj):
        cn_ptr[c + 1] = cn_ptr[c] + len(vs)
    cn_vars = np.concatenate([np.asarray(v, np.int32)
                              for v in code.cn_adj]).astype(np.int32)
    # Layers: QC base rows when available, else the greedy general grouping,
    # identical to the golden model's choice (golden/decoder.py).
    if code.base is not None and code.Z is not None:
        Z = int(code.Z)
        layers = [np.arange(i * Z, (i + 1) * Z, dtype=np.int32)
                  for i in range(code.m // Z)]
    else:
        from .codes.layout import compile_layers_general
        layers = compile_layers_general(code)
    layer_ptr = np.zeros(len(layers) + 1, np.int32)
    for i, l in enumerate(layers):
        layer_ptr[i + 1] = layer_ptr[i] + len(l)
    layer_checks = np.concatenate(layers).astype(np.int32)
    return cn_ptr, np.ascontiguousarray(cn_vars), layer_ptr, layer_checks


def decode_batch(
    chan: np.ndarray,
    code: LDPCCode,
    max_iter: int = 20,
    beta: int = 0,
    qmax: int = 127,
    schedule: str = "flooding",
    early_term: bool = True,
    alpha=None,
    minstar=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bit-exact batched decode. chan: (B, n) int8 -> (hard u8, iters i32,
    conv bool). alpha = (num, shift) normalized-min-sum scaling or None.
    minstar = threshold-LUT tuple (config.minstar_thresholds) selects the
    min* CN update (beta/alpha must then be 0/None); a check of degree > 64
    then raises ValueError."""
    if minstar is not None and (beta or alpha is not None):
        raise ValueError("min-star does not compose with beta/alpha")
    chan = np.ascontiguousarray(chan, np.int8)
    B, n = chan.shape
    assert n == code.n
    cn_ptr, cn_vars, layer_ptr, layer_checks = _graph_arrays(code)
    hard = np.empty((B, n), np.uint8)
    iters = np.empty(B, np.int32)
    conv = np.empty(B, np.uint8)
    ms = np.asarray(minstar if minstar is not None else [], np.int32)
    status = _lib().ldpc_decode_batch(
        chan, B, n, code.m, int(cn_ptr[-1]),
        cn_ptr, cn_vars,
        len(layer_ptr) - 1, layer_ptr, layer_checks,
        0 if schedule == "flooding" else 1,
        max_iter, beta, qmax,
        alpha[0] if alpha else 1, alpha[1] if alpha else 0,
        int(early_term),
        np.ascontiguousarray(ms), len(ms),
        hard, iters, conv)
    _check(status, code)
    return hard, iters, conv.astype(bool)


def decode_hard_batch(
    bits: np.ndarray,
    code: LDPCCode,
    max_iter: int = 30,
    algorithm: str = "gallager-b",
    threshold=None,
    early_term: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bit-exact batched hard-decision decode (Gallager-A/B message
    passing, parallel bit-flipping), the native cross-check for
    golden/decoder.decode_hard's pinned semantics. bits: (B, n) uint8 in
    {0,1} -> (hard u8, iters i32, conv bool)."""
    bits = np.ascontiguousarray(bits, np.uint8)
    B, n = bits.shape
    assert n == code.n
    alg = {"gallager-b": 0, "gallager-a": 1, "bit-flip": 2}[algorithm]
    cn_ptr, cn_vars, _, _ = _graph_arrays(code)
    hard = np.empty((B, n), np.uint8)
    iters = np.empty(B, np.int32)
    conv = np.empty(B, np.uint8)
    status = _lib().ldpc_decode_hard_batch(
        bits, B, n, code.m, int(cn_ptr[-1]), cn_ptr, cn_vars,
        alg, max_iter, -1 if threshold is None else int(threshold),
        int(early_term), hard, iters, conv)
    _check(status, code)
    return hard, iters, conv.astype(bool)
