"""Hard-decision decoders as plain torch ops (counterpart of
`ldpc_tpu/ops/decode_hard.py`: `make_hard_decoder`,
`_make_bitflip_decoder`).

Gallager-A/B message passing and parallel bit-flipping over hard channel
bits, the decoding side of the BSC fault injector (`ops/channel.bsc`). Every
rule is pinned in `golden/decoder.py` (`decode_hard`); the batched ops here
match the golden scalars exactly: hard bits, iteration counts and
convergence flags. The reference has no kernel for hard decisions, and
neither has the port: these run on the device of the bits they are given.

Layout as `ops/decode_ref.py`: dense check-major (M, D) message tables from
`codes/layout.py`, a flat (M * D + 1) buffer per codeword whose last slot
is a dump/pad slot, and gather-only updates. Pad message slots carry -1 so
that the variable side's disagreement counts ignore them without a mask
gather, and the pad variable's threshold is 1 << 20 so that pad edges never
flip. Early termination is per lane (a done mask that latches a lane's
outputs); the loop leaves when every lane is done, and that test is the
only host synchronisation, made only with early_term.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..codes.code import LDPCCode
from ..codes.layout import compile_edge_layout
from ..golden.decoder import _default_thresholds
from .decode_ref import _on_device, _syndrome_ok

Decoded = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
ALGORITHMS = ("gallager-b", "gallager-a", "bit-flip")


def _pad1(x: torch.Tensor, val: int = 0) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 1), value=val)


def make_hard_decoder(
    code: LDPCCode,
    max_iter: int = 30,
    algorithm: str = "gallager-b",
    threshold: Optional[int] = None,
    early_term: bool = True,
) -> Callable[[torch.Tensor], Decoded]:
    """Returns decode(y[B, n] bits) -> (hard[B, n] uint8, iters[B] int32,
    converged[B] bool), computed on y's device. algorithm: 'gallager-b' |
    'gallager-a' | 'bit-flip'."""
    if algorithm == "bit-flip":
        return _make_bitflip_decoder(code, max_iter, threshold, early_term)
    if algorithm not in ("gallager-a", "gallager-b"):
        raise ValueError(algorithm)
    lay = compile_edge_layout(code)
    M, D, N = lay.m, lay.max_dc, lay.n
    t_np = (np.full(N, int(threshold), np.int32) if threshold is not None
            else _default_thresholds(code, algorithm))
    on = _on_device((
        np.asarray(lay.ev_dense, np.int64),                  # (M, D) pad N
        np.asarray(lay.vn_pos, np.int64),                    # (N, dv) pad M*D
        np.asarray(lay.cn_mask, bool),                       # (M, D)
        np.asarray(lay.vn_mask.sum(axis=1), np.int32),       # (N,)
        # the pad slot (index N) gets a huge threshold: pad edges never flip
        np.concatenate([t_np, [1 << 20]]).astype(np.int32)))

    def decode(y: torch.Tensor) -> Decoded:
        ev, vn_pos, mask, dv, t_pad = on(y.device)
        B = y.shape[0]
        y32 = y.to(torch.int32)
        y_ev = _pad1(y32)[:, ev]                             # (B, M, D)
        v2c = torch.where(mask, y_ev, 0)
        hard0 = y32.bool()
        hard = hard0
        done = (_syndrome_ok(hard0, ev) if early_term
                else torch.zeros(B, dtype=torch.bool, device=y.device))
        iters = torch.zeros(B, dtype=torch.int32, device=y.device)
        thr_ev = t_pad[ev]
        for _ in range(max_iter):
            if early_term and bool(done.all()):
                break
            # CN pass: exclude-self XOR (pads carry 0, neutral to XOR).
            par = v2c.sum(dim=-1, keepdim=True, dtype=torch.int32) & 1
            c2v = par ^ v2c                                  # (B, M, D)
            c2v_flat = _pad1(torch.where(mask, c2v, -1).reshape(B, M * D),
                             val=-1)
            g = c2v_flat[:, vn_pos]                          # (B, N, dv)
            dis = ((g >= 0) & (g != y32[:, :, None])).sum(
                dim=-1, dtype=torch.int32)                   # (B, N)
            hard_new = (2 * dis > dv) ^ hard0                # flip vs channel
            ok_new = _syndrome_ok(hard_new, ev)
            # VN pass: exclude-self disagreement against the threshold.
            d_all = _pad1(dis)[:, ev]                        # (B, M, D)
            own = ((c2v != y_ev) & mask).to(torch.int32)
            v2c_new = torch.where(d_all - own >= thr_ev, 1 - y_ev, y_ev)
            v2c_new = torch.where(mask, v2c_new, 0)
            v2c = torch.where(done[:, None, None], v2c, v2c_new)
            hard = torch.where(done[:, None], hard, hard_new)
            iters = iters + (~done).to(torch.int32)
            if early_term:
                done = done | ok_new
        conv = done if early_term else _syndrome_ok(hard, ev)
        return hard.to(torch.uint8), iters, conv

    return decode


def _make_bitflip_decoder(code: LDPCCode, max_iter: int,
                          threshold: Optional[int], early_term: bool
                          ) -> Callable[[torch.Tensor], Decoded]:
    lay = compile_edge_layout(code)
    D = lay.max_dc
    on = _on_device((np.asarray(lay.ev_dense, np.int64),
                     np.asarray(lay.vn_pos, np.int64),
                     np.asarray(lay.vn_mask.sum(axis=1), np.int32)))
    t = None if threshold is None else int(threshold)

    def decode(y: torch.Tensor) -> Decoded:
        ev, vn_pos, dv = on(y.device)
        B = y.shape[0]
        x = y.to(torch.int32)
        done = (_syndrome_ok(x, ev) if early_term
                else torch.zeros(B, dtype=torch.bool, device=y.device))
        iters = torch.zeros(B, dtype=torch.int32, device=y.device)
        for _ in range(max_iter):
            if early_term and bool(done.all()):
                break
            synd = _pad1(x)[:, ev].sum(dim=-1, dtype=torch.int32) & 1  # (B, M)
            # Per-variable unsatisfied-check count: each check's syndrome
            # bit in its D slots, gathered by flat edge position (the dump
            # slot gives 0 for pad edges).
            synd_rep = _pad1(synd.repeat_interleave(D, dim=1))  # (B, M*D+1)
            unsat = synd_rep[:, vn_pos].sum(dim=-1, dtype=torch.int32)
            flip = (2 * unsat > dv) if t is None else (unsat >= t)
            x_new = torch.where(flip, 1 - x, x)
            ok_new = _syndrome_ok(x_new, ev)
            x = torch.where(done[:, None], x, x_new)
            iters = iters + (~done).to(torch.int32)
            if early_term:
                done = done | ok_new
        conv = done if early_term else _syndrome_ok(x, ev)
        return x.to(torch.uint8), iters, conv

    return decode
