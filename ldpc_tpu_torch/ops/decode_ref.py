"""Pure-torch fixed-point flooding decoder (counterpart of
`ldpc_tpu/ops/decode_ref.py::make_flooding_decoder`).

The port's CPU decoder and the plain version of the CUDA kernel
`kernels/csrc/minsum_flood.cu`: the same dense padded gathers as the
reference op, on any torch device. Min-sum, offset (beta) and normalized
(dyadic alpha) CN updates, fixed iterations or per-lane early
termination. Bit-exact with `golden.decoder.decode_fixed(schedule=
"flooding")`; the layered schedule is ROADMAP module item 5 and is not
ported yet.

Layout: messages live check-major in a flat (m * max_dc + 1) int32 buffer
per codeword; the last slot is a zero dump/pad slot (codes/layout.py).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ldpc_tpu.codes.code import LDPCCode
from ldpc_tpu.codes.layout import compile_edge_layout

_BIG = 1 << 15

Decoded = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _cn_update(v2c: torch.Tensor, mask: torch.Tensor, beta: int,
               alpha=None) -> torch.Tensor:
    """Min-sum CN update on dense (..., C, D) int32 messages.

    Pad slots must hold +qmax (they never win the min and have a positive
    sign); output pads are zeroed. The excluded slot is the first slot of
    minimum magnitude (golden's stable argmin; torch.argmin returns the
    first minimal index)."""
    mags = v2c.abs()
    amin = mags.argmin(dim=-1, keepdim=True)
    slots = torch.arange(v2c.shape[-1], device=v2c.device)
    first = slots == amin
    min1 = mags.amin(dim=-1, keepdim=True)
    min2 = torch.where(first, _BIG, mags).amin(dim=-1, keepdim=True)
    neg = v2c < 0
    par = (neg.sum(dim=-1, keepdim=True) & 1).bool()
    excl_neg = par ^ neg
    excl_mag = torch.where(first, min2, min1)
    if alpha is not None:
        excl_mag = (excl_mag * alpha[0]) >> alpha[1]
    mag = torch.clamp(excl_mag - beta, min=0)
    val = torch.where(excl_neg, -mag, mag)
    return torch.where(mask, val, 0)


def make_flooding_decoder(
    code: LDPCCode,
    max_iter: int = 20,
    beta: int = 0,
    qmax: int = 127,
    early_term: bool = True,
    alpha=None,
) -> Callable[[torch.Tensor], Decoded]:
    """Returns decode(chan[B, n] integer LLRs) -> (hard[B, n] uint8,
    iters[B] int32, converged[B] bool), computed on chan's device."""
    lay = compile_edge_layout(code)
    M, D, N = lay.m, lay.max_dc, lay.n
    tables_np = (np.asarray(lay.ev_dense, np.int64),
                 np.asarray(lay.vn_pos, np.int64),
                 np.asarray(lay.cn_mask, bool))
    tables: Dict[torch.device, tuple] = {}

    def on(device: torch.device):
        if device not in tables:
            tables[device] = tuple(torch.as_tensor(t, device=device)
                                   for t in tables_np)
        return tables[device]

    def decode(chan: torch.Tensor) -> Decoded:
        ev, vn_pos, mask = on(chan.device)
        B = chan.shape[0]

        def pad1(x):
            return torch.nn.functional.pad(x, (0, 1))

        def totals(c2v_flat):
            return chan32 + c2v_flat[:, vn_pos].sum(dim=-1, dtype=torch.int32)

        def syndrome_ok(hard):
            bits = pad1(hard.to(torch.int32))[:, ev]          # (B, M, D)
            synd = bits.sum(dim=-1, dtype=torch.int32) & 1
            return ~synd.bool().any(dim=-1)

        chan32 = chan.to(torch.int32)
        c2v_flat = torch.zeros((B, M * D + 1), dtype=torch.int32,
                               device=chan.device)
        tot = chan32        # totals of the current messages (all zero)
        hard = chan32 < 0
        done = (syndrome_ok(hard) if early_term
                else torch.zeros(B, dtype=torch.bool, device=chan.device))
        iters = torch.zeros(B, dtype=torch.int32, device=chan.device)
        for _ in range(max_iter):
            if early_term and bool(done.all()):
                break
            c2v_d = c2v_flat[:, : M * D].reshape(B, M, D)
            v2c = torch.clamp(pad1(tot)[:, ev] - c2v_d, -qmax, qmax)
            v2c = torch.where(mask, v2c, qmax)
            new_flat = pad1(_cn_update(v2c, mask, beta, alpha)
                            .reshape(B, M * D))
            # Totals of the new messages: this iteration's posterior and the
            # next iteration's input (frozen lanes' totals are never used).
            tot = totals(new_flat)
            hard_new = tot < 0
            if early_term:
                ok_new = syndrome_ok(hard_new)
                keep = done[:, None]
                c2v_flat = torch.where(keep, c2v_flat, new_flat)
                hard = torch.where(keep, hard, hard_new)
                iters += (~done).to(torch.int32)
                done = done | ok_new
            else:
                c2v_flat, hard = new_flat, hard_new
                iters += 1
        conv = done if early_term else syndrome_ok(hard)
        return hard.to(torch.uint8), iters, conv

    return decode
