"""Fixed-point min-sum decoding, plain torch, batch first, on any device.

The semantics (the simulator's pinned fixed-point model):
  * channel LLRs are integers in [-qmax, qmax]; posteriors are exact wide
    integers; a variable-to-check message is the posterior minus the check's
    last message, saturated to [-qmax, qmax];
  * a check's message to edge e is S * sign(v2c[e]) * min(max(m_e - beta, 0),
    qmax): S the product of the signs of its inputs (zero counts positive),
    m_e the smallest input magnitude over the other edges;
  * flooding: every check reads the posteriors of the last iteration;
    layered: the base rows in order, each reading the posteriors the rows
    before it left (a base row's Z checks share no variable);
  * bit = 1 where the posterior is negative; a lane has converged when its
    hard decision satisfies every check. With early termination a lane stops
    at its first iteration that converges (0 if the channel's decision is
    already a codeword) and keeps that decision.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .qc import QCCode

BIG = 1 << 14


def check_update(v2c: torch.Tensor, pad: torch.Tensor, beta: int,
                 qmax: int) -> torch.Tensor:
    """New check messages for v2c (..., d) int32; pad (d,) or broadcastable
    bool marks slots that are no edge (they read no input and get 0)."""
    mag = torch.where(pad, BIG, v2c.abs())
    min1, arg = mag.min(dim=-1, keepdim=True)
    min2 = mag.scatter(-1, arg, BIG).min(dim=-1, keepdim=True).values
    slot = torch.arange(v2c.shape[-1], device=v2c.device)
    excl = torch.where(slot == arg, min2, min1)
    out_mag = torch.clamp(torch.clamp(excl - beta, min=0), max=qmax)
    neg = (v2c < 0) & ~pad
    odd = (neg.sum(dim=-1, keepdim=True) & 1).bool()
    out = torch.where(neg ^ odd, -out_mag, out_mag)
    return torch.where(pad, 0, out)


class Decoder:
    def __init__(self, code: QCCode, schedule: str, max_iter: int, beta: int,
                 qmax: int, early_term: bool, device):
        if schedule not in ("flooding", "layered"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.code, self.schedule = code, schedule
        self.max_iter, self.beta, self.qmax = max_iter, beta, qmax
        self.early_term = early_term
        cv = code.check_vars()
        self.check_vars = torch.as_tensor(cv, device=device)      # (m, dmax)
        self.check_pad = torch.as_tensor(cv == code.n, device=device)
        self.layers = [torch.as_tensor(code.layer_vars(i), device=device)
                       for i in range(code.mb)]

    def syndrome_ok(self, hard: torch.Tensor) -> torch.Tensor:
        """(B,) bool: hard (B, n) uint8 satisfies every check."""
        B = hard.shape[0]
        ext = torch.cat([hard, hard.new_zeros((B, 1))], dim=1)
        par = ext[:, self.check_vars].to(torch.int32).sum(dim=-1) & 1
        return ~par.bool().any(dim=1)

    def __call__(self, chan: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """chan (B, n) int8 -> (hard (B, n) uint8, iters (B,) int64,
        converged (B,) bool)."""
        chan = chan.to(torch.int32)
        B = chan.shape[0]
        dev = chan.device
        hard = (chan < 0).to(torch.uint8)
        iters = torch.zeros(B, dtype=torch.int64, device=dev)
        done = (self.syndrome_ok(hard) if self.early_term
                else torch.zeros(B, dtype=torch.bool, device=dev))
        if self.schedule == "flooding":
            step, state = self._flood_step, self._flood_init(chan)
        else:
            step, state = self._layered_step, self._layered_init(chan)
        for _ in range(self.max_iter):
            if self.early_term and bool(done.all()):
                break
            post = step(chan, state)
            now = (post < 0).to(torch.uint8)
            hard = torch.where(done[:, None], hard, now)
            iters = torch.where(done, iters, iters + 1)
            if self.early_term:
                done = done | self.syndrome_ok(hard)
        conv = done if self.early_term else self.syndrome_ok(hard)
        return hard, iters, conv

    # flooding: c2v (B, m, dmax) in check-slot order
    def _flood_init(self, chan: torch.Tensor) -> dict:
        m, d = self.check_vars.shape
        return {"c2v": torch.zeros((chan.shape[0], m, d), dtype=torch.int32,
                                   device=chan.device)}

    def _totals(self, chan: torch.Tensor, c2v: torch.Tensor) -> torch.Tensor:
        B, n = chan.shape
        tot = torch.cat([chan, chan.new_zeros((B, 1))], dim=1)
        tot = tot.index_add(1, self.check_vars.reshape(-1),
                            c2v.reshape(B, -1))
        return tot

    def _flood_step(self, chan: torch.Tensor, state: dict) -> torch.Tensor:
        c2v = state["c2v"]
        tot = self._totals(chan, c2v)
        v2c = torch.clamp(tot[:, self.check_vars] - c2v, -self.qmax,
                          self.qmax)
        c2v = check_update(v2c, self.check_pad, self.beta, self.qmax)
        state["c2v"] = c2v
        return self._totals(chan, c2v)[:, :-1]

    # layered: posteriors (B, n) and one c2v (B, Z, d_i) a base row
    def _layered_init(self, chan: torch.Tensor) -> dict:
        B = chan.shape[0]
        return {"post": chan.clone(),
                "c2v": [torch.zeros((B,) + tuple(v.shape), dtype=torch.int32,
                                    device=chan.device)
                        for v in self.layers]}

    def _layered_step(self, chan: torch.Tensor, state: dict) -> torch.Tensor:
        post, c2v = state["post"], state["c2v"]
        nopad = torch.zeros((), dtype=torch.bool, device=chan.device)
        for i, idx in enumerate(self.layers):
            old = c2v[i]
            pre = post[:, idx]
            v2c = torch.clamp(pre - old, -self.qmax, self.qmax)
            new = check_update(v2c, nopad, self.beta, self.qmax)
            post[:, idx] = pre + (new - old)
            c2v[i] = new
        return post


def cn_beta(algorithm: str, beta_lsb: int) -> int:
    if algorithm == "min-sum":
        return 0
    if algorithm == "offset-min-sum":
        return int(beta_lsb)
    raise ValueError(f"the reference decodes min-sum and offset min-sum, "
                     f"not {algorithm!r}")
