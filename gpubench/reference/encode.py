"""Systematic encoder of a QC code whose parity part is the 802.11n
dual-diagonal form, in plain torch, batch first.

The parity part has a first column of rotations whose GF(2) sum is one
rotation C(t), and a staircase: parity column kb + t (t >= 1) holds the
identity in base rows t - 1 and t. Adding every base row cancels the
staircase, so C(t) p0 = sum of the rows' information syndromes; the rows then
give p1, p2, ... in turn. The codeword is [info | p0 | p1 | ...]; it is unique
where the parity part is invertible, so any correct encoder gives it.
"""
from __future__ import annotations

from typing import List

import torch

from .qc import QCCode, circulant_sum


def rot(v: torch.Tensor, s: int) -> torch.Tensor:
    """C(s) v over the last axis: row r reads v[(r + s) % Z]."""
    return torch.roll(v, -int(s), dims=-1) if s else v


class Encoder:
    def __init__(self, code: QCCode):
        base, kb, mb = code.base, code.kb, code.mb
        for t in range(1, mb):
            col = base[:, kb + t]
            rows = [int(i) for i in (col >= 0).nonzero()[0]]
            if rows != [t - 1, t] or col[t - 1] or col[t]:
                raise ValueError(f"parity column {kb + t} is not the "
                                 f"staircase's (rows {rows})")
        first = [int(s) for s in base[:, kb] if s >= 0]
        left = circulant_sum(first, code.Z)
        if len(left) != 1:
            raise ValueError(f"the first parity column's rotations {first} "
                             f"do not sum to one rotation")
        self.code = code
        self.t = left[0]

    def __call__(self, info: torch.Tensor) -> torch.Tensor:
        """info (B, k) uint8 -> codeword (B, n) uint8."""
        code = self.code
        B, Z, kb = info.shape[0], code.Z, code.kb
        x = info.to(torch.uint8).reshape(B, kb, Z)
        lam: List[torch.Tensor] = []
        for i in range(code.mb):
            acc = torch.zeros((B, Z), dtype=torch.uint8, device=info.device)
            for j in range(kb):
                s = int(code.base[i, j])
                if s >= 0:
                    acc ^= rot(x[:, j], s)
            lam.append(acc)
        total = lam[0].clone()
        for v in lam[1:]:
            total ^= v
        p0 = rot(total, -self.t)
        pars = [p0]
        for i in range(code.mb - 1):
            acc = lam[i].clone()
            s = int(code.base[i, kb])
            if s >= 0:
                acc ^= rot(p0, s)
            if i:
                acc ^= pars[i]
            pars.append(acc)
        return torch.cat([x.reshape(B, -1)] + pars, dim=1)
