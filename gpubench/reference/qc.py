"""A quasi-cyclic LDPC code from its base matrix, in plain numpy.

The base matrix is the configuration file's `code.base_entries`: a list of
(base row, base column, shift). Entry (i, j, s) places the Z x Z identity
rotated by s: check i*Z + r reads variable j*Z + (r + s) % Z. Empty blocks are
left out. The information bits are the first k variables.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass(frozen=True)
class QCCode:
    Z: int
    mb: int
    nb: int
    k: int
    base: np.ndarray          # (mb, nb) int64 shifts, -1 for an empty block

    @property
    def n(self) -> int:
        return self.nb * self.Z

    @property
    def m(self) -> int:
        return self.mb * self.Z

    @property
    def kb(self) -> int:
        return self.k // self.Z

    @property
    def edges(self) -> int:
        return int((self.base >= 0).sum()) * self.Z

    def row_blocks(self, i: int):
        """(columns, shifts) of base row i, columns ascending."""
        cols = np.nonzero(self.base[i] >= 0)[0]
        return cols, self.base[i, cols]

    def layer_vars(self, i: int) -> np.ndarray:
        """(Z, d_i) int64: the variable that check (i, r) reads in slot t."""
        cols, shifts = self.row_blocks(i)
        r = np.arange(self.Z)[:, None]
        return cols[None, :] * self.Z + (r + shifts[None, :]) % self.Z

    def check_vars(self) -> np.ndarray:
        """(m, dmax) int64 variables of every check, padded with n (a slot
        past the last variable)."""
        dmax = int((self.base >= 0).sum(axis=1).max())
        out = np.full((self.m, dmax), self.n, np.int64)
        for i in range(self.mb):
            v = self.layer_vars(i)
            out[i * self.Z:(i + 1) * self.Z, :v.shape[1]] = v
        return out


def from_entries(entries: Sequence[Sequence[int]], Z: int, mb: int, nb: int,
                 k: int) -> QCCode:
    base = np.full((mb, nb), -1, np.int64)
    for i, j, s in entries:
        if not (0 <= i < mb and 0 <= j < nb and 0 <= s < Z):
            raise ValueError(f"base entry {(i, j, s)} outside ({mb}, {nb}) "
                             f"with Z = {Z}")
        if base[i, j] >= 0:
            raise ValueError(f"base entry ({i}, {j}) given twice")
        base[i, j] = s
    if k != (nb - mb) * Z:
        raise ValueError(f"k = {k} is not (nb - mb) * Z = {(nb - mb) * Z}")
    if (base >= 0).sum(axis=1).min() < 2:
        raise ValueError("a check of degree below 2")
    return QCCode(Z=Z, mb=mb, nb=nb, k=k, base=base)


def from_config(code_cfg: dict) -> QCCode:
    return from_entries(code_cfg["base_entries"], int(code_cfg["Z"]),
                        int(code_cfg["mb"]), int(code_cfg["nb"]),
                        int(code_cfg["k"]))


def circulant_sum(shifts: List[int], Z: int) -> List[int]:
    """The shifts left of a sum of rotations over GF(2): equal shifts
    cancel in pairs."""
    odd = sorted(s for s in set(shifts) if shifts.count(s) % 2)
    return [s % Z for s in odd]
