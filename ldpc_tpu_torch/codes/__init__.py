"""The port's code layer (counterpart of `ldpc_tpu/codes/`).

The family constructors and table compilers beside this file (`code`, `layout`,
`qcstruct`, `ieee80211n`, `nr_bg`, `dvbs2`, `toy`, `alist`, `peg`,
`rate_compat`, `imported`) are numpy copies of the reference's under the
same names, so that the port loads nothing of `ldpc_tpu`. This module holds
what the port adds: `build_code` (the dispatch of
`ldpc_tpu/sim/sweep.py::build_code`), `qc_entries`
(`ldpc_tpu/kernels/minsum_pallas.py::_qc_entries`), `CodeTensors` (the tables
as tensors on one device, with the `ident_info` test of
`ldpc_tpu/sim/pipeline.py`), and `from_reference`/`config_from_reference`,
which carry a code or a config across from the reference package by value.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..device import DeviceLike, resolve_device
from .code import LDPCCode
from .layout import compile_qc_layout


@dataclass(frozen=True, eq=False)
class CodeTensors:
    """One QC code on one device.

    entries[i] lists base row i's circulant entries as (base_col, shift,
    flat_entry_id), base columns ascending. Entry ids run over (layer,
    position), the order of `minsum_pallas._qc_entries`, so c2v entry e of
    the port is c2v entry e of the Pallas kernel. Check row r of layer i
    meets variable base_col*Z + (r + shift) % Z.

    P (m, k) float32 0/1 and perm (n,) int64 are the dense systematic form
    (`golden.encoder.systematic_form`); perm is None where it is the
    identity, and both are None for QC codes above DENSE_MAX_N, whose
    structured encoder is not ported yet.
    """
    code: LDPCCode
    device: torch.device
    n: int
    k: int
    Z: int
    nb: int
    mb: int
    kb: int
    entries: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    P: Optional[torch.Tensor]
    perm: Optional[torch.Tensor]
    info_positions: torch.Tensor
    ident_info: bool

    @property
    def n_entries(self) -> int:
        return sum(len(e) for e in self.entries)


def qc_entries(code: LDPCCode):
    """Per-layer (base_col, shift, flat_entry_id) lists from
    `codes.layout.compile_qc_layout`, in `minsum_pallas._qc_entries` order."""
    qc = compile_qc_layout(code)
    layers, eid = [], 0
    for i in range(qc.mb):
        row = []
        for t in range(qc.max_row_deg):
            if qc.layer_mask[i, t]:
                row.append((int(qc.layer_cols[i, t]),
                            int(qc.layer_shifts[i, t]), eid))
                eid += 1
        layers.append(tuple(row))
    return qc, tuple(layers)


_CODE_FIELDS = ("name", "n", "m", "k", "cn_adj", "Z", "base", "punct_vns",
                "shortened_vns", "standard_exact")


def own_code(code) -> LDPCCode:
    """The port's `LDPCCode` with the fields of `code` (any object that has
    the reference's fields as numpy values; the arrays are copied)."""
    if isinstance(code, LDPCCode):
        return code
    f = {name: getattr(code, name) for name in _CODE_FIELDS}
    return LDPCCode(
        name=str(f["name"]), n=int(f["n"]), m=int(f["m"]), k=int(f["k"]),
        cn_adj=[np.array(a) for a in f["cn_adj"]],
        Z=None if f["Z"] is None else int(f["Z"]),
        base=None if f["base"] is None else np.array(f["base"]),
        punct_vns=np.array(f["punct_vns"]),
        shortened_vns=np.array(f["shortened_vns"]),
        standard_exact=bool(f["standard_exact"]))


def config_from_reference(ref_cfg) -> SimConfig:
    """The port's `SimConfig` equal to a reference `SimConfig`, through its
    JSON form (no class is shared between the packages)."""
    if isinstance(ref_cfg, SimConfig):
        return ref_cfg
    return SimConfig.from_json(ref_cfg.to_json())


def from_reference(code, device: DeviceLike) -> CodeTensors:
    """Turn numpy code tables (the port's `LDPCCode`, or any object with
    the reference's fields) into the port's tensors on one device."""
    # imported here: ops/encode itself imports this package's `code`
    from ..ops.encode import DENSE_MAX_N, has_qc_struct, info_positions
    code = own_code(code)
    dev = resolve_device(device)
    qc, entries = qc_entries(code)
    Z = int(qc.Z)
    P = perm = None
    if not (has_qc_struct(code) and code.n > DENSE_MAX_N):
        from ..golden.encoder import systematic_form
        P_np, perm_np = systematic_form(code)
        P = torch.as_tensor(P_np.astype(np.float32), device=dev)
        if not np.array_equal(perm_np, np.arange(code.n)):
            perm = torch.as_tensor(np.asarray(perm_np, np.int64), device=dev)
    info_pos = info_positions(code)
    # as sim/pipeline.py computes it for the fused-IO decoder
    ident_info = (code.k % Z == 0
                  and np.array_equal(info_pos, np.arange(code.k)))
    return CodeTensors(
        code=code, device=dev, n=int(code.n), k=int(code.k), Z=Z,
        nb=int(qc.nb), mb=int(qc.mb), kb=int(code.k) // Z, entries=entries,
        P=P, perm=perm,
        info_positions=torch.as_tensor(np.asarray(info_pos, np.int64),
                                       device=dev),
        ident_info=bool(ident_info))


def _rate_value(rate: str) -> float:
    return float(Fraction(rate))


def build_code(cfg: SimConfig) -> LDPCCode:
    """CodeConfig -> LDPCCode across all supported families (a copy of
    `ldpc_tpu/sim/sweep.py::build_code`; pure dispatch into the family
    constructors of this package)."""
    c = cfg.code
    if c.family == "ieee80211n":
        from .ieee80211n import make_code
        code = make_code(c.n, c.rate)
    elif c.family == "5gnr":
        from .nr_bg import make_code as make_nr
        code = make_nr(base_graph=c.base_graph, Z=c.Z, rate=c.rate,
                       k_info=c.k_info)
    elif c.family == "dvbs2":
        from .dvbs2 import make_code as make_dvb
        code = make_dvb(n=c.n, rate=c.rate)
    elif c.family == "toy":
        from .toy import toy_qc
        code = toy_qc(c.Z or 4)
    elif c.family == "alist":
        if not c.path:
            raise ValueError("alist family requires CodeConfig.path")
        from .alist import read_alist
        code = read_alist(c.path)
    elif c.family == "qcpeg":
        from .peg import parse_profile, qc_peg_construct
        if not c.Z:
            raise ValueError("qcpeg family requires CodeConfig.Z")
        if c.n % c.Z:
            raise ValueError(f"qcpeg: n={c.n} not a multiple of Z={c.Z}")
        nb = c.n // c.Z
        kb = round(nb * _rate_value(c.rate))
        if not 0 < kb < nb:
            raise ValueError(f"qcpeg: rate {c.rate} gives kb={kb} of nb={nb}")
        code = qc_peg_construct(kb=kb, cb=nb - kb, Z=c.Z,
                                col_degrees=parse_profile(c.profile, kb),
                                seed=c.code_seed)
    elif c.family == "pbrl":
        from .peg import parse_profile, pbrl_construct
        if not c.Z:
            raise ValueError("pbrl family requires CodeConfig.Z")
        if c.n % c.Z:
            raise ValueError(f"pbrl: n={c.n} not a multiple of Z={c.Z}")
        nb = c.n // c.Z
        kb = round(nb * _rate_value(c.rate))
        n_ext = nb - kb - c.core_rows
        if not 0 < kb < nb or n_ext < 0:
            raise ValueError(f"pbrl: rate {c.rate} with core_rows="
                             f"{c.core_rows} gives kb={kb}, n_ext={n_ext}")
        code = pbrl_construct(kb=kb, cb=c.core_rows, Z=c.Z, n_ext=n_ext,
                              core_col_degrees=parse_profile(
                                  c.profile, kb) if c.profile
                              else min(3, c.core_rows),
                              ext_row_degree=c.ext_row_degree,
                              seed=c.code_seed)
    else:
        raise ValueError(f"unknown code family {c.family}")
    if c.shorten_bits:
        from .rate_compat import shorten
        code = shorten(code, c.shorten_bits)
    if c.punct_frac:
        from .rate_compat import puncture
        code = puncture(code, frac=c.punct_frac, scheme=c.punct_scheme,
                        seed=cfg.run.seed)
    return code
