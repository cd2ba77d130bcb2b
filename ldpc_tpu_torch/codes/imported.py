"""Imported exact standard tables: the one-command swap-in seam (a copy of
`ldpc_tpu/codes/imported.py`, with the decode smoke test on the port's
decoders).

    python -m ldpc_tpu_torch.cli import-standard --family ieee80211n \
        --n 648 --rate 5/6 --file table.json

validates a candidate table against the family's structural invariants
(dimensions, shift ranges, GF(2) rank, girth, dual-diagonal/IRA
encodability, degree profile where the family pins it), runs a decode smoke
test on the card (or, asked for, on the CPU) and stores it in the table
registry. Every family constructor (codes/ieee80211n.py, codes/nr_bg.py,
codes/dvbs2.py) consults the registry first: a stored table flips the built
code to ``standard_exact=True`` with a ``_std`` name suffix, and nothing
else in the stack changes. A stored 5gnr table is the base graph of every
NR code of its (base graph, Z), whatever seed `nr_bg.full_graph` is given,
as in the reference.

`store`, `remove`, `parse_table_file` and `validate_table` are copies of
the reference's. `smoke_decode` keeps the reference's code, quantizer,
decoder, operating point, pass rule and report, and decodes through
`sim/pipeline.select_decoder` with `auto`, batch first: on the card the
route rule's kernel (K3's packed layered kernel for the 802.11n sizes, the
streaming kernels where `resolve_route` streams), on the CPU its plain
version. Its noise is torch's (a `torch.Generator` seeded with `seed`), not
the reference's threefry, so its BER is the reference's in distribution;
`smoke_decode_batch` is the decode step on a given int8 batch.

Registry location: $LDPC_TPU_TABLES or <repo>/imported_tables/, shared with
the reference: one JSON file per table: {"family", "key", "Z", "base" (list
of rows, -1 = no edge), "k" (optional), "meta"}.

Input file formats for the CLI:
  * JSON: {"Z": int, "base": [[...]]} (family/key come from the flags);
  * text: whitespace grid of shifts, '-' or -1 for absent entries.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import DecoderConfig, QuantConfig, SimConfig
from ..device import DeviceLike


def tables_dir() -> str:
    d = os.environ.get("LDPC_TPU_TABLES")
    if not d:
        d = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "imported_tables")
    return d


def _path(family: str, key: str) -> str:
    return os.path.join(tables_dir(), f"{family}_{key}.json")


def lookup(family: str, key: str
           ) -> Optional[Tuple[int, np.ndarray, Optional[int], Dict]]:
    """(Z, base, k, meta) for a stored exact table, or None."""
    p = _path(family, key)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        d = json.load(f)
    base = np.asarray(d["base"], np.int64)
    return int(d["Z"]), base, d.get("k"), d.get("meta", {})


def store(family: str, key: str, Z: int, base: np.ndarray,
          k: Optional[int] = None, meta: Optional[Dict] = None) -> str:
    os.makedirs(tables_dir(), exist_ok=True)
    p = _path(family, key)
    with open(p, "w") as f:
        json.dump({"family": family, "key": key, "Z": int(Z),
                   "base": np.asarray(base, np.int64).tolist(),
                   "k": k, "meta": meta or {}}, f)
    return p


def remove(family: str, key: str) -> bool:
    p = _path(family, key)
    if os.path.exists(p):
        os.remove(p)
        return True
    return False


def parse_table_file(path: str) -> Tuple[Optional[int], np.ndarray]:
    """(Z_or_None, base) from a JSON or whitespace-grid shift file."""
    text = open(path).read()
    if path.endswith(".json") or text.lstrip().startswith("{"):
        d = json.loads(text)
        return (int(d["Z"]) if "Z" in d else None,
                np.asarray(d["base"], np.int64))
    rows: List[List[int]] = []
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if not line:
            continue
        rows.append([-1 if t in ("-", ".") else int(t)
                     for t in line.split()])
    if not rows or any(len(r) != len(rows[0]) for r in rows):
        raise ValueError(f"{path}: empty or ragged shift grid")
    return None, np.asarray(rows, np.int64)


# ---------------------------------------------------------------------------
# Validation against the family invariants (SURVEY.md §8.1)
# ---------------------------------------------------------------------------

def validate_table(family: str, Z: int, base: np.ndarray,
                   n: Optional[int] = None, rate: Optional[str] = None,
                   base_graph: Optional[int] = None) -> Dict:
    """Validate a candidate exact table against the family's structural
    invariants. Returns a report dict; raises ValueError on any violation.

    Checks (all families): dimension match, shifts in [-1, Z), full GF(2)
    rank, IRA/dual-diagonal encodability (qcstruct.detect_enc_struct).
    802.11n additionally: exact degree profile vs the in-repo table (the
    published profiles are certain even where single digits are not) and
    girth >= 6. DVB-S2: girth >= 6. NR: girth >= 4 reported, not enforced
    (the 38.212 lifted graphs' girth is not pinned here)."""
    from .alist import _gf2_rank
    from .code import expand_qc
    from .qcstruct import detect_enc_struct

    base = np.asarray(base, np.int64)
    mb, nb = base.shape
    report: Dict = {"family": family, "mb": mb, "nb": nb, "Z": Z}
    if np.any(base < -1) or np.any(base >= Z):
        raise ValueError(f"shift out of range: entries must be in "
                         f"[-1, {Z})")

    if family == "ieee80211n":
        from .ieee80211n import RATES, Z_OF_N, _base_matrix_meta
        if n not in Z_OF_N or rate not in RATES:
            raise ValueError(f"not an 802.11n code point: ({n}, {rate})")
        if Z != Z_OF_N[n]:
            raise ValueError(f"Z={Z} but 802.11n n={n} has Z={Z_OF_N[n]}")
        # reference = the PINNED in-repo reconstruction, never make_code:
        # make_code consults this registry, so a previously stored table
        # must not become the validation yardstick for the next one
        # (advisor round-5: registry laundering)
        ref_base, _ = _base_matrix_meta(n, rate)
        if base.shape != ref_base.shape:
            raise ValueError(f"base shape {base.shape} != expected "
                             f"{ref_base.shape}")
        # the published degree PROFILE is certain even where the repaired
        # tables' digits are not: per-column and per-row edge counts must
        # match the in-repo table exactly
        cand_col = (base >= 0).sum(axis=0)
        cand_row = (base >= 0).sum(axis=1)
        ref_col = (ref_base >= 0).sum(axis=0)
        ref_row = (ref_base >= 0).sum(axis=1)
        if not (np.array_equal(cand_col, ref_col)
                and np.array_equal(cand_row, ref_row)):
            raise ValueError("degree profile differs from the published "
                             "802.11n profile")
        min_girth = 6
    elif family == "dvbs2":
        from .dvbs2 import N_NORMAL, N_SHORT, PROFILES, SHORT_K, Z as DVB_Z
        if n not in (N_NORMAL, N_SHORT) or rate not in PROFILES \
                or (n == N_SHORT and rate not in SHORT_K):
            raise ValueError(f"not a DVB-S2 code point: ({n}, {rate})")
        if Z != DVB_Z:
            raise ValueError(f"Z={Z} but DVB-S2 QC form has Z={DVB_Z}")
        k = SHORT_K[rate] if n == N_SHORT else PROFILES[rate][0]
        if (mb, nb) != ((n - k) // Z, n // Z):
            raise ValueError(f"base shape {(mb, nb)} != expected "
                             f"{((n - k) // Z, n // Z)} for n={n} "
                             f"rate={rate}")
        min_girth = 6
    elif family == "5gnr":
        from .nr_bg import _PARAMS
        if base_graph not in _PARAMS:
            raise ValueError(f"base_graph must be 1 or 2, got {base_graph}")
        p = _PARAMS[base_graph]
        if (mb, nb) != (p["mb"], p["kb"] + p["mb"]):
            raise ValueError(
                f"BG{base_graph} base must be "
                f"{(p['mb'], p['kb'] + p['mb'])}, got {(mb, nb)}")
        min_girth = 4
    else:
        raise ValueError(f"import-standard supports ieee80211n / 5gnr / "
                         f"dvbs2, not {family!r}")

    st = detect_enc_struct(base)
    if st is None:
        raise ValueError("no dual-diagonal/IRA encodable parity structure "
                         "detected (detect_enc_struct failed) — every "
                         "supported standard family is IRA-encodable")
    report["enc_struct"] = {"kb": st.kb, "cb": st.cb}

    code = expand_qc(base, Z, name=f"candidate_{family}")
    rank = _gf2_rank(code.cn_adj, code.n)
    report["rank"] = rank
    if rank != code.m:
        raise ValueError(f"H is rank-deficient: rank {rank} < m {code.m}")

    from .peg import girth as exact_girth
    g = exact_girth(code, cutoff=12)
    report["girth"] = g
    if g < min_girth:
        msg = f"girth {g} < required {min_girth} for {family}"
        if family == "5gnr":
            report["girth_warning"] = msg
        else:
            raise ValueError(msg)
    return report


# The reference's smoke configuration (ldpc_tpu/codes/imported.py:233-236):
# 8-bit OMS beta 1, layered, 20 iterations, DecoderConfig's default early
# termination.
SMOKE_QUANT = QuantConfig(bits=8, scale=4.0, beta_lsb=1)
SMOKE_DECODER = DecoderConfig(algorithm="offset-min-sum", max_iter=20,
                              schedule="layered")
SMOKE_SEED = 5


def smoke_operating_point(rate: float,
                          ebn0_db: Optional[float] = None
                          ) -> Tuple[float, float]:
    """(Eb/N0 dB, BPSK sigma): by default the Shannon Eb/N0 for rate R plus
    3.5 dB, rounded to 0.01 dB, as the reference computes it."""
    from ..ops.channel import sigma_for
    if ebn0_db is None:
        shannon = 10.0 * math.log10((2.0 ** (2 * rate) - 1) / (2 * rate))
        ebn0_db = round(shannon + 3.5, 2)
    return ebn0_db, sigma_for(ebn0_db, rate, "bpsk")


def smoke_llrs(ct, frames: int, sigma: float, seed: int):
    """The smoke test's decoder input: int8 LLRs (frames, n) of all-zeros
    BPSK frames over AWGN of `sigma`, the noise drawn from a
    torch.Generator seeded with `seed` on ct's device."""
    import torch

    from ..ops import channel as ch
    from ..ops.quantize import quantize
    gen = torch.Generator(device=ct.device)
    gen.manual_seed(seed)
    z = sigma * torch.randn((frames, ct.n), generator=gen,
                            device=ct.device, dtype=torch.float32)
    return quantize(ch.demap(1.0 + z, sigma, "bpsk"), SMOKE_QUANT)


def smoke_decoder(ct, batch: int):
    """(decoder, label) of the smoke test's decode step: `select_decoder`
    with `auto`, batch first, at `batch` frames."""
    from ..sim.pipeline import select_decoder
    cfg = SimConfig(quant=SMOKE_QUANT, decoder=SMOKE_DECODER)
    return select_decoder(ct, cfg, batch=batch, batch_first=True)


def smoke_decode_batch(ct, q):
    """The smoke test's decode step: int8 LLRs q (B, n) on ct's device ->
    (hard (B, n) uint8, conv (B,) bool, the decoder's label)."""
    dec, label = smoke_decoder(ct, int(q.shape[0]))
    hard, _, conv = dec(q)
    return hard, conv, label


def smoke_decode(Z: int, base: np.ndarray, frames: int = 128,
                 ebn0_db: Optional[float] = None, seed: int = SMOKE_SEED,
                 device: DeviceLike = "cuda") -> Dict:
    """Decode smoke test: all-zeros BPSK/AWGN frames through the OMS
    layered decoder must beat the uncoded BER at the operating point by
    >= 10x, a loose catastrophic-table catch, not a waterfall
    measurement. The default operating point is rate-aware (the Shannon
    Eb/N0 for rate R plus 3.5 dB: comfortably inside any working standard
    code's waterfall, far below a broken table's). Runs on `device`: the
    card unless the caller asks for the CPU; a CUDA request without a card
    raises."""
    import torch

    from . import from_reference
    from .code import expand_qc

    code = expand_qc(base, Z, name="import_smoke")
    R = code.k / code.n
    ebn0_db, sigma = smoke_operating_point(R, ebn0_db)
    ct = from_reference(code, device)
    hard, conv, _ = smoke_decode_batch(ct, smoke_llrs(ct, frames, sigma,
                                                      seed))
    ber = float(hard.to(torch.float64).mean())
    uncoded = 0.5 * math.erfc(1.0 / (sigma * math.sqrt(2.0)))
    report = {"frames": frames, "ebn0_db": ebn0_db, "ber": ber,
              "uncoded_ber": uncoded,
              "conv_rate": float(conv.to(torch.float64).mean())}
    if ber > uncoded / 10.0:
        raise ValueError(
            f"smoke decode failed: coded BER {ber:.3e} is not >=10x below "
            f"uncoded {uncoded:.3e} at {ebn0_db} dB — table is not a "
            f"working code at this operating point")
    return report
