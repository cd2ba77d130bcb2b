"""Imported exact standard tables: the registry the family constructors consult
first (a copy of the lookup half of `ldpc_tpu/codes/imported.py`).

A stored table flips the built code to ``standard_exact=True`` with a
``_std`` name suffix, and nothing else in the stack changes. Validating and
importing a candidate table waits for the port of the rest of
`ldpc_tpu/codes/imported.py` (`validate_table`, `smoke_decode`) and of the
CLI's `import-standard` command.

Registry location: $LDPC_TPU_TABLES or <repo>/imported_tables/, shared with
the reference: one JSON file per table: {"family", "key", "Z", "base" (list
of rows, -1 = no edge), "k" (optional), "meta"}.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np


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
