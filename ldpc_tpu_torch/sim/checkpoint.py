"""Sweep checkpoint/resume (a copy of `ldpc_tpu/sim/checkpoint.py`): the
same schema and `_VERSION`, so either package's `load` reads the other's
file.

The sweep state is the counter set per SNR point plus the run meta; resume
re-seeds each batch from (seed, snr_index, batch_index), so a restarted
sweep runs exactly the batches the interrupted one would have run next.
Written atomically after every batch. The port's `Sweep` adds the key
"rng_stream" to the meta, which names the port's random streams: a
checkpoint of the reference (threefry or the TPU PRNG) and one of the port
then never resume each other, since the merged counters would not be a
sample-exact continuation.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional

from .stats import SnrPoint

_VERSION = 1


def save(path: str, config_json: str, points: List[SnrPoint],
         meta: Optional[Dict] = None) -> None:
    state = {
        "version": _VERSION,
        "config": json.loads(config_json),
        "meta": meta or {},
        "points": [dataclasses.asdict(p) for p in points],
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, path)  # atomic on POSIX
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        state = json.load(f)
    if state.get("version") != _VERSION:
        raise ValueError(f"unsupported checkpoint version {state.get('version')}")
    state["points"] = [
        SnrPoint(**{k: v for k, v in p.items() if not k.startswith("_")})
        for p in state["points"]
    ]
    return state
