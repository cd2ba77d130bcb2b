"""Finds a workload's configuration, traffic and metrics by name.

`BENCHMARK.json` at the root of the checkout names every workload, its
configuration and its traffic, and every metric. A configuration is the
file that its `configs` entry names, a traffic mix is `cells/<traffic>.json`
beside this file, and a metric is `metrics/<metric>.py`, a module with a
function `read(run)` that returns the metric's value, or None where it finds
nothing to read. So a cell, a configuration or a metric is added as new
files and entries, with no edit to a file that is there.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Set

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    kind: str                 # "end_to_end" or "per_layer"
    entry: dict


@dataclass(frozen=True)
class Workload:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: List[Metric]      # those this cell reports, in file order
    root: Path

    def reported(self, trace: bool) -> List[Metric]:
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.metrics if m.kind == kind]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(name: str, root: Path = ROOT) -> Workload:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / HERE.name / "cells" / f"{cell['traffic']}.json").read_text())
    metrics = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if name in m.get("workloads", [name]):
                metrics.append(Metric(m["name"], m["unit"], kind, m))
    return Workload(name=name, chips=int(cell["chips"]), config=config,
                    traffic=traffic, metrics=metrics, root=root)


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """metrics/<name>.py, loaded from its file (a name may hold dots)."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{HERE.name}_metric_{re.sub(r'[^0-9A-Za-z_]', '_', name)}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)"
    r"\s*)?([A-Za-z_]\w*)\s*\(")


def decoder_kernels(root: Path = ROOT,
                    package: str = "ldpc_tpu_torch") -> Set[str]:
    """The names of the `__global__` functions of the program's decoder
    sources, `kernels/csrc/*.cu` (read at set-up, so that a kernel a later
    change adds counts where it is defined)."""
    names: Set[str] = set()
    for src in sorted((root / package / "kernels" / "csrc").glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return names


def read_metrics(wl: Workload, trace: bool, run) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for m in wl.reported(trace):
        value: Optional[float] = metric_reader(m.name, wl.root).read(run)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out
