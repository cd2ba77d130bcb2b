"""Result reporting (a copy of `ldpc_tpu/sim/report.py`): the CSV/JSON
writers with the reference's columns, and the BER/FER waterfall plot, which
imports matplotlib only when called."""
from __future__ import annotations

import csv
import io
import os
from typing import List, Optional

from .sweep import SweepResult

_COLUMNS = ["ebn0_db", "frames", "bit_errs", "frame_errs",
            "ber", "ber_lo", "ber_hi", "fer", "fer_lo", "fer_hi",
            "avg_iters", "early_term_rate", "wall_s", "info_bps"]


def to_csv(result: SweepResult) -> str:
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=_COLUMNS)
    w.writeheader()
    for row in result.rows():
        w.writerow({k: row[k] for k in _COLUMNS})
    return buf.getvalue()


def write_outputs(result: SweepResult, prefix: str) -> List[str]:
    parent = os.path.dirname(os.path.abspath(prefix))
    os.makedirs(parent, exist_ok=True)  # don't lose a finished sweep
    paths = []
    with open(prefix + ".json", "w") as f:
        f.write(result.to_json())
    paths.append(prefix + ".json")
    with open(prefix + ".csv", "w") as f:
        f.write(to_csv(result))
    paths.append(prefix + ".csv")
    return paths


def plot_waterfall(results: List[SweepResult], path: str,
                   metric: str = "ber", title: Optional[str] = None) -> str:
    """semilogy BER/FER vs Eb/N0, one curve per result. Raises ImportError
    where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_waterfall needs matplotlib, which is not "
                          "installed here; the JSON and CSV outputs are "
                          "written without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for r in results:
        rows = [row for row in r.rows() if row[metric] > 0]
        xs = [row["ebn0_db"] for row in rows]
        line, = ax.semilogy(xs, [row[metric] for row in rows],
                            marker="o",
                            label=f"{r.code_name} [{r.decoder_backend}]")
        if rows and f"{metric}_lo" in rows[0]:
            # 99% Wilson band (lo clipped away from 0 for the log axis)
            his = [row[f"{metric}_hi"] for row in rows]
            los = [max(row[f"{metric}_lo"], row[metric] * 1e-2)
                   for row in rows]
            ax.fill_between(xs, los, his, alpha=0.15,
                            color=line.get_color(), linewidth=0)
    ax.set_xlabel("Eb/N0 (dB)")
    ax.set_ylabel(metric.upper())
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
