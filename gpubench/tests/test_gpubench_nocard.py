"""Without a card the benchmark exits non-zero and prints no result, rather
than timing the CPU; so it does in a directory that holds only
BENCHMARK.json and the benchmark."""
import json
import os
import shutil
import subprocess
import sys

from gpubench import registry


def run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload", "wifi648-mc",
         "--seed", "4000000123", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def no_result(out):
    for line in out.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert "correct" not in obj


def test_no_card_exits_nonzero_without_a_result():
    out = run(registry.ROOT)
    assert out.returncode != 0
    no_result(out)
    assert "CUDA" in out.stderr


def test_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copytree(registry.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    out = run(tmp_path, {"BENCH_RUN": "1"})
    assert out.returncode != 0
    no_result(out)
