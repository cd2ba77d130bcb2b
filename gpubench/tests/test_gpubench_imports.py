"""Nothing the benchmark runs imports JAX or the JAX package, compared by
the whole top-level name (the port's name begins with the JAX package's),
and the plain reference imports nothing of the port."""
import ast
import subprocess
import sys

import pytest

from gpubench import registry
from gpubench.run import FORBIDDEN, forbidden_modules

BENCH = registry.HERE


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    return sorted(p for p in (BENCH / sub).rglob("*.py")
                  if "out" not in p.relative_to(BENCH).parts)


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): sorted(set(imported(p))
                                                & set(FORBIDDEN))
             for p in sources()}
    assert not {k: v for k, v in found.items() if v}


def test_reference_imports_nothing_of_the_program():
    for p in sources("reference"):
        assert "ldpc_tpu_torch" not in set(imported(p)), p


@pytest.mark.parametrize("names,bad", [
    (["ldpc_tpu_torch", "ldpc_tpu_torch.sim.sweep", "torch"], []),
    (["ldpc_tpu.codes"], ["ldpc_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jax_utils", "ldpc_tpu_extra"], []),
])
def test_forbidden_names_compare_whole(names, bad):
    assert forbidden_modules(names) == bad


def test_a_run_loads_no_jax():
    code = ("import sys; import gpubench.run, gpubench.control; "
            "import ldpc_tpu_torch.sim.sweep; "
            "from gpubench.run import forbidden_modules; "
            "print(forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
