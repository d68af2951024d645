"""What the benchmark may import: no module under azbench/ imports JAX,
jaxlib, flax or the JAX package (top-level names compared whole: the port's
name begins with the JAX package's); the reference imports nothing of the
port; and a run's process holds none of them."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "alphazero_general_tpu"}
PORT = "alphazero_general_tpu_torch"


def imported_top_levels(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not imported_top_levels(path) & FORBIDDEN


def test_top_level_names_are_compared_whole():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert PORT.startswith("alphazero_general_tpu")


def test_reference_imports_nothing_of_the_port():
    for path in sorted((HERE / "reference").rglob("*.py")):
        names = imported_top_levels(path)
        assert PORT not in names and not names & FORBIDDEN, path
        assert PORT not in path.read_text(), path
    code = ("import sys, azbench.reference, azbench.reference.mcts, "
            "azbench.reference.nets.resnet, azbench.reference.nets.fc; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN | {PORT})!r}]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a_run_loads_no_jax():
    """A whole driver run on the CPU at tiny size leaves no JAX module
    in its process."""
    code = ("import sys, torch; from azbench.tests import tiny; "
            "res, ok = tiny.run(tiny.context('c4.selfplay')); "
            "from azbench.run import jax_modules; "
            "print(jax_modules(), ok); sys.exit(1 if jax_modules() or not ok "
            "else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
