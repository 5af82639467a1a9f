"""No module of the benchmark imports jax, jaxlib, flax or the JAX package
(top-level names compared whole: zerovox_tpu_torch begins with
zerovox_tpu), and the plain reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "zerovox_tpu"}


def imported(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f): imported(f) & FORBIDDEN for f in files if imported(f) & FORBIDDEN}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    for f in (HERE / "reference").rglob("*.py"):
        assert not imported(f) & {"zerovox_tpu_torch", "zerovox_tpu", "benchmark"}, f


def test_load_generator_imports_no_torch():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.loadgen; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'zerovox_tpu_torch', 'jax')))" % str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr
