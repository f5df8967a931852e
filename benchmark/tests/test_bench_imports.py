"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program either."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import run as bench_run

HERE = Path(__file__).resolve().parent.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "optax", "tacotron_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module a file imports, whole."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_the_jax_side():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & JAX_SIDE, path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert not _imports(path) & (JAX_SIDE | {"tacotron_tpu_torch"}), path


def test_a_prefix_of_the_jax_package_name_is_not_the_jax_package():
    assert "tacotron_tpu_torch" not in JAX_SIDE
    assert set(bench_run.FORBIDDEN) == JAX_SIDE


def test_a_run_loads_no_jax_side_module():
    code = ("import sys; from benchmark.tests import tiny; tiny.run('serve_fast.f32.b8'); "
            "from benchmark import run; print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
