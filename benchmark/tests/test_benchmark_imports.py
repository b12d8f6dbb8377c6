"""Nothing under ``benchmark/`` imports JAX or the JAX package ``pprx``
(compared by whole top-level names: ``pprx_torch`` is the port), and the
reference imports nothing of the port."""

import ast
import subprocess
import sys

import pytest

from benchmark import harness

FILES = sorted(harness.HERE.rglob("*.py"))


def imported(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert "pprx_torch" not in imported(path)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pprx_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pprx.engine", sys)
    assert harness.forbidden_modules() == ["pprx.engine"]


def test_a_run_loads_no_jax():
    """A tiny run of every kind on the CPU, in a fresh process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "harness.run_cell('stream.b160k', 5, 0.2, False, 'cpu', overrides={'config': {'n': 300, "
        "'window': 3000, 'sources': 4}, 'traffic': {'slide': 150, 'read_every': 2, "
        "'read_eps': 5e-8}, 'params': {'edges_per_s': 1e5, 'check_every': 2}})\n"
        "harness.run_cell('retrieve.s512', 5, 0.2, False, 'cpu', overrides={'config': {'n': 300, "
        "'edges': 3000, 'sources': 8}})\n"
        "print(harness.forbidden_modules())\n" % str(harness.ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
