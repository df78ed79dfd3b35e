"""The import rule: nothing the benchmark runs loads JAX or the JAX
package, names compared whole by their top-level part (``repro_torch``
begins with ``repro`` and is the program); the references import nothing
of the program."""
import ast
import sys

import pytest

import run as bench_run

from conftest import BENCH

BANNED = {"jax", "jaxlib", "flax", "repro"}


def imported_roots(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_roots(path) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert imported_roots(path) <= {"__future__", "math", "torch",
                                    "harness"}
    harness = {n.module for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.ImportFrom) and n.module
               and n.module.startswith("harness")}
    assert harness <= {"harness.weights"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_x", object())
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    for name in list(sys.modules):
        if name.split(".")[0] in BANNED:
            monkeypatch.delitem(sys.modules, name)
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.serving", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert bench_run.forbidden_modules() == ["jax", "repro"]


def test_a_run_imports_no_jax():
    """A fresh process that imports everything a run imports holds no
    banned top-level name."""
    import subprocess
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run, harness.serve, harness.check, harness.devtrace\n"
            "import repro_torch.serving.gateway, repro_torch.serving.engine\n"
            "import repro_torch.models.registry\n"
            "import repro_torch.serving.telemetry\n"
            "print(run.forbidden_modules())"
            % (str(BENCH), str(BENCH.parent / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
