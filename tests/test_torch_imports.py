"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package (``repro``), at any depth
of the module (function-level imports included). Parsed with ``ast``, so
the check needs neither package importable.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_the_port_has_modules_to_check():
    names = {p.name for p in FILES}
    assert {"ssd_scan.py", "ssm.py", "engine.py", "graphs.py",
            "chip_smoke.py"} <= names
    port = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in FILES
            if p.name != "chip_smoke.py"}
    assert {"core/eventloop.py", "core/hardware.py", "core/latency_model.py",
            "core/efficacy.py", "core/knee.py", "core/profiles.py",
            "core/simulator.py", "core/scheduler/__init__.py",
            "core/scheduler/base.py", "core/scheduler/baselines.py",
            "core/scheduler/dstack.py", "core/scheduler/ideal.py",
            "serving/pool.py", "serving/controller.py",
            "serving/prefix_cache.py", "launch/serve.py",
            "core/cluster.py", "models/encdec.py",
            "serving/modality.py", "models/moe.py"} <= port


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [(line, name) for line, name in _imported_modules(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_torch_compile(path):
    """The port's kernels are hand-written; nothing goes through
    ``torch.compile``."""
    assert "torch.compile" not in path.read_text()
