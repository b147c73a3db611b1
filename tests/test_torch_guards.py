"""Port guards (h): no module of ``mustafar_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, anything of ``mustafar_tpu`` or
``transformers``; the machine with the card has none of them, and one
stray import would stop the port there.  Checked twice: an AST scan of
every import statement, and importing every module in a fresh interpreter
where none of them can be imported.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "mustafar_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "mustafar_tpu", "transformers")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_port_imports_with_jax_unavailable():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "mustafar_tpu_torch").rglob("*.py"))
    code = (
        "import sys, importlib, runpy\n"
        "for name in ('jax', 'jaxlib', 'mustafar_tpu', 'transformers'):\n"
        "    sys.modules[name] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_distributed_entry_point_runs_with_jax_unavailable(tmp_path):
    """The spawned entry point (``python -m mustafar_tpu_torch.parallel.
    distributed``): one process of the masked step program runs to its result
    in an interpreter where ``jax`` and ``mustafar_tpu`` cannot be imported."""
    out = tmp_path / "step.json"
    code = (
        "import sys, runpy\n"
        "for name in ('jax', 'jaxlib', 'mustafar_tpu', 'transformers'):\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = ['distributed', '--device', 'cpu', '--out', {str(out)!r}]\n"
        "runpy.run_module('mustafar_tpu_torch.parallel.distributed', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert len(json.loads(out.read_text())["tokens"]) == 8
