"""The port stands alone: no JAX, no kubetpu, no GPU probe.

An AST scan of every file of ``kubetpu_torch/`` and of ``chip_smoke.py``
finds no import of ``jax`` or ``kubetpu``; importing the whole package in a
fresh interpreter leaves both out of ``sys.modules``; the entry points
default to ``device="cuda"`` (checked on their signatures, so nothing here
reaches for a GPU).
"""

import ast
import inspect
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "kubetpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "kubetpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_kubetpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_import_leaves_jax_and_kubetpu_out():
    modules = sorted(
        "kubetpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import sys, importlib\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'kubetpu') "
        "or m.startswith(('jax.', 'kubetpu.'))]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_gpu_probe_in_the_package():
    """The caller's device decides: no module asks whether a GPU exists."""
    for path in sorted(PORT.rglob("*.py")):
        assert "is_available" not in path.read_text(), path


def test_entry_points_default_to_cuda():
    from kubetpu_torch.perf import run_workload
    from kubetpu_torch.perf.__main__ import build_parser
    from kubetpu_torch.sched import Scheduler

    assert inspect.signature(Scheduler.__init__).parameters["device"].default == "cuda"
    assert inspect.signature(run_workload).parameters["device"].default == "cuda"
    assert build_parser().parse_args([]).device == "cuda"
