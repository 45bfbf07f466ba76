"""The port stands alone: no module of ``blaze_tpu_torch`` and no line of
``chip_smoke.py`` imports JAX or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "blaze_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "blaze_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert (REPO / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, blaze_tpu_torch, blaze_tpu_torch.tpch, blaze_tpu_torch.kernels.cuda_ops, "
        "blaze_tpu_torch.kernels.build; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'blaze_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
