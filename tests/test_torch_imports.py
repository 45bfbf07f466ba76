"""The port stands alone: no module of ``blaze_tpu_torch`` and no line of
``chip_smoke.py`` imports JAX or the JAX package, nor ``google.protobuf``
or ``zstandard``, which the machine with the card does not have (the
port speaks the protobuf wire format itself and has no zstd codec)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "blaze_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "blaze_tpu")
# modules absent from the card's machine (checked by full dotted name)
ABSENT_ON_THE_CARD = ("google.protobuf", "zstandard")


def _imported_modules(path: Path):
    """Every absolute module name a file imports (``from a import b``
    also yields ``a.b``, which may be a module)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) in ("__import__", "import_module"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def _imported_roots(path: Path):
    for name in _imported_modules(path):
        yield name.split(".")[0]


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert (REPO / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_protobuf_or_zstandard_import(path):
    bad = [m for m in _imported_modules(path)
           if any(m == a or m.startswith(a + ".") for a in ABSENT_ON_THE_CARD)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, blaze_tpu_torch, blaze_tpu_torch.tpch, blaze_tpu_torch.kernels.cuda_ops, "
        "blaze_tpu_torch.kernels.build, blaze_tpu_torch.serde, blaze_tpu_torch.runtime.scheduler; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'blaze_tpu') "
        "or m.startswith('google.protobuf') or m == 'zstandard']; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
