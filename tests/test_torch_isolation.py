"""The port stands alone: nothing in ``src/repro_torch`` or ``chip_smoke.py``
imports JAX or the JAX package, and every module imports with both made
unimportable (in a subprocess, so this test process keeps its JAX)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

import _torch_threads  # noqa: F401  (one CPU thread a test process)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


_PROBE = r"""
import importlib, importlib.abc, importlib.util, sys
from pathlib import Path

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
for m in list(sys.modules):
    if m.split(".")[0] in ("jax", "jaxlib", "repro"):
        del sys.modules[m]
root = Path(sys.argv[1])
sys.path.insert(0, str(root / "src"))
mods = sorted(
    ".".join(p.relative_to(root / "src").with_suffix("").parts)
    for p in (root / "src" / "repro_torch").rglob("*.py")
)
for m in mods:
    importlib.import_module(m.removesuffix(".__init__"))
spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in sys.modules)
print(len(mods), "modules")
"""


def test_every_module_imports_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "modules" in out.stdout
