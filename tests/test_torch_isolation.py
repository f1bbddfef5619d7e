"""The port stands alone: neither `ceph_tpu_torch/` nor `chip_smoke.py`
imports jax, anything of the JAX package, or its `benchmarks` scripts."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ceph_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu", "benchmarks")


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_files_found():
    assert len(PORT_FILES) >= 15
    for source in ("swar_gf.cu", "copy_floor.cu", "swar_baked.cu", "swar3_baked.cu"):
        assert (ROOT / "ceph_tpu_torch" / "csrc" / source).exists()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"
    assert "importlib.import_module(\"jax" not in path.read_text()


def test_plugin_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import ceph_tpu_torch.codec.plugins.tpu\n"
        "from ceph_tpu_torch.codec import registry\n"
        "ec = registry.instance().factory('tpu', {'k': '4', 'm': '2'}, device='cpu')\n"
        "ec.encode({0, 1, 2, 3, 4, 5}, b'x' * 1000)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
