"""The port stands alone: no module of ``macaw_llm_tpu_torch/`` and neither
``chip_smoke.py`` nor ``decode_ab.py`` imports jax or the reference
package ``macaw_llm_tpu``, and importing the port compiles nothing."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "macaw_llm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "decode_ab.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == root or name.startswith(root + ".")
               for root in ("jax", "jaxlib", "macaw_llm_tpu"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded_and_builds_nothing():
    code = ("import sys, macaw_llm_tpu_torch.prefill, "
            "macaw_llm_tpu_torch.generate\n"
            "from macaw_llm_tpu_torch.ops.kernels import _build\n"
            "assert _build._lib is None\n"
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('macaw_llm_tpu.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
