"""The port stands alone: no module of ``macaw_llm_tpu_torch/`` and none of
``chip_smoke.py``, ``decode_ab.py``, ``tools/decode_probes.py``,
``tools/flash_bwd_probe.py`` and ``tools/flash_fwd_probe.py`` imports jax or the reference package
``macaw_llm_tpu``, and importing every module of the port (the server, the
data helpers and the HF import/export included) loads no jax and no
``transformers`` and compiles nothing."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "macaw_llm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "decode_ab.py",
    ROOT / "tools" / "decode_probes.py",
    ROOT / "tools" / "flash_bwd_probe.py",
    ROOT / "tools" / "flash_fwd_probe.py"]


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
    code = ("import importlib, pkgutil, sys, macaw_llm_tpu_torch\n"
            "for m in pkgutil.walk_packages(macaw_llm_tpu_torch.__path__, "
            "'macaw_llm_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'macaw_llm_tpu_torch.serve' in sys.modules\n"
            "assert 'macaw_llm_tpu_torch.data.loader' in sys.modules\n"
            "from macaw_llm_tpu_torch.ops.kernels import _build\n"
            "assert _build._lib is None\n"
            "print(sorted(m for m in sys.modules if m in ('jax', "
            "'transformers') or m.startswith('macaw_llm_tpu.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout
