"""What the harness and the reference load: no JAX and not the JAX package
(top-level names compared whole), and the reference nothing of the
program."""

import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]

HARNESS = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import (control, drive_serve, drive_train, faults, harness,
                       program, run, trace, traffic, weights, work)
from benchmark.reference import check, model
m = harness.load_manifest(run.ROOT)
for x in m["per_layer"]:
    harness.reader(x["name"])
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark import weights
from benchmark.reference import check
from benchmark.tests import tiny
cfg = tiny.config()
tree = weights.make_tree(cfg, 3, "cpu")
check.serve_gaps(tree, cfg, [{{"ids": [1, 40, 41], "media": None,
                               "served": [50, 51]}}], "cpu", 4)
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def _modules(src: str) -> set:
    out = subprocess.run([sys.executable, "-c", src.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env={"PATH": "/usr/bin:/bin",
                                        "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    tops = _modules(HARNESS)
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_neither_jax_nor_the_program():
    tops = _modules(REFERENCE)
    assert not tops & set(harness.FORBIDDEN)
    assert "macaw_llm_tpu_torch" not in tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "macaw_llm_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]
