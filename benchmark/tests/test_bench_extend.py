"""A configuration, traffic mixes, a driver, cells and a per-layer metric
added as new files and manifest entries only are found by name, in a copy
of the checkout and a process of its own, as a run finds them."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

READER = '''
LAYER = "engine"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "ttft_p95_ms"


def read(w):
    return None if w.kind != "serve" else float(len(w.records))
'''

# a driver of a new kind of traffic, as a cell on four chips would bring
DRIVER = '''
class Window:
    kind, records, trace = "serve", [1, 2, 3], None


def run(cfg, spec, w, seed, seconds, trace, device, t_start, limits,
        control=False):
    return {"attempted": 3, "failed": 0, "window": Window(), "peak": 7,
            "count": w["chips"], "info": {"vocab": cfg["vocab_size"]},
            "e2e": {"setup_s": 1.0, "ttft_p95_ms": 2.0, "itl_p95_ms": 3.0},
            "checks": {"widest_gap": {"value": 0.5,
                                      "limit": limits["widest_gap"]}}}
'''

CHECK = '''
import json, sys
import numpy as np
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
from benchmark import harness, run, traffic
m = harness.load_manifest(root)
out = {"faults": harness.check_manifest(m)}
w = harness.cell(m, "other-echo")
cfg = harness.config_of(m, root, w)
res = run.run_cell(root, m, w, 1, 1.0, True, None, 0.0)
out["echo"] = [harness.driver(harness.mix(w)["kind"]).__file__,
               cfg["name"], res["metrics"], res["device"], res["correct"]]
p = harness.cell(m, "other-poisson")
t = traffic.ServeTraffic(harness.mix(p), cfg, 3)
gaps = np.diff([t.arrival(i) for i in range(traffic.POOL + 1)])
out["poisson_cv"] = float(np.std(gaps) / np.mean(gaps))
text = harness.mix(harness.cell(m, "other-train-text"))
out["text_batch"] = sorted(traffic.train_batch(text, cfg, 1, 0, "cpu"))
print(json.dumps(out))
'''


def _add(bench: Path, rel: str, text: str) -> None:
    (bench / rel).write_text(text)


def test_added_files_are_found(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs/macaw-deepseek-llm-7b.json")
                     .read_text())
    cfg["name"] = "macaw-other-7b"
    _add(bench, "configs/macaw-other-7b.json", json.dumps(cfg))
    # Poisson arrivals, a new kind driven by a new driver, text-only rows
    mix = json.loads((bench / "traffic/serve_chat.json").read_text())
    mix["arrival"]["gap_cv"] = 1.0
    _add(bench, "traffic/serve_chat_poisson.json", json.dumps(mix))
    _add(bench, "traffic/echo.json", json.dumps(dict(mix, kind="echo")))
    _add(bench, "drive_echo.py", DRIVER)
    train = json.loads((bench / "traffic/train_qlora_1k.json").read_text())
    _add(bench, "traffic/train_qlora_text.json",
         json.dumps(dict(train, media="none", text_tokens=32)))
    _add(bench, "metrics/requests_seen.serve.py", READER)
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "macaw-other-7b", "source": "https://x",
                         "file": "benchmark/configs/macaw-other-7b.json",
                         "reduced": [], "why": "a test"})
    cells = {"other-poisson": ("serve_chat_poisson", 1),
             "other-echo": ("echo", 4),
             "other-train-text": ("train_qlora_text", 1)}
    for name, (mix_name, chips) in cells.items():
        m["workloads"].append({"name": name, "config": "macaw-other-7b",
                               "traffic": mix_name, "chips": chips,
                               "why": "a test"})
        limit = {"loss_gap": 1.0} if "train" in name else {"widest_gap": 2.0}
        _add(bench, f"limits/{name}.json", json.dumps(limit))
    for x in m["end_to_end"]:
        if x["name"] in ("ttft_p95_ms", "itl_p95_ms"):
            x["workloads"] += ["other-poisson", "other-echo"]
        if x["name"] == "train_tokens_per_s":
            x["workloads"].append("other-train-text")
    m["per_layer"].append({"name": "requests_seen.serve", "unit": "count",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine", "moves": "ttft_p95_ms",
                           "workloads": ["other-poisson", "other-echo"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    done = subprocess.run([sys.executable, "-c", CHECK, str(tmp_path)],
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["faults"] == []
    path, name, metrics, device, correct = out["echo"]
    assert Path(path) == bench / "drive_echo.py"
    assert name == "macaw-other-7b"
    assert metrics == {"requests_seen.serve": {"value": 3.0,
                                               "unit": "count"}}
    assert device == {"count": 4, "memory_peak_bytes": 7} and correct
    assert 0.85 < out["poisson_cv"] < 1.15
    assert out["text_batch"] == ["attention_mask", "input_ids", "labels"]
    # nothing that was there changed
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
