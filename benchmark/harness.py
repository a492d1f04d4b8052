"""The harness's data-driven core: the manifest (``BENCHMARK.json``), the
files a cell is made of, found by name, and the result line.

A cell (a ``workloads`` entry) names a configuration (``configs/<file>``,
through the manifest's ``configs``) and a traffic mix
(``traffic/<traffic>.json``); its limits are ``limits/<cell>.json``. The
mix's ``kind`` names the module that drives its window,
``drive_<kind>.py``, whose ``run`` takes the cell and returns what the
result line needs (a cell on four chips brings a driver of its own). A
per-layer metric is ``metrics/<name>.py``, a reader that declares LAYER,
UNIT, SOURCE and MOVES and whose ``read(window)`` returns a number or None
when its cell has nothing for it to read. Adding a configuration, a mix,
a cell, a driver or a metric adds files and manifest entries and edits
none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "macaw_llm_tpu")


def load_manifest(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def check_manifest(m: dict) -> list:
    """The manifest's names and units against the allowed characters, and
    each cell's configuration and traffic mix against the files. Returns
    the faults found."""
    faults = []
    names = [c["name"] for c in m["configs"]] + \
        [w["name"] for w in m["workloads"]] + \
        [x["name"] for x in m["end_to_end"] + m["per_layer"]] + \
        [w["traffic"] for w in m["workloads"]] + \
        [k for c in m["configs"] for k in c["reduced"]]
    faults += [f"name {n!r}" for n in names if not NAME.match(n)]
    faults += [f"unit {x['unit']!r}" for x in m["end_to_end"] + m["per_layer"]
               if not UNIT.match(x["unit"])]
    configs = {c["name"] for c in m["configs"]}
    for w in m["workloads"]:
        if w["config"] not in configs:
            faults.append(f"cell {w['name']}: no configuration {w['config']}")
        if not traffic_path(w["traffic"]).exists():
            faults.append(f"cell {w['name']}: no traffic {w['traffic']}")
        elif not driver_path(mix(w)["kind"]).exists():
            faults.append(f"cell {w['name']}: no driver for its traffic")
        if not limits_path(w["name"]).exists():
            faults.append(f"cell {w['name']}: no limits file")
    for x in m["per_layer"]:
        if not metric_path(x["name"]).exists():
            faults.append(f"metric {x['name']}: no reader")
    return faults


def cell(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_of(m: dict, root: Path, w: dict) -> dict:
    for c in m["configs"]:
        if c["name"] == w["config"]:
            return json.loads((Path(root) / c["file"]).read_text())
    raise SystemExit(f"no configuration {w['config']!r}")


def traffic_path(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def mix(w: dict) -> dict:
    """The cell's traffic mix."""
    from benchmark import traffic
    return traffic.load(traffic_path(w["traffic"]))


def driver_path(kind: str) -> Path:
    return HERE / f"drive_{kind}.py"


def driver(kind: str):
    """The module ``drive_<kind>.py`` of the harness."""
    if not NAME.match(kind) or not driver_path(kind).exists():
        raise SystemExit(f"no driver drive_{kind}.py")
    return importlib.import_module(f"benchmark.drive_{kind}")


def limits_path(name: str) -> Path:
    return HERE / "limits" / f"{name}.json"


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def limits(name: str) -> dict:
    return json.loads(limits_path(name).read_text())


def reader(name: str):
    """The module ``metrics/<name>.py`` (names may hold dots)."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end_for(m: dict, w: dict) -> list:
    """The end-to-end metrics a cell reports."""
    return [x for x in m["end_to_end"]
            if "workloads" not in x or w["name"] in x["workloads"]]


def per_layer_for(m: dict, w: dict) -> list:
    """The per-layer metrics a cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {x["name"] for x in end_to_end_for(m, w)}
    return [x for x in m["per_layer"]
            if (w["name"] in x["workloads"] if "workloads" in x
                else x["moves"] in e2e)]


def read_per_layer(m: dict, w: dict, window) -> dict:
    out = {}
    for x in per_layer_for(m, w):
        value = reader(x["name"]).read(window)
        if value is not None:
            out[x["name"]] = {"value": float(value), "unit": x["unit"]}
    return out


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (``macaw_llm_tpu_torch`` is not ``macaw_llm_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def verdict(checks: dict) -> bool:
    """``correct``: every number compared within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def check_lines(checks: dict) -> list:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in checks.items()]
