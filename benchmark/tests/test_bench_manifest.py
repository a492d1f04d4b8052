"""The manifest against the contract's shape and the files it names."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
M = harness.load_manifest(ROOT)
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_keys_and_limits():
    assert set(M) == TOP
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).exists()
        assert len(c["reduced"]) <= 16
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert ONE_LINE.match(w["why"])
    for x in M["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in M["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_files():
    assert harness.check_manifest(M) == []
    names = [x["name"] for x in M["end_to_end"] + M["per_layer"]] + \
        [w["name"] for w in M["workloads"]] + [c["name"] for c in M["configs"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for w in M["workloads"]:
        e2e = {x["name"] for x in harness.end_to_end_for(M, w)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = harness.per_layer_for(M, w)
        assert layers
        assert all(x["moves"] in e2e for x in layers)


@pytest.mark.parametrize("metric", [x["name"] for x in M["per_layer"]])
def test_reader_declares_what_the_manifest_says(metric):
    x = next(m for m in M["per_layer"] if m["name"] == metric)
    r = harness.reader(metric)
    assert (r.LAYER, r.UNIT, r.SOURCE, r.MOVES) == \
        (x["layer"], x["unit"], x["source"], x["moves"])


def test_a_roofline_has_mfu_beside_it():
    """Every end-to-end metric a kernel's roofline moves is also moved by
    a whole step's share of the peak, in the same cells."""
    for x in M["per_layer"]:
        if x["name"].split(".")[0].endswith("_roofline"):
            mfu = [m for m in M["per_layer"] if "mfu" in m["name"]
                   and m["moves"] == x["moves"]]
            assert mfu
            assert set(x["workloads"]) <= set().union(
                *(m["workloads"] for m in mfu))
