"""One traced run of a benchmark cell (the window ``benchmark/run.py``
makes with ``--trace 1``), then the program's spans of that window laid
over its device trace: the device's idle time split by the decode
thread's state or by train step and between steps, each state's share of
the window, spans a decode step, the requests' queue wait, admission
phases (host and device ms) and wait for a slot, the train step's phases,
the ``setup.*`` spans before the window, the recorder's counters. One
JSON line; needs a CUDA device.

    python3 tools/span_breakdown.py <cell> <seed> [--seconds 50]
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness, spans  # noqa: E402
from benchmark import run as bench_run  # noqa: E402


def summary(xs):
    xs = sorted(xs)
    if not xs:
        return None
    return {"n": len(xs), "mean": statistics.fmean(xs),
            "p50": xs[len(xs) // 2],
            "p95": xs[min(len(xs) - 1, int(0.95 * (len(xs) - 1) + 0.5))]}


def _walls(named, by, dev):
    for s in named:
        by[s.name].append((s.end_ns - s.start_ns) / 1e6)
        if s.device_ms is not None:
            dev[s.name].append(s.device_ms)


def breakdown(win) -> dict:
    from macaw_llm_tpu_torch.utils.profiling import SPANS
    res = {"counters": SPANS.snapshot()[2]}
    every = spans.recorded(win, 0)
    lo, hi = spans.trace_window(win)
    inside = spans.in_trace(win)
    res["device_idle"] = 100 * (1 - win.trace.busy_s() / win.trace.window_s)
    # where the device's first and last records lie against the window's
    # host stamps (ms): a clock offset shows as a negative reading
    res["first_op_after_open_ms"] = \
        (min(s for s, _, _ in win.trace.ops) - lo) / 1e6
    res["last_op_before_close_ms"] = \
        (hi - max(e for _, e, _ in win.trace.ops)) / 1e6
    by, dev = defaultdict(list), defaultdict(list)
    if win.kind == "serve":
        states = spans.DECODE_STATES
        res["idle_split"] = spans.idle_split(win, states)
        share = defaultdict(int)
        for s in inside:
            if s.name in states:
                share[s.name] += min(s.end_ns, hi) - max(s.start_ns, lo)
        res["state_share"] = {k: 100 * v / (hi - lo)
                              for k, v in share.items()}
        steps = sum(s.name == "decode.launch" for s in inside)
        res["spans_per_step"] = sum(
            s.name in states or s.name == "request.place_wait"
            for s in inside) / max(steps, 1)
        ids = {s.request for s in spans.ending_in_trace(win, "admit")}
        _walls([s for s in every if s.request in ids], by, dev)
    else:
        res["idle_split"] = spans.idle_split(win, ("train.step",))
        _walls([s for s in inside if s.name.startswith("train.")], by, dev)
    res["host_ms"] = {k: summary(v) for k, v in by.items()}
    res["device_ms"] = {k: summary(v) for k, v in dev.items()}
    setup = defaultdict(lambda: {"n": 0, "host_s": 0.0, "device_s": 0.0})
    opened = spans.epoch_ns(win.t0)
    for s in every:
        if s.name.startswith("setup.") and s.start_ns < opened:
            e = setup[s.name]
            e["n"] += 1
            e["host_s"] += (s.end_ns - s.start_ns) / 1e9
            e["device_s"] += (s.device_ms or 0) / 1e3
    res["setup"] = dict(setup)
    res["spans_held"] = len(every)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cell")
    ap.add_argument("seed", type=int)
    ap.add_argument("--seconds", type=float, default=50.0)
    args = ap.parse_args()
    bench_run._fixed_caches(ROOT)
    import torch
    m = harness.load_manifest(ROOT)
    w = harness.cell(m, args.cell)
    spec = harness.mix(w)
    out = harness.driver(spec["kind"]).run(
        harness.config_of(m, ROOT, w), spec, w, args.seed, args.seconds,
        True, torch.device("cuda", 0), T_START, harness.limits(w["name"]))
    win = out["window"]
    print(json.dumps({
        "cell": args.cell, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "correct": harness.verdict(out["checks"]), "e2e": out["e2e"],
        "metrics": {k: v["value"] for k, v in
                    harness.read_per_layer(m, w, win).items()},
        "breakdown": breakdown(win)}))


if __name__ == "__main__":
    main()
