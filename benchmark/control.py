"""Readings that set a cell's limits, on a CUDA device, in one process:

    python3 benchmark/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--fault <name>] [--control]
    python3 benchmark/control.py --workload <name> --seconds <s> \\
        --seeds <n> --sweep <rate> [<rate> ...]

For each seed, one run of the cell as ``run.py`` makes it (set-up, a
window of ``--seconds``, the comparison), printing a JSON line with the
numbers compared. ``--control`` also reads the control: for a serving
cell, the same positions read for the token that the reference with the
LLM's matmul weights in 4 bits puts first; for a training cell, the
reference trained on a 4-bit base in the program's place. ``--fault``
plants a fault of ``faults.py`` in the program. ``--sweep`` sends a
serving cell's mix open loop at each rate for ``--seconds`` on one engine
and reports whether it kept up (the capacity that the cell's fixed rate is
set from). The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--sweep", type=float, nargs="+", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run as bench_run
    bench_run._fixed_caches(ROOT)
    from benchmark import drive_serve, faults, harness
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    m = harness.load_manifest(ROOT)
    w = harness.cell(m, args.workload)
    cfg = harness.config_of(m, ROOT, w)
    spec = harness.mix(w)
    drive = harness.driver(spec["kind"])
    plant = {**faults.SERVE, **faults.TRAIN}[args.fault] if args.fault \
        else None
    if args.sweep:
        for line in drive_serve.sweep(cfg, spec, args.seeds[0],
                                      torch.device("cuda", 0), args.sweep,
                                      args.seconds):
            line.update(workload=w["name"],
                        card=torch.cuda.get_device_name(0))
            print(json.dumps(line), flush=True)
        return 0
    t_start = T_START
    for seed in args.seeds:
        with (plant() if plant else contextlib.nullcontext()):
            out = drive.run(cfg, spec, w, seed, args.seconds, False,
                            torch.device("cuda", 0), t_start,
                            harness.limits(w["name"]), control=args.control)
        line = {"workload": w["name"], "seed": seed, "fault": args.fault,
                "checks": {k: v["value"] for k, v in out["checks"].items()},
                "e2e": out["e2e"], "peak": out["peak"],
                "info": out["info"],
                "card": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
