"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The run draws its weights and traffic from
the seed on the card, warms up, measures for ``--seconds``, compares what
the timed path produced with the plain reference, and prints one JSON
object as the last line of its standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit
(also the last lines of standard error). It exits non-zero and prints no
result without enough CUDA devices, or if a JAX module or the JAX package
is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fixed_caches(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds; no library may load JAX."""
    cache = root / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def run_cell(root: Path, manifest: dict, w: dict, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> dict:
    """One run of cell ``w``; returns the result object (without the
    device's name, which the caller adds)."""
    from benchmark import harness
    cfg = harness.config_of(manifest, root, w)
    spec = harness.mix(w)
    out = harness.driver(spec["kind"]).run(
        cfg, spec, w, seed, seconds, trace, device, t_start,
        harness.limits(w["name"]))
    win = out["window"]
    if trace:
        metrics = harness.read_per_layer(manifest, w, win)
    else:
        metrics = {x["name"]: {"value": float(out["e2e"][x["name"]]),
                               "unit": x["unit"]}
                   for x in harness.end_to_end_for(manifest, w)}
    checks = out["checks"]
    result = {"correct": harness.verdict(checks),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": {"count": int(out.get("count", 1)),
                         "memory_peak_bytes": int(out["peak"])}}
    if trace and win.trace is not None:
        result["device"]["busy_s"] = win.trace.busy_s()
        result["device"]["window_s"] = win.trace.window_s
        result["breakdown"] = {"device_ops": win.trace.top_ops(),
                               "idle_gaps": win.trace.idle_gaps()}
    result["info"] = out["info"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches(ROOT)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    manifest = harness.load_manifest(ROOT)
    w = harness.cell(manifest, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"benchmark: the cell needs {w['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(ROOT, manifest, w, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        **result["device"]}
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
