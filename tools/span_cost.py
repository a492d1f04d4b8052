"""Host cost of the span recorder (``utils/profiling.SPANS``): nanoseconds
a span per way of recording one, the median of several rounds, and the
cost of the decode loop's spans a step (its three phases and, when it
places a request, the request's wait for a slot). One JSON line.

    python tools/span_cost.py [--device cuda]
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from macaw_llm_tpu_torch.utils.profiling import SpanRecorder  # noqa: E402

N = 20000


def per_span(fn, rounds: int = 7) -> float:
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        fn()
        times.append((time.perf_counter_ns() - t0) / N)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    dev = torch.device(ap.parse_args().device)
    rec = SpanRecorder(capacity=N)

    def laps():
        t = time.time_ns()
        for _ in range(N):
            t = rec.lap("decode.launch", t)

    def adds():
        for _ in range(N):
            rec.add("request.place_wait", 1, 2, 3)

    def opened(device=None):
        def run():
            for _ in range(N):
                with rec.span("admit", 1, device):
                    pass
        return run

    out = {"lap_ns": per_span(laps), "add_ns": per_span(adds),
           "span_ns": per_span(opened())}
    if dev.type == "cuda":
        out["span_cuda_events_ns"] = per_span(opened(dev), rounds=3)
        torch.cuda.synchronize()
        rec.settle()
    out["decode_step_ns"] = 3 * out["lap_ns"]
    out["decode_step_placing_ns"] = 3 * out["lap_ns"] + out["add_ns"]
    out["python"] = sys.version.split()[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
