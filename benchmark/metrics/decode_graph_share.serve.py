"""Engine: the share of the traced window's decode steps that the engine
replayed from its captured CUDA graph (``ContinuousEngine.stats``
``graph_replays`` over ``steps``, both read at the ends of the trace). A
program whose engine keeps no such counter reads nothing."""

LAYER = "engine"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "itl_p95_ms"


def read(w):
    if w.kind != "serve" or w.trace is None:
        return None
    s0, s1 = w.trace_stats0, w.trace_stats1
    if "graph_replays" not in s0 or "graph_replays" not in s1:
        return None
    steps = s1["steps"] - s0["steps"]
    if steps <= 0:
        return None
    return 100.0 * (s1["graph_replays"] - s0["graph_replays"]) / steps
