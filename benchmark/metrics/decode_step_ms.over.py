"""Engine, above capacity: the window's wall time over the decode steps
the engine took in it (``ContinuousEngine.stats["steps"]``), with every
slot in use."""

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "served_tokens_per_s"


def read(w):
    if w.kind != "serve" or not w.steps:
        return None
    return (w.t1 - w.t0) / w.steps * 1e3
