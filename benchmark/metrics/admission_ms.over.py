"""Engine, above capacity: the mean wall of ``admit``, the one admission
thread's service time of a request, over the admissions that ended in
the traced window."""

from benchmark import spans

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "served_tokens_per_s"


def read(w):
    if w.kind != "serve":
        return None
    return spans.mean_ms(spans.ending_in_trace(w, "admit"))
