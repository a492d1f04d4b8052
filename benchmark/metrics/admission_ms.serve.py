"""Engine: the mean wall of ``admit`` (the admission thread's service of
one request: encode, featurize, towers, alignment, prefill and the
hand-off to the decode loop) over the admissions that ended in the
traced window."""

from benchmark import spans

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "ttft_p95_ms"


def read(w):
    if w.kind != "serve":
        return None
    return spans.mean_ms(spans.ending_in_trace(w, "admit"))
