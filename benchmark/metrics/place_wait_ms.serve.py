"""Engine: the mean ``request.place_wait`` (from the admission's hand-off
to the decode loop placing the request and streaming its first token)
over the waits that ended in the traced window."""

from benchmark import spans

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "ttft_p95_ms"


def read(w):
    if w.kind != "serve":
        return None
    return spans.mean_ms(spans.ending_in_trace(w, "request.place_wait"))
