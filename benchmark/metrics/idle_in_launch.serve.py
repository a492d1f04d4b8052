"""Engine: the share of the traced window in which the device was idle
while the decode thread was inside ``decode.launch`` (the control
upload, the step's enqueue, the start of its token copy): a decode step
bound by its launches."""

from benchmark import spans

LAYER = "engine"
UNIT = "%"
SOURCE = "program_span"
MOVES = "itl_p95_ms"


def read(w):
    if w.kind != "serve":
        return None
    split = spans.idle_split(w, spans.DECODE_STATES)
    return None if split is None else split.get("decode.launch", 0.0)
