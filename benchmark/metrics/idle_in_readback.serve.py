"""Engine: the share of the traced window in which the device was idle
while the decode thread was inside ``decode.readback`` (the wait for a
step's tokens, their bookkeeping, streaming and finished requests)."""

from benchmark import spans

LAYER = "engine"
UNIT = "%"
SOURCE = "program_span"
MOVES = "itl_p95_ms"


def read(w):
    if w.kind != "serve":
        return None
    split = spans.idle_split(w, spans.DECODE_STATES)
    return None if split is None else split.get("decode.readback", 0.0)
