"""Model step, above capacity: the least time the chip needs for the model
FLOPs of the window (the prefills whose first token came in it and every
token decoded in it) at the bf16 peak, over the window. The whole step's
share of the chip, beside the matvec roofline, which moves the same
metric."""

from benchmark import work

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "served_tokens_per_s"


def read(w):
    if w.kind != "serve":
        return None
    flops = w.model_flops()
    if not flops:
        return None
    return 100.0 * flops / work.PEAK_BF16_FLOPS / (w.t1 - w.t0)
