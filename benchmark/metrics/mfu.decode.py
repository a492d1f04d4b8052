"""Model step, decode: the least time the chip needs for the model FLOPs of
every token decoded in the window (the LLM's projections, attention over
each token's context and the head) at the bf16 peak (every matmul on the
serving path computes in bf16: int8 weights are widened), over the
window. The whole decode step's share of the chip, beside the matvec
roofline, which moves the same metric."""

from benchmark import work

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "itl_p95_ms"


def read(w):
    if w.kind != "serve":
        return None
    flops = w.model_flops(prefill=False)
    if not flops:
        return None
    return 100.0 * flops / work.PEAK_BF16_FLOPS / (w.t1 - w.t0)
