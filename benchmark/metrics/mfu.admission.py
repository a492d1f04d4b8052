"""Model step, admissions only: the least time for the model FLOPs of the
prefills whose first token came in the window (media towers, alignment,
splice and the LLM over the prompt) at the bf16 peak, over the window. The
whole admission's share of the chip, beside the flash kernels' roofline,
which moves the same metric."""

from benchmark import work

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "ttft_p95_ms"


def read(w):
    if w.kind != "serve":
        return None
    flops = w.model_flops(decode=False)
    if not flops:
        return None
    return 100.0 * flops / work.PEAK_BF16_FLOPS / (w.t1 - w.t0)
