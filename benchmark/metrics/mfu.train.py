"""Model step: the least time the chip needs for the model FLOPs of the
QLoRA steps finished in the window (frozen towers forward; fusion forward
and gradients; the LLM forward, its input gradients through the frozen
base, attention backward, the head, the LoRA factors; remat recompute not
counted) at the bf16 peak, over the window."""

from benchmark import work

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"


def read(w):
    if w.kind != "train" or not w.steps:
        return None
    return 100.0 * w.steps * w.step_flops() / work.PEAK_BF16_FLOPS \
        / (w.t1 - w.t0)
