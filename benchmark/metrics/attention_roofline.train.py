"""Kernels: the attention kernels' (B2 forward and its combine, the delta
kernel, B3 dq and B4 dk/dv: csrc/flash_attention*.cu) least time over
their device time over the traced steps. A step's calls: the LLM's
forward twice a layer (the pass and the remat recompute) and backward once
a layer, causal over the fused rows with the padding bias; Whisper's six
layers forward."""

from benchmark import work

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(w):
    if w.kind != "train" or w.trace is None:
        return None
    busy = w.trace.busy_s(r"flash_fwd_|flash_bwd_")
    if busy <= 0:
        return None
    s, spec = w.sizes, w.spec
    b = spec["rows"]
    t = spec["text_tokens"] + s.prefix_len
    n, d = s.heads, s.head_dim
    a = s.a_frames // 2
    per_step = (2 * s.layers * work.flash_fwd_bound_s(b, t, t, n, d, True,
                                                      bias=True)
                + s.layers * work.flash_bwd_bound_s(b, t, t, n, d, True,
                                                    bias=True)
                + s.a_layers * work.flash_fwd_bound_s(
                    b, a, a, s.a_heads, s.a_dim // s.a_heads, False))
    return 100.0 * w.trace_steps * per_step / busy
