"""Kernels: the flash forward's (B2 and its combine,
csrc/flash_attention.cu) least time over its device time in the traced
part of the window, for the media admissions' calls: Whisper's six layers
over 1500 frames and the video attention over 1176 patch tokens (1178
keys), batch 1. Admissions are counted by the media requests whose first
token came in the trace."""

from benchmark import work

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "ttft_p95_ms"


def read(w):
    if w.kind != "serve" or w.trace is None:
        return None
    busy = w.trace.busy_s(r"flash_fwd_")
    n = sum(1 for r in w.first_tokens(w.trace_t0, w.trace_t1)
            if r["media"] is not None)
    if busy <= 0 or not n:
        return None
    s = w.sizes
    t = s.a_frames // 2
    v = s.frames * s.patches
    heads = s.align_heads // 2
    per = s.a_layers * work.flash_fwd_bound_s(
        1, t, t, s.a_heads, s.a_dim // s.a_heads, False) + \
        work.flash_fwd_bound_s(1, v, v + 2, heads, s.proj // heads, False)
    return 100.0 * n * per / busy
