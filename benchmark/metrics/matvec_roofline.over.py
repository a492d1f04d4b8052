"""Kernels, above capacity: the int8 matvecs' (B5 and B6, csrc/matvec.cu)
least time over their device time in the traced part of the window: each
decode step's projections at the engine's row count and each admission's
one-row head, by the engine's counters over the trace, against the union
of the matvec kernels' intervals."""

from benchmark import work

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "served_tokens_per_s"


def read(w):
    if w.kind != "serve" or w.trace is None:
        return None
    busy = w.trace.busy_s(r"matvec_")
    if busy <= 0:
        return None
    steps = w.trace_stats1["steps"] - w.trace_stats0["steps"]
    admitted = w.trace_stats1["admitted"] - w.trace_stats0["admitted"]
    bound = steps * work.decode_step_matvec_bound_s(w.sizes, w.slots) + \
        admitted * work.head_matvec_bound_s(w.sizes)
    return 100.0 * bound / busy
