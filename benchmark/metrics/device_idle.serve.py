"""Device: the share of the traced window in which no operation ran on the
card (one less the union of the device intervals over the window)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "itl_p95_ms"


def read(w):
    if w.kind != "serve" or w.trace is None or not w.trace.ops:
        return None
    return 100.0 * (1.0 - w.trace.busy_s() / w.trace.window_s)
