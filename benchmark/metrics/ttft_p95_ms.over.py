"""Engine, above capacity: the 95th percentile of the time to first token
over the requests whose first token came in the window. The queue grows
all through the window, so this tail is the queue's length, not a bound
end-to-end metric."""

LAYER = "engine"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "served_tokens_per_s"


def read(w):
    if w.kind != "serve":
        return None
    return w.e2e["ttft_p95_ms"]
