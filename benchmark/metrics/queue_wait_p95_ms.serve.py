"""Engine: the 95th percentile of ``request.queue_wait`` (from the
request's creation to the admission thread taking it) over the
requests whose admission ended in the traced window."""

from benchmark import spans
from benchmark.drive_serve import percentile

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "ttft_p95_ms"


def read(w):
    if w.kind != "serve":
        return None
    waits = spans.queue_waits(w)
    return None if waits is None else percentile(waits, 0.95) / 1e6
