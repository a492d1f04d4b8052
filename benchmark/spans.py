"""The program's spans laid over a window: the recorder of
``macaw_llm_tpu_torch.utils.profiling`` (``SPANS``), reached here alone,
with its imports inside functions as ``program.py`` does. A span is an
interval of host time on ``time.time_ns()``, the clock of the device
trace's records (``trace.py``); the window's own stamps are on
``time.perf_counter()`` and are moved onto that clock here. A program
without the recorder gives None, and so does every reader built on it.

Idle, as ``device_idle.*`` counts it, is a nanosecond of the traced window
in which no device operation ran. Each idle nanosecond goes to the one
span of a set (the decode thread's states, which tile its loop, or the
train steps) open at that moment, or to ``OTHER``.
"""

from __future__ import annotations

import time

from .trace import union_s

OTHER = "other"
# the decode thread's states: together they tile each loop iteration
DECODE_STATES = ("decode.place", "decode.launch", "decode.readback",
                 "decode.sleep")


def _recorder():
    try:
        from macaw_llm_tpu_torch.utils import profiling
        return profiling.SPANS
    except (ImportError, AttributeError):
        return None


def epoch_ns(perf_s: float) -> int:
    """A ``time.perf_counter()`` reading on ``time.time_ns()``'s clock."""
    return round(perf_s * 1e9) + time.time_ns() - time.perf_counter_ns()


def recorded(w, since_ns: int):
    """Every span the program held when the window's readers first asked
    (one snapshot a window), or None without a recorder. Refuses
    (RuntimeError) if the ring dropped spans that may have ended at or
    after ``since_ns``: the ring drops the spans that closed first."""
    if "program_spans" not in w.__dict__:
        rec = _recorder()
        w.program_spans = None if rec is None else rec.snapshot()[:2]
    if w.program_spans is None:
        return None
    spans, dropped = w.program_spans
    if dropped and spans and min(spans, key=lambda s: s.id).end_ns >= \
            since_ns:
        raise RuntimeError(f"the program dropped {dropped} spans, some of "
                           "them inside the window")
    return spans


def trace_window(w):
    """(first, last) nanosecond of the traced window on the spans' clock,
    or None for a run without a trace."""
    if w.trace is None or not w.trace.ops:
        return None
    lo = epoch_ns(w.trace._t0)
    return lo, lo + round(w.trace.window_s * 1e9)


def in_trace(w):
    """The spans that overlap the traced window, or None."""
    bounds = trace_window(w)
    if bounds is None:
        return None
    lo, hi = bounds
    spans = recorded(w, lo)
    if spans is None:
        return None
    return [s for s in spans if s.end_ns > lo and s.start_ns < hi]


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_intervals(ops, lo: int, hi: int) -> list:
    """[start, end) of each stretch of [lo, hi) in which no device
    operation ran."""
    out, t = [], lo
    for s, e in _merged((max(s, lo), min(e, hi)) for s, e, _ in ops
                        if e > lo and s < hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def attribute(idle: list, states: list) -> dict:
    """{state name or OTHER: idle nanoseconds}. ``states``: (start, end,
    name) spans of one thread that follow one another (the decode states
    tile their loop, train steps do not nest); where two overlap anyway,
    the later one holds the overlap."""
    cut = []
    for s, e, name in sorted(states):
        if cut and cut[-1][1] > s:
            ps, _, pname = cut.pop()
            if s > ps:
                cut.append((ps, s, pname))
        if e > s:
            cut.append((s, e, name))
    out, k = {OTHER: 0}, 0
    for a, b in idle:
        while k < len(cut) and cut[k][1] <= a:
            k += 1
        covered, j = 0, k
        while j < len(cut) and cut[j][0] < b:
            s, e, name = cut[j]
            n = min(b, e) - max(a, s)
            out[name] = out.get(name, 0) + n
            covered += n
            j += 1
        out[OTHER] += (b - a) - covered
    return out


def idle_split(w, names):
    """{name or OTHER: % of the traced window idle inside it} over the
    spans named in ``names``, or None where the window has no trace or the
    program none of those spans."""
    spans = in_trace(w)
    if spans is None:
        return None
    states = [(s.start_ns, s.end_ns, s.name) for s in spans
              if s.name in names]
    if not states:
        return None
    lo, hi = trace_window(w)
    split = attribute(idle_intervals(w.trace.ops, lo, hi), states)
    return {k: 100.0 * v / (hi - lo) for k, v in split.items()}


def ending_in_trace(w, name: str) -> list:
    """The spans named ``name`` that end in the traced window ([] where
    there are none, None without a trace or a recorder)."""
    bounds = trace_window(w)
    if bounds is None:
        return None
    lo, hi = bounds
    spans = recorded(w, lo)
    if spans is None:
        return None
    return [s for s in spans if s.name == name and lo <= s.end_ns <= hi]


def queue_waits(w) -> list:
    """The queue waits (ns) of the requests whose admission ended in the
    traced window, or None."""
    admits = ending_in_trace(w, "admit")
    if not admits:
        return None
    ids = {s.request for s in admits}
    return [s.end_ns - s.start_ns for s in recorded(
        w, min(s.start_ns for s in admits)) if s.name == "request.queue_wait"
        and s.request in ids] or None


def mean_ms(spans) -> float:
    """The mean wall of ``spans`` in milliseconds, or None for none."""
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6


def setup_seconds(w):
    """Seconds inside the program's ``setup.*`` spans that began before
    the window opened, nested ones counted once; a span whose device time
    was read counts to the later of its end and its start plus that
    time. None without a recorder or such spans."""
    spans = recorded(w, 0)
    if spans is None:
        return None
    t0 = epoch_ns(w.t0)
    out = [(s.start_ns, s.start_ns + max(s.end_ns - s.start_ns,
                                         int((s.device_ms or 0) * 1e6)))
           for s in spans if s.name.startswith("setup.") and s.start_ns < t0]
    return union_s(out) if out else None
