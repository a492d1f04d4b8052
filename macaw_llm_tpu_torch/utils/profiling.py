"""Tracing, timing and debug hooks (counterpart of
``macaw_llm_tpu/utils/profiling.py``) on ``torch.profiler``:

* ``trace(log_dir)``: a Chrome trace of the enclosed block (host and, on a
  GPU, device activity), written to ``log_dir``;
* ``step_timer(name, sink)``: the block's wall time, read after the device
  has finished its work;
* ``annotate(name)``: a named range in the trace (``record_function``);
* ``enable_nan_debugging()``: autograd's anomaly mode, which raises at the
  backward op that produced a NaN;
* ``SPANS``: the program's span and counter recorder, always on. A span is
  an interval of host time stamped with ``time.time_ns()``, the clock of
  ``torch.profiler``'s records, so spans lie over a device trace as they
  are: the serving engine, the train step and set-up record theirs here,
  ``trace`` writes those of its block into its Chrome trace, and the
  benchmark reads them (``benchmark/spans.py``).

The reference package's ``start_profiler_server`` (a live endpoint that
TensorBoard connects to) has no PyTorch counterpart and raises.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Iterator, NamedTuple, Optional

import torch

logger = logging.getLogger("macaw.profiling")


def start_profiler_server(port: int = 9999) -> None:
    raise NotImplementedError(
        "torch.profiler has no live profiling server; capture a trace with "
        "profiling.trace(log_dir) instead")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block and write its Chrome trace into
    ``log_dir`` (open it in chrome://tracing or Perfetto); yields the
    profiler, whose ``key_averages()`` tables the same events."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        try:
            yield prof
        finally:
            _sync()
            t1 = time.time_ns()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, SPANS.snapshot()[0], t0, t1)
    logger.info("trace written to %s", path)


def _add_spans(path: str, spans: list, t0: int, t1: int) -> None:
    """Write the spans that overlap [t0, t1] into the Chrome trace at
    ``path``, on its clock (its events' ``ts`` are microseconds after
    ``baseTimeNanoseconds``), each on its thread's row."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    tids = {t.ident: t.native_id for t in threading.enumerate()}
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "span", "name": s.name, "pid": pid,
         "tid": tids.get(s.thread, s.thread),
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "request": s.request,
                  "device_ms": s.device_ms}}
        for s in spans if s.end_ns >= t0 and s.start_ns <= t1)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def step_timer(name: str, sink: Optional[dict] = None) -> Iterator[None]:
    """Seconds the block took, the device's queued work included: into
    ``sink[name]``, or logged."""
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = dt
        else:
            logger.info("%s: %.3fs", name, dt)


def enable_nan_debugging() -> None:
    """Autograd anomaly detection: the backward raises at the op whose
    gradient is NaN, with the forward's stack that created it."""
    torch.autograd.set_detect_anomaly(True)


def annotate(name: str):
    """A named range in a trace: ``with annotate("prefill"): ...``."""
    return torch.profiler.record_function(name)


# ---------------------------------------------------------------- spans

class Span(NamedTuple):
    """A closed span as ``SpanRecorder.snapshot`` gives it: ``id`` (the
    order in which spans closed), ``name``, ``thread``
    (``threading.get_ident``), ``start_ns`` and ``end_ns``
    (``time.time_ns``), ``parent`` (the id of the span it ran inside, None
    at the top or while that one is open), ``request`` (the id of the
    request it served, or None) and ``device_ms`` (the device's time
    between its boundaries on its stream, where that was timed and
    read)."""
    id: int
    name: str
    thread: int
    start_ns: int
    end_ns: int
    parent: Optional[int]
    request: Optional[int]
    device_ms: Optional[float]


# the fields of a span's record in the ring (a list: the device's time is
# filled in after the span has closed)
_ID, _NAME, _THREAD, _START, _END, _PARENT, _REQUEST, _DEVICE_MS = range(8)
# spans a thread keeps waiting for their CUDA events, at the most
_PENDING = 256


class _Open:
    """A span while it is open: ``with recorder.span(...)``."""

    __slots__ = ("_rec", "_thread", "_record", "_device", "_events", "_end")

    def __init__(self, rec, thread, record, device):
        self._rec, self._thread, self._record = rec, thread, record
        self._device, self._events, self._end = device, None, None

    def end_at(self, end_ns: int) -> None:
        """Close at ``end_ns`` instead of the moment the block ends."""
        self._end = end_ns

    def __enter__(self):
        if self._device is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self._device))
        self._thread[0].append(self)
        record = self._record
        if record[_START] is None:
            record[_START] = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        record = self._record
        record[_END] = time.time_ns() if self._end is None else self._end
        self._thread[0].pop()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
            self._thread[1].append((record, self._events))
        rec = self._rec
        record[_ID] = next(rec._ids)
        rec._ring.append(record)
        return False


class SpanRecorder:
    """Spans and counters of the program, in memory.

    The ring keeps the last ``capacity`` spans to close; ``snapshot`` says
    how many older ones it dropped. A span records its name, its thread,
    start and end on ``time.time_ns()`` (the profiler's clock), the span
    open on its thread when it opened (its parent) and a request id,
    inherited from the parent unless given. ``span(..., device=)`` with a
    CUDA device also records CUDA events on the thread's current stream at
    both boundaries; ``settle`` reads them once they have completed, so
    the recorder never synchronizes: call it after a synchronization the
    caller makes anyway. Nothing here opens a profiler range."""

    def __init__(self, capacity: int = 1 << 18):
        self._ring = deque(maxlen=capacity)
        self._ids = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._counters = {}

    def _thread(self) -> tuple:
        """This thread's open spans and the spans whose CUDA events it has
        not read yet."""
        try:
            return self._local.state
        except AttributeError:
            self._local.state = ([], deque(maxlen=_PENDING))
            return self._local.state

    def lap(self, name: str, start_ns: int) -> int:
        """Record a span of this thread from ``start_ns`` to now and return
        now: a loop whose phases tile it passes each phase's end on as the
        next one's start."""
        end = time.time_ns()
        self._ring.append([next(self._ids), name, threading.get_ident(),
                           start_ns, end, None, None, None])
        return end

    def add(self, name: str, start_ns: int, end_ns: int,
            request: Optional[int] = None) -> None:
        """Record a span whose stamps the caller took (a wait that began
        on another thread)."""
        self._ring.append([next(self._ids), name, threading.get_ident(),
                           start_ns, end_ns, None, request, None])

    def span(self, name: str, request: Optional[int] = None, device=None,
             start_ns: Optional[int] = None) -> _Open:
        """A span over a ``with`` block, inside this thread's innermost
        open span. ``device``: a CUDA ``torch.device`` times the device's
        work on the current stream too; ``start_ns`` opens it at that
        stamp."""
        thread = self._thread()
        parent = thread[0][-1]._record if thread[0] else None
        if request is None and parent is not None:
            request = parent[_REQUEST]
        if device is not None and device.type != "cuda":
            device = None
        return _Open(self, thread, [None, name, threading.get_ident(),
                                    start_ns, None, parent, request, None],
                     device)

    def child(self, suffix: str):
        """A span named ``<parent>.<suffix>`` inside this thread's
        innermost open span, timing the device if that one does; no span
        outside one (a model function that an admission and a train step
        both call)."""
        stack = self._thread()[0]
        if not stack:
            return contextlib.nullcontext()
        top = stack[-1]
        return self.span(f"{top._record[_NAME]}.{suffix}",
                         device=top._device)

    def settle(self) -> None:
        """Read the device time of this thread's spans whose CUDA events
        have completed; the others wait for a later call (at most
        ``_PENDING`` a thread, the oldest dropped unread)."""
        pending = self._thread()[1]
        while pending and pending[0][1][1].query():
            record, (start, end) = pending.popleft()
            record[_DEVICE_MS] = start.elapsed_time(end)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def snapshot(self):
        """(the spans in the ring as ``Span``s, in the order they closed;
        how many closed spans the ring dropped; the counters)."""
        records = list(self._ring)
        with self._lock:
            counters = dict(self._counters)
        spans = [Span(r[_ID], r[_NAME], r[_THREAD], r[_START], r[_END],
                      None if r[_PARENT] is None else r[_PARENT][_ID],
                      r[_REQUEST], r[_DEVICE_MS]) for r in records]
        dropped = max(s.id for s in spans) + 1 - len(spans) if spans else 0
        return spans, dropped, counters


SPANS = SpanRecorder()
