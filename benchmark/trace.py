"""The device trace of a traced run: ``torch.profiler`` with CUDA activity
over the last ``TRACE_S`` seconds of the window (the profiler drops
records beyond what its buffers hold, and the trace is checked against
the kernels' launch counters), reduced to the device's operations as
intervals.

Time in which an operation ran on the device is the union of the
intervals (two streams' kernels that overlap count once; so does a
matvec's reduce kernel, which launches early as a programmatic dependent
and waits). A kernel's share of its roofline takes the union of its own
kernels' intervals.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict


# seconds traced at the end of a traced run's window
TRACE_S = 15
# launches that may race the profiler's start, per kernel
LAUNCH_RACE = 2
# the program's launch counters and the kernels they launch
KERNEL_NAMES = ((("matvec_int8", "matvec_int8_pipelined"), r"matvec_wgmma"),
                (("flash_attention",), r"flash_fwd_wgmma"),
                (("flash_attention_combine",), r"flash_fwd_combine"),
                (("flash_attention_dq",), r"flash_bwd_dq"),
                (("flash_attention_dkv",), r"flash_bwd_dkv"),
                (("flash_attention_delta",), r"flash_bwd_delta"),
                (("mh_attention",), r"mh_attention"))


def union_s(spans) -> float:
    """Seconds covered by (start, end) spans in nanoseconds."""
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)", "")
    while True:
        inner = re.sub(r"<[^<>]*>", "", name)
        if inner == name:
            break
        name = inner
    name = re.sub(r"\(.*", "", name).strip()
    name = re.sub(r"^void ", "", name)
    parts = [p for p in name.split("::") if p.strip()]
    return (parts[-1].strip() if parts else name)[:80] or "?"


class DeviceTrace:
    """Start and stop ``torch.profiler`` around a window; ``ops`` holds the
    device's operations [(start_ns, end_ns, name)] afterwards and
    ``window_s`` the window's length by the host's clock."""

    def __init__(self):
        self.ops, self.window_s, self._prof = [], None, None

    def start(self, launches=None) -> None:
        """``launches``: a function that reads the kernels' launch
        counters; read once the profiler records and again before it
        stops, every launch counted between has to be in the trace."""
        from torch.profiler import ProfilerActivity, profile
        self._counter = launches
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()
        self._launches = launches() if launches else None

    def stop(self) -> None:
        import torch
        end = self._counter() if self._counter else None
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self.ops = _device_ops(self._prof)
        self._prof = None
        if end is not None:
            self._complete({k: end[k] - self._launches[k] for k in end})

    def _complete(self, launched: dict) -> None:
        """The profiler drops records when its buffers fill; a trace that
        holds fewer of a kernel's runs than were launched is refused. A
        wrapper counts its launch after making it, so a launch made just
        before the profiler starts can be counted just after the first
        reading: each kernel may miss one run a launching thread (two: the
        engine's admission and decode threads)."""
        for counters, pattern in KERNEL_NAMES:
            n = sum(launched.get(c, 0) for c in counters)
            rx = re.compile(pattern)
            seen = sum(1 for _, _, name in self.ops if rx.search(name))
            if seen < n - LAUNCH_RACE:
                raise RuntimeError(f"the trace holds {seen} runs of "
                                   f"{pattern} for {n} launches: the "
                                   "profiler dropped records")

    def busy_s(self, pattern: str = None) -> float:
        """Seconds in which an operation ran, or one whose name matches
        ``pattern`` (a regular expression)."""
        rx = re.compile(pattern) if pattern else None
        return union_s((s, e) for s, e, n in self.ops
                       if rx is None or rx.search(n))

    def top_ops(self, k: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time
        (summed over their calls)."""
        total = defaultdict(int)
        for s, e, n in self.ops:
            total[short_name(n)] += e - s
        return [[n, t / 1e9] for n, t in sorted(total.items(),
                                                key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[[label, seconds]]: the device's idle time between operations,
        summed by the operation that ended each gap (what the host was
        about to launch), largest first."""
        total = defaultdict(int)
        end = None
        for s, e, n in sorted(self.ops):
            if end is not None and s > end:
                total["before " + short_name(n)] += s - end
            end = e if end is None else max(end, e)
        return [[n, t / 1e9] for n, t in sorted(total.items(),
                                                key=lambda x: -x[1])[:k]]


def _device_ops(prof) -> list:
    """(start_ns, end_ns, name) of every operation the profiler saw on a
    CUDA device: kernels, copies and sets; user annotations are not
    operations."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        annotation = getattr(ev, "is_user_annotation", None)
        if str(ev.device_type()).split(".")[-1] != "CUDA" or \
                (annotation is not None and annotation()):
            continue
        out.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                    ev.name()))
    return out
