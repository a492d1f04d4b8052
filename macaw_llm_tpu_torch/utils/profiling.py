"""Tracing, timing and debug hooks (counterpart of
``macaw_llm_tpu/utils/profiling.py``) on ``torch.profiler``:

* ``trace(log_dir)``: a Chrome trace of the enclosed block (host and, on a
  GPU, device activity), written to ``log_dir``;
* ``step_timer(name, sink)``: the block's wall time, read after the device
  has finished its work;
* ``annotate(name)``: a named range in the trace (``record_function``);
* ``enable_nan_debugging()``: autograd's anomaly mode, which raises at the
  backward op that produced a NaN.

The reference package's ``start_profiler_server`` (a live endpoint that
TensorBoard connects to) has no PyTorch counterpart and raises.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

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
        try:
            yield prof
        finally:
            _sync()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("trace written to %s", path)


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
