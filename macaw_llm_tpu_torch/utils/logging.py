"""Structured metrics logging (SURVEY §5.5): per-step JSONL with loss, lr,
grad_norm, tokens/sec, examples/sec/chip — the reference only had HF
Trainer's --logging_steps console prints (train.sh:31)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger("macaw")


def setup_logging(level=logging.INFO):
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")


class MetricsLogger:
    """Per-step JSONL metrics with DEFERRED device readback.

    ``log`` buffers the step's (device-array) metrics and only converts
    them host-side every ``log_every`` steps: ``float(loss)`` forces a
    device sync, and paying it per step serializes dispatch against the
    chip — measured as a large part of the 1.9x real-loop-vs-benchmark
    gap (VERDICT r2 #7). Every step still gets its own JSONL row; rows
    are just written in batches.
    """

    def __init__(self, path: Optional[str] = None, log_every: int = 10):
        self.path = path
        self.log_every = max(1, log_every)
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        self._last_time = time.perf_counter()
        self._last_step = 0
        self._buf = []          # (step, device-metrics, host-side rates)

    def log(self, step: int, metrics: Dict[str, float], *,
            tokens_per_batch: Optional[int] = None,
            examples_per_batch: Optional[int] = None,
            n_chips: int = 1):
        now = time.perf_counter()
        dt = now - self._last_time
        dsteps = max(step - self._last_step, 1)
        rates = {"step_time_s": dt / dsteps}
        if tokens_per_batch:
            rates["tokens_per_sec"] = tokens_per_batch * dsteps / dt
        if examples_per_batch:
            rates["examples_per_sec_per_chip"] = (
                examples_per_batch * dsteps / dt / n_chips)
        self._last_time = now
        self._last_step = step
        self._buf.append((step, dict(metrics), rates))
        if step % self.log_every == 0:
            self.flush()

    def flush(self):
        """Drain the buffer: ONE device sync for log_every steps."""
        buf, self._buf = self._buf, []
        last = None
        for step, metrics, rates in buf:
            rec = {"step": step,
                   **{k: float(v) for k, v in metrics.items()}, **rates}
            last = rec
            if self._f:
                self._f.write(json.dumps(rec) + "\n")
        if self._f and buf:
            self._f.flush()
        if last is not None:
            logger.info(" ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in last.items()))
        return last

    def close(self):
        self.flush()
        if self._f:
            self._f.close()
