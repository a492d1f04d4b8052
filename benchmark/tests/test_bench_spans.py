"""``spans.py`` and the readers built on it: synthetic device operations
and spans (each idle nanosecond to one state, clipping to the traced
window, readers of cells without their spans, a ring that dropped spans),
then the program's own spans of a tiny serving and training run on the
CPU laid over a made-up device trace."""

import time
from collections import namedtuple
from types import SimpleNamespace

import pytest
import torch

from benchmark import drive_serve, drive_train, harness, spans
from benchmark.tests import tiny

ROOT = harness.HERE.parent
M = harness.load_manifest(ROOT)
SPAN_METRICS = [x["name"] for x in M["per_layer"]
                if x["source"] == "program_span"]
Span = namedtuple("Span", "id name thread start_ns end_ns parent request "
                          "device_ms")


def _program(monkeypatch, records, dropped=0):
    """The program's recorder holding ``records``: (name, start, end[,
    request[, device_ms]]), closed in that order."""
    out = [Span(dropped + k, r[0], 1, r[1], r[2], None,
                r[3] if len(r) > 3 else None, r[4] if len(r) > 4 else None)
           for k, r in enumerate(records)]
    rec = SimpleNamespace(snapshot=lambda: (out, dropped, {}))
    monkeypatch.setattr(spans, "_recorder", lambda: rec)


def _window(kind, ops, lo, hi, t0=None):
    """A window whose traced stretch is [lo, hi) ns (the clocks made one:
    ``epoch_ns`` is patched to seconds x 1e9)."""
    trace = SimpleNamespace(ops=[(s, e, "k") for s, e in ops],
                            _t0=lo / 1e9, window_s=(hi - lo) / 1e9)
    return SimpleNamespace(kind=kind, trace=trace,
                           t0=(lo if t0 is None else t0) / 1e9)


@pytest.fixture
def one_clock(monkeypatch):
    monkeypatch.setattr(spans, "epoch_ns", lambda s: round(s * 1e9))


def _read(name, w):
    return harness.reader(name).read(w)


def test_each_idle_nanosecond_goes_to_one_state(monkeypatch, one_clock):
    # idle [0, 10), [30, 60), [70, 100): 70 of 100 ns
    _program(monkeypatch, [("decode.place", 0, 25),
                           ("decode.launch", 25, 50),
                           ("decode.readback", 50, 80),
                           ("admit", 0, 100, 4)])
    w = _window("serve", [(10, 20), (15, 30), (60, 70)], 0, 100)
    split = spans.idle_split(w, spans.DECODE_STATES)
    assert split == {"decode.place": 10.0, "decode.launch": 20.0,
                     "decode.readback": 20.0, spans.OTHER: 20.0}
    assert _read("idle_in_launch.serve", w) == 20.0
    assert _read("idle_in_readback.serve", w) == 20.0
    assert _read("idle_in_launch.over", w) == 20.0
    # overlapping states: the later one holds the overlap, counted once
    assert spans.attribute([(0, 100)], [(0, 50, "a"), (40, 60, "b")]) == \
        {"a": 40, "b": 20, spans.OTHER: 40}
    assert spans.attribute([(0, 10), (20, 30)], []) == {spans.OTHER: 20}


def test_operations_and_spans_are_clipped_to_the_window(monkeypatch,
                                                        one_clock):
    _program(monkeypatch, [("train.step", 0, 300), ("train.step", 400, 500)])
    w = _window("train", [(50, 120), (190, 260)], 100, 200)
    assert spans.idle_intervals(w.trace.ops, 100, 200) == [(120, 190)]
    assert _read("idle_in_step.train", w) == 70.0
    assert [s.start_ns for s in spans.in_trace(w)] == [0]


def test_request_and_setup_readers(monkeypatch, one_clock):
    ms = 1_000_000
    _program(monkeypatch, [
        ("setup.quantize", 0, 2 * ms, None, 5.0),  # device 5 ms: to 5 ms
        ("setup.kernel_load", 1 * ms, 3 * ms),     # inside it
        ("setup.pack", 10 * ms, 11 * ms),
        ("setup.pack", 900 * ms, 901 * ms),        # after the window opened
        ("request.queue_wait", 100 * ms, 110 * ms, 1),
        ("admit", 110 * ms, 150 * ms, 1),          # ends before the trace
        ("request.queue_wait", 120 * ms, 300 * ms, 2),
        ("admit", 300 * ms, 360 * ms, 2),
        ("request.queue_wait", 130 * ms, 400 * ms, 3),
        ("admit", 400 * ms, 480 * ms, 3),
        ("request.place_wait", 360 * ms, 370 * ms, 2),
        ("request.place_wait", 480 * ms, 500 * ms, 3)])
    w = _window("serve", [(250 * ms, 260 * ms)], 200 * ms, 600 * ms,
                t0=50 * ms)
    assert _read("admission_ms.serve", w) == 70.0
    assert _read("admission_ms.over", w) == 70.0
    assert _read("place_wait_ms.serve", w) == 15.0
    assert _read("queue_wait_p95_ms.serve", w) == 270.0  # of 180, 270
    assert _read("setup_program_s", w) == pytest.approx(0.006)


def test_readers_of_cells_without_their_spans_read_none(monkeypatch,
                                                        one_clock):
    def serve():
        return _window("serve", [(10, 20)], 0, 100)

    def train():
        return _window("train", [(10, 20)], 0, 100)

    def untraced():
        return SimpleNamespace(kind="serve", trace=None, t0=0.0)

    # a program without the recorder (the parent of these metrics)
    monkeypatch.setattr(spans, "_recorder", lambda: None)
    for name in SPAN_METRICS:
        for w in (serve(), train(), untraced()):
            assert _read(name, w) is None, name
    # a serving window holds no train step, a training window no decode
    # loop or request, neither a set-up span
    _program(monkeypatch, [("train.step", 0, 50), ("decode.launch", 0, 50),
                           ("admit", 60, 70, 1)])
    assert _read("idle_in_step.train", serve()) is None
    assert _read("idle_in_launch.serve", train()) is None
    assert _read("admission_ms.serve", train()) is None
    assert _read("setup_program_s", serve()) is None
    assert _read("idle_in_launch.serve", untraced()) is None
    _program(monkeypatch, [("setup.pack", 0, 5)])
    for name in SPAN_METRICS:
        if name != "setup_program_s":
            assert _read(name, serve()) is None, name


def test_a_window_with_dropped_spans_is_refused(monkeypatch, one_clock):
    # three spans dropped; the oldest kept closed inside the window
    _program(monkeypatch, [("decode.launch", 40, 60),
                           ("decode.readback", 60, 100)], dropped=3)
    with pytest.raises(RuntimeError, match="dropped 3 spans"):
        _read("idle_in_launch.serve", _window("serve", [(90, 95)], 50, 100))
    # ... and before it: nothing of the window can be missing
    assert _read("idle_in_readback.serve",
                 _window("serve", [(80, 90)], 70, 100)) == \
        pytest.approx(100 * 20 / 30)
    # set-up needs every span since the process began
    with pytest.raises(RuntimeError):
        _read("setup_program_s", _window("serve", [(90, 95)], 60, 100))


def _traced(w, ops_share: float = 0.1) -> None:
    """Give a window of the CPU run a made-up trace over all of it: one
    device operation over its first ``ops_share``."""
    lo = spans.epoch_ns(w.t0)
    n = int((w.t1 - w.t0) * 1e9)
    w.trace = SimpleNamespace(ops=[(lo, lo + int(n * ops_share), "k")],
                              _t0=w.t0, window_s=w.t1 - w.t0)


def test_the_programs_spans_of_a_tiny_run():
    """The program's own spans (CPU, tiny size): the decode states tile
    the loop, so they take all of the made-up idle time; every request
    metric and the set-up read a value."""
    out = drive_serve.run(tiny.config(), tiny.SERVE, {"name": "tiny"},
                          2 ** 31 + 7, 2.0, False, torch.device("cpu"),
                          time.perf_counter(), tiny.SERVE_LIMITS)
    w = out["window"]
    _traced(w)
    split = spans.idle_split(w, spans.DECODE_STATES)
    assert sum(split.values()) == pytest.approx(90.0, abs=1e-3)
    assert split[spans.OTHER] < 1.0
    for name in ("queue_wait_p95_ms.serve", "admission_ms.serve",
                 "place_wait_ms.serve", "setup_program_s"):
        assert _read(name, w) > 0, name

    out = drive_train.run(tiny.config(), tiny.TRAIN, {"name": "tiny"},
                          2 ** 31 + 9, 0.5, False, torch.device("cpu"),
                          time.perf_counter(), tiny.TRAIN_LIMITS)
    w = out["window"]
    _traced(w)
    # the window is the steps end to end: the steps hold nearly all of it
    assert 80.0 < _read("idle_in_step.train", w) <= 90.0
    assert _read("setup_program_s", w) > 0
