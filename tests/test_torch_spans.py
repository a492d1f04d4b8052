"""The port's span recorder (``utils/profiling.py``): the ring and its drop
count, parent and request links, stamps on ``torch.profiler``'s clock, the
spans of the continuous engine (the decode loop tiled, the time to first
token split into queue wait, admission and the wait for a slot) and of the
train step, and the spans written into ``profiling.trace``'s Chrome
trace. CPU, the tiny config."""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from macaw_llm_tpu_torch import config as tconfig
from macaw_llm_tpu_torch import serve as tserve
from macaw_llm_tpu_torch.models import fusion as tfusion
from macaw_llm_tpu_torch.train import trainer as ttrainer
from macaw_llm_tpu_torch.utils import profiling
from macaw_llm_tpu_torch.utils.profiling import SPANS, SpanRecorder

DECODE = ("decode.place", "decode.launch", "decode.readback", "decode.sleep")


def _since(t0: int, spans=None) -> list:
    spans = SPANS.snapshot()[0] if spans is None else spans
    return [s for s in spans if s.start_ns >= t0]


def test_ring_keeps_the_last_spans_and_counts_those_dropped():
    rec = SpanRecorder(capacity=4)
    t = time.time_ns()
    for k in range(6):
        t = rec.lap(f"s{k}", t)
    rec.count("hits")
    rec.count("hits", 2)
    spans, dropped, counters = rec.snapshot()
    assert [s.name for s in spans] == ["s2", "s3", "s4", "s5"]
    assert dropped == 2 and counters == {"hits": 3}
    assert all(a.end_ns == b.start_ns for a, b in zip(spans, spans[1:]))
    assert SpanRecorder().snapshot() == ([], 0, {})


def test_parent_and_request_links():
    rec = SpanRecorder()
    with rec.span("admit", request=7, device=torch.device("cpu")):
        with rec.span("admit.prefill"):
            with rec.child("towers"):
                pass
        rec.add("request.place_wait", 1, 2, 9)
    with rec.child("orphan"):  # no open span: nothing recorded
        pass
    rec.settle()
    spans = {s.name: s for s in rec.snapshot()[0]}
    assert set(spans) == {"admit", "admit.prefill", "admit.prefill.towers",
                          "request.place_wait"}
    assert spans["admit"].parent is None
    assert spans["admit.prefill"].parent == spans["admit"].id
    assert spans["admit.prefill.towers"].parent == \
        spans["admit.prefill"].id
    assert {s.request for n, s in spans.items() if n.startswith("admit")} \
        == {7}
    assert spans["request.place_wait"].request == 9
    # closed in order: children first
    assert spans["admit.prefill.towers"].id < spans["admit.prefill"].id \
        < spans["admit"].id
    # the device's time is measured on a CUDA device only
    assert all(s.device_ms is None for s in spans.values())


def test_stamps_on_the_profilers_clock():
    """A span and a ``record_function`` range over the same interval: the
    profiler's record starts and ends within 2 ms of the span."""
    rec = SpanRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with rec.span("probe"), record_function("probe_range"):
                time.sleep(0.005)
    ranges = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.name() == "probe_range")
    spans = [(s.start_ns, s.end_ns) for s in rec.snapshot()[0]]
    assert len(ranges) == len(spans) == 3
    for (rs, re_), (ss, se) in zip(ranges, spans):
        assert abs(rs - ss) < 2e6 and abs(re_ - se) < 2e6


def test_chrome_trace_holds_the_blocks_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        with SPANS.span("probe.block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.002)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in ours] == ["probe.block"]
    theirs = [e for e in events if e.get("ph") == "X"
              and e.get("cat") != "span"]
    assert theirs
    lo = min(e["ts"] for e in theirs)
    hi = max(e["ts"] + e["dur"] for e in theirs)
    span = ours[0]
    assert lo <= span["ts"] and span["ts"] + span["dur"] <= hi
    assert span["dur"] >= 2e3  # microseconds
    assert span["tid"] == os.getpid()  # the main thread's row


class Tok:
    def encode(self, text):
        return [1] + [7 + (sum(map(ord, w)) * 131 + len(w)) % 31000
                      for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def tiny():
    cfg = tconfig.tiny_model_config()
    return cfg, tfusion.init_params(0, cfg, dtype=torch.float32,
                                    device="cpu")


def test_engine_spans(tiny):
    """Four requests (one with media) over two slots: a ``decode.launch``
    a step; the decode thread's spans tile its loop; each request's queue
    wait, admission and wait for a slot add up to its time from creation
    to the first streamed token."""
    cfg, params = tiny
    size = cfg.vision.image_size
    rng = np.random.RandomState(0)
    eng = tserve.ContinuousEngine(params, cfg, Tok(), slots=2,
                                  prompt_bucket=32, max_new_tokens=4,
                                  device="cpu")
    firsts = {}
    t0 = time.time_ns()

    def request(prompt, **media):
        req = tserve.Request(prompt=prompt, max_new_tokens=4, **media)
        req.stream_cb = lambda t, r=req: firsts.setdefault(r._id,
                                                           time.time_ns())
        return req

    reqs = [request("first question here"),
            request("what is in this picture",
                    image=rng.randint(0, 255, (size, size, 3)).astype(
                        np.uint8),
                    audio=(rng.randn(480000) * 0.1).astype(np.float32)),
            request("third thing entirely"), request("and a fourth one")]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)  # another thread waits at most 0.1 ms
    eng.start()
    try:
        for r in reqs:
            eng.queue.put(r)
        for r in reqs:
            assert r._done.wait(120) and "text" in r._result, r._result
    finally:
        eng.stop()
        sys.setswitchinterval(interval)
    assert not eng._thread.is_alive()
    spans = _since(t0)

    loop = sorted((s for s in spans if s.thread == eng._thread.ident
                   and s.name.startswith("decode.")),
                  key=lambda s: s.start_ns)
    assert {s.name for s in loop} <= set(DECODE)
    assert sum(s.name == "decode.launch" for s in loop) == eng.stats["steps"]
    assert all(a.end_ns == b.start_ns for a, b in zip(loop, loop[1:]))

    for r in reqs:
        mine = {s.name: s for s in spans if s.request == r._id
                and s.parent is None}
        qw, adm, pw = (mine["request.queue_wait"], mine["admit"],
                       mine["request.place_wait"])
        assert qw.start_ns == r._created_ns and qw.end_ns == adm.start_ns
        assert adm.end_ns == pw.start_ns == r._handed_ns
        split = (qw.end_ns - qw.start_ns) + (adm.end_ns - adm.start_ns) + \
            (pw.end_ns - pw.start_ns)
        assert abs(split - (firsts[r._id] - r._created_ns)) < 1e6
        children = {s.name for s in spans if s.parent == adm.id}
        want = {"admit.encode", "admit.prefill", "admit.handoff"}
        if r.image is not None:
            want |= {"admit.featurize", "admit.towers", "admit.align"}
        assert want <= children <= want | {"admit.towers", "admit.align"}


def test_train_step_spans(tiny):
    cfg, params = tiny
    tr = ttrainer.Trainer(cfg, tconfig.TrainConfig(), total_steps=4,
                          device="cpu")
    t0 = time.time_ns()
    state = tr.init_state(params)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(16, 32000, (1, 2, 12)))
    ids[..., 0] = 1
    batch = {"input_ids": ids, "labels": ids.clone(),
             "attention_mask": torch.ones_like(ids)}
    tr.train_step(state, batch)
    spans = _since(t0)
    assert [s.name for s in spans if s.name.startswith("setup.")] == \
        ["setup.init_state"]
    (step,) = [s for s in spans if s.name == "train.step"]
    children = [s for s in spans if s.parent == step.id]
    assert sorted(s.name for s in children) == \
        ["train.backward", "train.forward", "train.optimizer"]
    assert all(step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
               for s in children)
