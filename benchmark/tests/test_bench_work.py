"""The frozen counting code against hand counts, and the window rules and
metric arithmetic on made-up windows."""

import json
from pathlib import Path

import pytest

from benchmark import drive_serve, drive_train, harness, trace, work
from benchmark.tests import tiny

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def sizes(name="macaw-deepseek-llm-7b"):
    return work.Sizes.of(json.loads((CONFIGS / f"{name}.json").read_text()))


def test_attention_counts():
    assert work.attn_pairs(4, 4, True) == 10          # 1 + 2 + 3 + 4
    assert work.attn_pairs(2, 4, True) == 7           # last two queries
    assert work.attn_pairs(2, 4, False) == 8
    assert work.attn_flops(1, 4, 4, 2, 8, True) == 4 * 2 * 8 * 10
    assert work.attn_bwd_flops(1, 4, 4, 2, 8, True) == 2.5 * 640
    # q, k, v, o: 64 values each in bf16; lse 8 fp32; bias 4 fp32
    assert work.flash_fwd_bytes(1, 4, 4, 2, 8) == 2 * 256 + 4 * 8
    assert work.flash_fwd_bytes(1, 4, 4, 2, 8, bias=True) == 544 + 16
    # q, o, dO, k, v read and dq, dk, dv written, lse read
    assert work.flash_bwd_bytes(1, 4, 4, 2, 8) == 2 * 8 * 64 + 4 * 8


def test_matvec_and_bounds():
    assert work.matvec_flops(2, 8, 4) == 128
    assert work.matvec_bytes(2, 8, 4) == 32 + 16 + 2 * 2 * 12
    assert work.bound_s(989e12, 0.0) == (1.0, "operations")
    assert work.bound_s(0.0, 3.35e12) == (1.0, "bytes")
    s = sizes()
    # a 32-row step: every int8 weight and fp32 scale read once, 32 bf16
    # rows in and out of every projection, bound by bytes
    calls = [(4096, 12288, 30), (4096, 4096, 30), (4096, 22016, 30),
             (11008, 4096, 30), (4096, 102400, 1)]
    nbytes = sum(c * (k * n + 4 * n + 2 * 32 * (k + n))
                 for k, n, c in calls)
    assert work.decode_step_matvec_bound_s(s, 32) == \
        pytest.approx(nbytes / 3.35e12)


def test_sizes_of_the_deepseek_configuration():
    s = sizes()
    assert (s.conv_len("image"), s.conv_len("video"),
            s.conv_len("audio")) == (5, 39, 6)
    assert s.prefix_len == 56
    assert s.layer_params == 4 * 4096 * 4096 + 3 * 4096 * 11008
    assert work.llm_decode_flops(s, 100) == \
        30 * (2 * s.layer_params + 4 * 4096 * 100) + 2 * 4096 * 102400


def test_clip_by_hand_at_the_tiny_size():
    s = work.Sizes.of(tiny.config())
    patch = 2 * 4 * (3 * 16 * 16) * 32
    layer = 2 * 5 * (4 * 32 * 32 + 2 * 32 * 64) + 4 * 32 * 5 * 5
    proj = 2 * 4 * 32 * 16
    assert work.clip_flops(s, 1) == patch + 2 * layer + proj
    assert work.clip_flops(s, 3) == 3 * work.clip_flops(s, 1)


def test_qlora_step_is_mostly_the_base():
    s = sizes("macaw-baichuan-7b")
    base = 4.0 * 32 * s.layer_params * 8 * 1080
    step = work.qlora_step_flops(s, 8, 1024, 8)
    assert base < step < 1.12 * base
    text = work.qlora_step_flops(s, 8, 1024, 8, media=False)
    assert 4.0 * 32 * s.layer_params * 8 * 1024 < text < step


def test_percentile_is_the_rounded_rank():
    xs = list(range(1, 21))
    assert drive_serve.percentile(xs, 0.95) == 19
    assert drive_serve.percentile(xs, 0.5) == 11
    assert drive_serve.percentile([7.0], 0.95) == 7.0


def _records():
    # sent, token stamps: request 0 entirely in [10, 20], request 1 starts
    # before the window, request 2 ends after it
    return [{"index": 0, "n_ids": 33, "media": 0, "sent": 11.0,
             "toks": [(11.5, 5), (12.0, 6), (12.5, 7)], "done": 12.6,
             "error": None},
            {"index": 1, "n_ids": 65, "media": None, "sent": 8.0,
             "toks": [(9.0, 5), (10.5, 6), (11.0, 7)], "done": 11.1,
             "error": None},
            {"index": 2, "n_ids": 33, "media": 1, "sent": 19.0,
             "toks": [(19.5, 5), (20.5, 6)], "done": 20.6, "error": None}]


def test_serve_window_rules():
    w = drive_serve.Window(records=_records(), t0=10.0, t1=20.0,
                           sizes=sizes(), steps=80, admitted=2, slots=32,
                           trace=None)
    assert [r["index"] for r in w.first_tokens()] == [0, 2]
    assert sorted(w.itl_gaps()) == [0.5, 0.5, 0.5]
    s = w.sizes
    f0 = s.prefix_len + 32
    expect = (work.llm_prefill_flops(s, f0) + work.media_flops(s, 1)
              + work.llm_decode_flops(s, f0 + 1)
              + work.llm_decode_flops(s, f0 + 2)
              + work.llm_decode_flops(s, s.prefix_len + 64 + 1)
              + work.llm_decode_flops(s, s.prefix_len + 64 + 2)
              + work.llm_prefill_flops(s, f0) + work.media_flops(s, 1))
    assert w.model_flops() == pytest.approx(expect)
    assert harness.reader("decode_step_ms.serve").read(w) == 125.0
    assert harness.reader("mfu.decode").read(w) == pytest.approx(
        100 * w.model_flops(prefill=False) / 989e12 / 10.0)
    assert harness.reader("attention_roofline.train").read(w) is None


def test_serve_sample_takes_the_longest_and_repeats():
    recs = _records()
    a = drive_serve.sample(recs, 10.0, 20.0, 7, 4)
    assert a[0]["index"] in (0, 1) and len(a[0]["toks"]) == 3
    assert a == drive_serve.sample(recs, 10.0, 20.0, 7, 4)
    assert sorted(r["index"] for r in a) == [0, 1]  # 2 ends after the close
    assert len(drive_serve.sample(recs, 10.0, 20.0, 7, 1)) == 1


class _Trace(trace.DeviceTrace):
    def __init__(self, ops, window):
        super().__init__()
        self.ops, self.window_s = ops, window


def test_union_and_readers_on_a_trace():
    ns = 1_000_000_000
    ops = [(0, 2 * ns, "void matvec_wgmma<32, 1>(x)"),
           (1 * ns, 3 * ns, "void matvec_reduce_kernel(y)"),
           (5 * ns, 6 * ns, "elementwise_kernel")]
    t = _Trace(ops, 10.0)
    assert t.busy_s() == 4.0
    assert t.busy_s("matvec_") == 3.0
    assert t.top_ops(1) == [["matvec_wgmma", 2.0]]
    assert t.idle_gaps() == [["before elementwise_kernel", 2.0]]
    w = drive_serve.Window(records=_records(), t0=10.0, t1=20.0,
                           sizes=sizes(), steps=80, admitted=2, slots=32,
                           trace=t, trace_t0=10.0, trace_t1=20.0,
                           trace_stats0={"steps": 0, "admitted": 0},
                           trace_stats1={"steps": 50, "admitted": 2})
    assert harness.reader("device_idle.serve").read(w) == 60.0
    bound = 50 * work.decode_step_matvec_bound_s(w.sizes, 32) + \
        2 * work.head_matvec_bound_s(w.sizes)
    assert harness.reader("matvec_roofline").read(w) == \
        pytest.approx(100 * bound / 3.0)


def test_a_trace_short_of_launches_is_refused():
    t = _Trace([(0, 1, "matvec_wgmma")] * 5, 1.0)
    t._complete({"matvec_int8": 2, "matvec_int8_pipelined": 5})
    with pytest.raises(RuntimeError, match="dropped"):
        t._complete({"matvec_int8_pipelined": 8})


def test_train_gaps_leave_out_round_off_leaves():
    ref = {"loss": [10.0, 10.0], "grad_norm": [2.0, 2.0],
           "first_grad": {"a": 1.0, "b": 1.0, "c": 0.0, "d": 4.0},
           "raw_grad_max": {"a": 1.0, "b": 1.0, "c": 1e-9, "d": 4.0},
           "change": {"a": 1.0, "b": 2.0, "c": 1e-6, "d": 2.0}}
    prog = {"loss": [10.0, 10.1], "grad_norm": [2.0, 2.2],
            "first_grad": {"a": 1.0, "b": 1.5, "c": 0.0, "d": 4.0},
            "change": {"a": 1.0, "b": 2.0, "c": 0.5, "d": 2.0}}
    g = drive_train.gaps(prog, ref)
    assert g["loss_gap"] == pytest.approx(0.01)
    assert g["grad_norm_gap"] == pytest.approx(0.1)
    # median leaf norm 1.0: b reads 0.5 against max(1.0, 1.0)
    assert g["first_grad_gap"] == pytest.approx(0.5)
    assert g["change_gap"] == 0.0          # c moves by round-off: left out


def test_train_window_rate_and_readers():
    s = sizes("macaw-baichuan-7b")
    spec = {"rows": 8, "text_tokens": 1024, "media": "all"}
    cfg = {"training": {"lora_rank": 8}}
    w = drive_train.Window(t0=0.0, t1=30.0, seconds=30.0, steps=20,
                           trace_steps=10, sizes=s, cfg=cfg, spec=spec,
                           trace=_Trace([(0, 14 * 10 ** 9, "x")], 15.0))
    assert harness.reader("mfu.train").read(w) == pytest.approx(
        100 * 20 * work.qlora_step_flops(s, 8, 1024, 8) / 989e12 / 30.0)
    assert harness.reader("device_idle.train").read(w) == \
        pytest.approx(100 * (1 - 14 / 15))
    assert harness.reader("matvec_roofline").read(w) is None
