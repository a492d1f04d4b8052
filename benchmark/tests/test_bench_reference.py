"""The rest of a run on the CPU at a tiny size, with the look for a card
skipped: the port against the plain reference, the control (the
reference with 4-bit LLM weights in the program's place) and the faults
planted in the timed path, each of which has to come out not correct."""

import contextlib
import time

import pytest
import torch

from benchmark import drive_serve, drive_train, faults, harness
from benchmark.tests import tiny

CPU = torch.device("cpu")
# answers long enough, and requests often enough, that every slot fills,
# so that a fault in half of them reaches the sampled requests
FILLED = dict(tiny.SERVE, arrival={"rate_per_s": 30.0},
              answer_tokens={"min": 20, "max": 30, "dist": "uniform"})


def serve(spec=tiny.SERVE, seed=2 ** 31 + 7, fault=None, control=False):
    with (fault() if fault else contextlib.nullcontext()):
        return drive_serve.run(tiny.config(), spec, {"name": "tiny"}, seed,
                               3.0, False, CPU, time.perf_counter(),
                               tiny.SERVE_LIMITS, control=control)


def train(seed=2 ** 31 + 9, fault=None, control=False, spec=tiny.TRAIN):
    with (fault() if fault else contextlib.nullcontext()):
        return drive_train.run(tiny.config(), spec, {"name": "tiny"},
                               seed, 0.5, False, CPU, time.perf_counter(),
                               tiny.TRAIN_LIMITS, control=control)


@pytest.mark.parametrize("spec", [tiny.SERVE, tiny.CHAT],
                         ids=["media", "text"])
def test_served_tokens_agree_with_the_reference(spec):
    out = serve(spec, control=True)
    assert harness.verdict(out["checks"])
    assert out["info"]["checked_tokens"] >= 10 and out["failed"] == 0
    # the control fails the limit
    assert out["info"]["control_widest_gap"] > \
        tiny.SERVE_LIMITS["widest_gap"]


@pytest.mark.parametrize("name", sorted(faults.SERVE))
def test_a_serving_fault_is_not_correct(name):
    out = serve(FILLED, seed=12, fault=faults.SERVE[name])
    assert not harness.verdict(out["checks"])


@pytest.mark.parametrize("spec", [tiny.TRAIN, tiny.TRAIN_TEXT],
                         ids=["media", "text"])
def test_training_agrees_with_the_reference_and_the_control_does_not(spec):
    out = train(control=True, spec=spec)
    assert harness.verdict(out["checks"])
    low = {k: {"value": v, "limit": tiny.TRAIN_LIMITS[k]}
           for k, v in out["info"]["control"].items()}
    assert not harness.verdict(low)


@pytest.mark.parametrize("name", sorted(faults.TRAIN))
def test_a_training_fault_is_not_correct(name):
    out = train(seed=11, fault=faults.TRAIN[name])
    assert not harness.verdict(out["checks"])
