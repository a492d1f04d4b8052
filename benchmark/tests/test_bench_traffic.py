"""The traffic generator: deterministic per seed, the same sizes for every
seed, text ids that are never specials."""

import collections

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.tests import tiny


def test_serve_requests_repeat_per_seed():
    cfg = tiny.config()
    a = traffic.ServeTraffic(tiny.SERVE, cfg, 2 ** 31 + 11)
    b = traffic.ServeTraffic(tiny.SERVE, cfg, 2 ** 31 + 11)
    for i in range(40):
        ra, rb = a.request(i), b.request(i)
        assert ra == rb
        ma, mb = a.media(ra["media"]), b.media(rb["media"])
        assert all(np.array_equal(x, y) for x, y in zip(ma, mb))
    c = traffic.ServeTraffic(tiny.SERVE, cfg, 5)
    assert [a.request(i)["ids"] for i in range(8)] != \
        [c.request(i)["ids"] for i in range(8)]


def test_every_seed_serves_the_same_sizes():
    cfg = tiny.config()
    n = traffic.POOL

    def sizes(seed):
        t = traffic.ServeTraffic(tiny.SERVE, cfg, seed)
        return collections.Counter(
            (len(t.request(i)["ids"]), t.request(i)["max_new"])
            for i in range(n))

    assert sizes(1) == sizes(2 ** 31 + 3) == sizes(123456789)
    order = [traffic.ServeTraffic(tiny.SERVE, cfg, s).sizes for s in (1, 2)]
    assert order[0] != order[1]


@pytest.mark.parametrize("cv", [0, 1.0, 3.0])
def test_arrivals_have_the_rate_and_spread_of_the_mix(cv):
    spec = dict(tiny.CHAT, arrival={"rate_per_s": 8.0, "gap_cv": cv})
    cfg, n = tiny.config(), traffic.POOL
    a = traffic.ServeTraffic(spec, cfg, 2 ** 31 + 5)
    times = np.array([a.arrival(i) for i in range(2 * n + 1)])
    gaps = np.diff(times)
    # mean gap one, each pool of gaps repeats, the spread is the mix's
    assert times[n] == pytest.approx(n) and times[2 * n] == pytest.approx(
        2 * n)
    assert (gaps >= 0).all()
    assert np.allclose(gaps[:n], gaps[n:])
    assert np.std(gaps) / np.mean(gaps) == pytest.approx(cv, abs=0.1 * cv +
                                                         1e-9)
    # the same gaps for every seed, in another order
    b = traffic.ServeTraffic(spec, cfg, 7)
    other = np.diff([b.arrival(i) for i in range(n + 1)])
    assert np.allclose(np.sort(other), np.sort(gaps[:n]))
    if cv:
        assert not np.allclose(other, gaps[:n])


def test_lengths_span_their_range():
    g = traffic._grid({"min": 32, "max": 256, "dist": "log_uniform"}, 512)
    # the quantiles (k + 1/2) / n stop half a step short of either end
    assert g.min() == 32 and g.max() == 255
    assert abs(np.median(g) - np.sqrt(32 * 256)) < 3


def test_text_ids_skip_specials():
    ids = traffic.text_ids(np.random.default_rng(0), 200000, 32064)
    assert ids.min() >= traffic.SPECIAL_LOW and ids.max() < 32064
    assert not np.isin(ids, list(traffic.MARKER_IDS)).any()


def test_train_batches_repeat_per_seed_and_differ_by_index():
    cfg = tiny.config()
    a = traffic.train_batch(tiny.TRAIN, cfg, 9, 0, "cpu")
    b = traffic.train_batch(tiny.TRAIN, cfg, 9, 0, "cpu")
    c = traffic.train_batch(tiny.TRAIN, cfg, 9, 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["input_ids"], c["input_ids"])
    assert (a["input_ids"][:, 0] == 1).all()
    assert (a["labels"][:, 0] == -100).all()
    assert torch.equal(a["labels"][:, 1:], a["input_ids"][:, 1:])
    assert a["images"].shape[0] == 2
    text = traffic.train_batch(tiny.TRAIN_TEXT, cfg, 9, 0, "cpu")
    assert set(text) == {"input_ids", "labels", "attention_mask"}
    assert torch.equal(text["input_ids"], a["input_ids"])
