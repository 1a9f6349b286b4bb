"""The seeded traffic: the same seed gives the same schedule, every seed
the same sizes and gaps in another order, at the means the mixes state,
shuffled whole, and an open loop puts exactly ``round(rate * seconds)``
requests due in the window."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic as tr

MIXES = Path(__file__).resolve().parents[1] / "traffic"
CHAT = {"dist": "lognormal", "median": 1020, "sigma": 0.5, "lo": 4,
        "hi": 1536}
CHAT_OUT = {"dist": "lognormal", "median": 129, "sigma": 1.0, "lo": 4,
            "hi": 512}
NAMES = ["deepseek-7b.chat", "mixtral-8x7b.chat"]


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


def test_stated_means():
    # the chat mixes' lengths: the source's medians, conditioned on what a
    # 2048-token lane holds
    assert tr.mean_length(CHAT) == pytest.approx(910.5, abs=0.5)
    assert tr.mean_length(CHAT_OUT) == pytest.approx(150.4, abs=0.5)
    p = tr.lengths(CHAT, 4000)
    assert np.median(p) == pytest.approx(895, abs=2)
    assert p.mean() == pytest.approx(910.5, rel=0.002)
    assert np.median(tr.lengths(CHAT_OUT, 4000)) == pytest.approx(116, abs=1)
    assert tr.lengths(CHAT_OUT, 4000).mean() == pytest.approx(150.4,
                                                               rel=0.002)
    # unbounded, the medians are the source's
    wide = dict(CHAT, lo=1, hi=10 ** 6)
    assert np.median(tr.lengths(wide, 4001)) == pytest.approx(1020, abs=1)
    assert tr.median_length(dict(CHAT_OUT, lo=1, hi=10 ** 6)) == 129
    u = tr.lengths({"dist": "uniform", "lo": 3600, "hi": 4090}, 490)
    assert u.min() == 3600 and u.max() == 4090 and len(set(u)) == 490
    for name in NAMES:
        mix = _mix(name)
        assert mix["prompt"] == CHAT and mix["output"] == CHAT_OUT
        assert mix["source"] and mix["assumed"]


@pytest.mark.parametrize("name", NAMES)
def test_seed_orders_a_fixed_set(name):
    mix = _mix(name)
    a = tr.schedule(mix, 2 ** 33 + 7, 45, 32000)
    b = tr.schedule(mix, 2 ** 33 + 7, 45, 32000)
    c = tr.schedule(mix, 11, 45, 32000)
    assert [(x.due, x.max_new_tokens, x.prompt.tolist()) for x in a] == \
        [(x.due, x.max_new_tokens, x.prompt.tolist()) for x in b]
    for seg in ("warmup", "window"):
        sa = [x for x in a if x.segment == seg]
        sc = [x for x in c if x.segment == seg]
        assert sorted(len(x.prompt) for x in sa) == \
            sorted(len(x.prompt) for x in sc)
        assert sorted(x.max_new_tokens for x in sa) == \
            sorted(x.max_new_tokens for x in sc)
        assert [len(x.prompt) for x in sa] != [len(x.prompt) for x in sc]
    for x in a:
        lo, hi = mix["prompt"]["lo"], mix["prompt"]["hi"]
        assert lo <= len(x.prompt) <= hi
        assert x.prompt.dtype == np.int32 and x.prompt.max() < 32000


def test_open_loop_window_count_and_span():
    mix = _mix("deepseek-7b.chat")
    rate = mix["arrival"]["rate"]
    items = tr.schedule(mix, 5, 45, 1000)
    win = [x for x in items if x.segment == "window"]
    warm = [x for x in items if x.segment == "warmup"]
    in_flight = round(rate * mix["request_s"])
    assert len(win) == round(rate * 45)
    assert len(warm) == round(rate * mix["warmup_s"]) + in_flight
    assert win[0].due == 0.0 and max(x.due for x in win) < 45
    assert -mix["warmup_s"] == warm[0].due and max(x.due for x in warm) < 0
    first = [x for x in warm
             if x.due < -mix["warmup_s"] + mix["in_flight_s"]]
    assert len(first) >= in_flight
    gaps = np.diff([x.due for x in win] + [45.0])
    assert gaps.sum() == pytest.approx(45.0)
    assert sorted(gaps) == pytest.approx(sorted(tr.gaps(rate, len(win), 45)))


def test_backlog_warmup_lengths():
    mix = {"loop": "backlog", "requests": 48,
           "warmup": {"requests": 32, "output": {"dist": "uniform",
                                                 "lo": 16, "hi": 1000}},
           "prompt": CHAT, "output": CHAT_OUT}
    items = tr.schedule(mix, 9, 45, 32000)
    warm = [x for x in items if x.segment == "warmup"]
    assert len(warm) == mix["warmup"]["requests"]
    assert len(items) == len(warm) + mix["requests"]
    assert all(x.due == 0.0 for x in items)
    assert min(x.max_new_tokens for x in warm) < 100
    assert max(x.max_new_tokens for x in warm) > 900


def test_in_flight_start_has_the_residual_lengths():
    # a steady loop's requests in flight have E[O^2] / (2 E[O]) to go
    r = tr.residual_lengths(CHAT_OUT, 2000)
    o = tr.lengths(CHAT_OUT, 100000).astype(float)
    assert r.mean() == pytest.approx((o ** 2).mean() / (2 * o.mean()),
                                     rel=0.02)
    assert r.min() >= 1 and r.max() <= 512


def test_gaps_are_shuffled_whole():
    # no stratification: over many seeds the longest gaps fall anywhere,
    # and runs of short gaps (clusters of arrivals) occur as often as
    # they would in a uniform permutation
    mix = _mix("deepseek-7b.chat")
    rate = mix["arrival"]["rate"]
    g = tr.gaps(rate, 200, 200 / rate)
    cut = np.quantile(g, 0.3)
    runs = []
    for seed in range(40):
        s = tr.shuffled(g, np.random.RandomState(seed))
        assert sorted(s.tolist()) == sorted(g.tolist())
        short = s < cut
        # the longest run of gaps from the shortest 30%
        best = cur = 0
        for x in short:
            cur = cur + 1 if x else 0
            best = max(best, cur)
        runs.append(best)
    # a uniform permutation of 200 with 60 short gaps gives runs of 4-8;
    # blocks of ten with three short gaps each cap a run at 6
    assert max(runs) >= 7 and np.mean(runs) > 4


def test_percentile_by_nearest_rank():
    assert tr.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.0
    assert tr.percentile(list(range(10, 0, -1)), 90) == 9
    assert tr.percentile(list(range(1, 101)), 90) == 90
