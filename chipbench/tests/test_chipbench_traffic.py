"""The generator: the same seed gives the same requests; every seed gets
the same trace (sizes and, open, arrival times) with its own prompt ids;
lengths stay within their distributions."""
import json
from collections import Counter

import numpy as np
import pytest

from harness.traffic import Traffic, draw_length

from conftest import BENCH


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def closed_draws(t, clients, per):
    out = []
    for i in range(clients):
        it = t.client(i)
        out.append([next(it) for _ in range(per)])
    return out


@pytest.mark.parametrize("name", ["decode-closed"])
def test_closed_loop_same_seed_same_requests(name):
    m = mix(name)
    a = closed_draws(Traffic(m, 2 ** 31 + 7, 50304), 8, 3)
    b = closed_draws(Traffic(m, 2 ** 31 + 7, 50304), 8, 3)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert x.n_tokens == y.n_tokens
            np.testing.assert_array_equal(x.prompt, y.prompt)


def test_seeds_share_one_trace_with_their_own_prompts():
    m = mix("decode-closed")
    a = closed_draws(Traffic(m, 1, 1000), 8, 3)
    b = closed_draws(Traffic(m, 2, 1000), 8, 3)
    assert [[(len(d.prompt), d.n_tokens) for d in row] for row in a] == \
        [[(len(d.prompt), d.n_tokens) for d in row] for row in b]
    assert not np.array_equal(a[0][1].prompt, b[0][1].prompt)
    o = mix("chat-poisson")
    a = Traffic(o, 11, 50304).arrivals(20.0)
    b = Traffic(o, 12, 50304).arrivals(20.0)
    assert [(d.due, len(d.prompt), d.n_tokens) for d in a] == \
        [(d.due, len(d.prompt), d.n_tokens) for d in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)
    for x, y in zip(a, Traffic(o, 11, 50304).arrivals(20.0)):
        np.testing.assert_array_equal(x.prompt, y.prompt)
    rate = o["arrivals"]["rate"]
    assert abs(len(a) / 20.0 - rate) < 0.25 * rate
    assert all(0 <= d.due < 20.0 for d in a)
    assert all(1 <= t < 50304 for d in a for t in d.prompt[:50])


@pytest.mark.parametrize("process", [{"process": "poisson", "rate": 8.0},
                                     {"process": "gamma", "rate": 8.0,
                                      "shape": 0.25}])
def test_open_loop_rate(process):
    m = dict(mix("chat-poisson"), arrivals=process)
    due = np.array([d.due for d in Traffic(m, 3, 100).arrivals(400.0)])
    assert abs(len(due) / 400.0 - 8.0) < 0.6
    gaps = np.diff(due)
    # a gamma process of shape k has gaps of coefficient of variation
    # 1/sqrt(k): 2 at k = 1/4, 1 for Poisson
    cv = gaps.std() / gaps.mean()
    want = 1.0 / np.sqrt(process.get("shape", 1.0))
    assert abs(cv - want) < 0.2 * want


@pytest.mark.parametrize("spec", [
    {"dist": "uniform", "lo": 64, "hi": 256},
    {"dist": "loguniform", "lo": 2048, "hi": 8192},
    {"dist": "lognormal", "median": 1024, "sigma": 0.8, "lo": 128,
     "hi": 4096}])
def test_lengths_within_bounds_and_centred(spec):
    rng = np.random.default_rng(0)
    xs = np.array([draw_length(rng, spec) for _ in range(20000)])
    assert xs.min() >= spec["lo"] and xs.max() <= spec["hi"]
    if spec["dist"] == "uniform":
        assert abs(xs.mean() - (spec["lo"] + spec["hi"]) / 2) < 2
    elif spec["dist"] == "loguniform":
        # log-uniform: the median is the geometric mean of the ends
        assert abs(np.median(xs) / np.sqrt(spec["lo"] * spec["hi"]) - 1) \
            < 0.03
    else:
        assert abs(np.median(xs) / spec["median"] - 1) < 0.03


def test_first_aged_requests_are_caught_in_flight():
    m = mix("decode-closed")
    t = Traffic(m, 5, 50304)
    firsts = [next(t.client(i)) for i in range(t.clients)]
    lo, hi = m["prompt"]["lo"], m["prompt"]["hi"]
    out_hi = m["output"]["hi"]
    for d in firsts:
        assert 1 <= d.n_tokens <= out_hi
        assert lo <= len(d.prompt) <= hi + out_hi - 1
        assert len(d.prompt) + d.n_tokens <= hi + out_hi
    # in flight, a request has served half of a length-biased output on
    # average: E[n^2] / (2 E[n]) for n uniform on 512..2048, ~717 tokens
    served = np.mean([len(d.prompt) for d in firsts]) - (lo + hi) / 2
    assert 550 < served < 900
