"""The load generator: determinism by seed, the length and arrival sets,
the open loop's due-time arithmetic, and latency under a stall."""
import math
import time

import numpy as np
import pytest

from portbench.harness import loadgen, stats
from portbench.traffic import closed_loop, open_loop

MIX = {"lengths": {"median": 32, "sigma": 0.6, "min": 8, "max": 128},
       "pairs": 0.5, "pool": 512}
BIG = 2 ** 31 + 12345


def test_inputs_are_the_seeds_and_share_one_length_set():
    a, b = loadgen.Inputs(MIX, BIG, 100), loadgen.Inputs(MIX, BIG, 100)
    c = loadgen.Inputs(MIX, BIG + 1, 100)
    ra = [a.request(i) for i in range(40)]
    rb = [b.request(i) for i in range(40)]
    for x, y in zip(ra, rb):
        assert np.array_equal(x.tokens, y.tokens)
        assert np.array_equal(x.segments, y.segments)
    assert not np.array_equal(a.lengths, c.lengths)
    assert sorted(a.lengths) == sorted(c.lengths)
    assert a.lengths.min() >= 8 and a.lengths.max() <= 128
    assert np.median(a.lengths) == pytest.approx(32, abs=1)
    assert all(1 <= t < 100 for r in ra for t in r.tokens)


def test_every_other_request_is_a_pair_with_a_second_segment():
    x = loadgen.Inputs(MIX, 7, 100)
    for i in range(10):
        r = x.request(i)
        if i % 2:
            assert r.segments[: r.length // 2].sum() == 0
            assert (r.segments[r.length // 2:] == 1).all()
        else:
            assert not r.segments.any()


def test_lognormal_set_hits_its_quantiles():
    xs = loadgen.lognormal_set(1001, 280, 0.35, 1, 10 ** 6)
    assert xs[500] == 280
    q84 = xs[int(0.8413 * 1001)]
    assert q84 == pytest.approx(280 * math.exp(0.35), rel=0.01)


@pytest.mark.parametrize("seconds", [10.0, 30.0])
def test_arrivals_count_order_and_bursts(seconds):
    mix = {"rate": 200.0,
           "burst": {"every_s": 10.0, "length_s": 1.0, "factor": 1.5}}
    a = open_loop.arrivals(mix, BIG, seconds)
    assert np.array_equal(a, open_loop.arrivals(mix, BIG, seconds))
    assert len(a) == round(200 * seconds)
    assert (np.diff(a) >= 0).all() and a[0] >= 0 and a[-1] < seconds
    base = 200.0 / 1.05
    in_burst = ((a % 10.0) < 1.0).sum()
    assert in_burst == pytest.approx(1.5 * base * seconds / 10, rel=0.2)
    b = open_loop.arrivals(mix, BIG + 1, seconds)
    assert not np.array_equal(a, b)


def test_intensity_and_its_inverse():
    mix = {"rate": 105.0,
           "burst": {"every_s": 10.0, "length_s": 1.0, "factor": 1.5}}
    base, cum, inv = open_loop.intensity(mix)
    assert base == pytest.approx(100.0)
    assert cum(1.0) == pytest.approx(150.0)
    assert cum(10.0) == pytest.approx(1050.0)
    assert cum(12.0) == pytest.approx(1050.0 + 150.0 + 100.0)
    for t in (0.3, 1.0, 4.2, 9.99, 10.5, 17.0):
        assert inv(cum(t)) == pytest.approx(t)


class FakeSystem:
    """Answers every queued request on each step; the step at ``stall_at``
    (its index) sleeps ``stall_s`` first."""

    vocab = 50
    max_wait = 0.0

    def __init__(self, stall_at=None, stall_s=0.0):
        self.queue, self.steps = [], 0
        self.stall_at, self.stall_s = stall_at, stall_s

    def submit(self, r, now):
        self.queue.append(r)

    def step(self, now, force=False):
        if self.steps == self.stall_at:
            time.sleep(self.stall_s)
        self.steps += 1
        out, self.queue = self.queue, []
        for r in out:
            r.logits = np.zeros(2, np.float32)
        return out

    def outstanding(self):
        return len(self.queue)

    def counters(self):
        return {"steps": self.steps}


def test_open_loop_times_from_due_and_counts_a_stall():
    mix = dict(MIX, rate=100.0)
    w = open_loop.drive(FakeSystem(stall_at=5, stall_s=0.3), mix, 3, 1.0)
    assert len(w.requests) == 100
    assert all(r.done is not None for r in w.requests)
    lat, failed = stats.latencies(w.requests, w.deadline)
    assert failed == 0
    # requests due while the stall held wait for it, timed from their due
    assert max(lat) >= 0.2
    assert all(r.submitted >= r.due for r in w.requests)
    assert max(r.submitted - r.due for r in w.requests) >= 0.2
    assert stats.percentile(lat, 50) < 0.1


def test_closed_loop_keeps_its_clients_busy():
    mix = dict(MIX, clients=4)
    w = closed_loop.drive(FakeSystem(), mix, 3, 0.3)
    done_in = stats.completed_in((r.done for r in w.requests), w.t0, w.t1)
    assert done_in >= 4
    assert len(w.requests) >= done_in + 4 - 4
    assert all(r.done is not None for r in w.requests)
