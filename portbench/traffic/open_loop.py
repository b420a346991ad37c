"""Open loop: independent users whose requests arrive on a schedule,
whatever the system does (online classification). The mix's parameters:

* ``rate``: the mean arrival rate over the window, requests/s;
* ``burst``: ``every_s``, ``length_s`` and ``factor``: for ``length_s`` at
  the start of every ``every_s`` the rate is ``factor`` times the base rate
  (the base set so that the mean is ``rate``);
* ``lengths`` and ``pairs``: as in the closed loop.

The arrivals are a Poisson process of that intensity conditioned on its
count: exactly round(rate x seconds) requests, placed by exponential
spacings at the quantiles of the exponential (the same set for every seed,
in the seed's order) and carried through the intensity's inverse. Each
request is timed from when it was due, so a stall delays every request
behind it; the generator's lateness (sent minus due) is kept. After the
window the loop sends nothing more and waits for the answers, a minute at
most: a request unanswered then counts at its age, and as failed.
"""
from __future__ import annotations

import math
import time

import numpy as np

from portbench.harness.loadgen import (Inputs, Window, exponential_set, rng,
                                       run_step)

DRAIN_S = 60.0


def intensity(mix: dict):
    """(base rate, cumulative intensity L(t), its inverse)."""
    b = mix.get("burst", {})
    every = float(b.get("every_s", 1.0))
    length = float(b.get("length_s", 0.0))
    factor = float(b.get("factor", 1.0))
    base = float(mix["rate"]) / (1.0 + (factor - 1.0) * length / every)
    per = base * (every + (factor - 1.0) * length)     # L over one period

    def cum(t: float) -> float:
        k, r = divmod(t, every)
        return k * per + base * (r + (factor - 1.0) * min(r, length))

    def inv(u: float) -> float:
        k, r = divmod(u, per)
        burst = base * factor * length
        t = r / (base * factor) if r <= burst else length + (r - burst) / base
        return k * every + t

    return base, cum, inv


def arrivals(mix: dict, seed: int, seconds: float) -> np.ndarray:
    """Due times (s after the window opens) of every request of the run."""
    n = int(round(float(mix["rate"]) * seconds))
    _, cum, inv = intensity(mix)
    gaps = rng(seed, 3).permutation(exponential_set(n + 1))
    u = np.cumsum(gaps)[:n] / gaps.sum() * cum(seconds)
    return np.array([inv(x) for x in u])


def drive(system, mix: dict, seed: int, seconds: float,
          tracer=None) -> Window:
    inputs = Inputs(mix, seed, system.vocab)
    offsets = arrivals(mix, seed, seconds)
    reqs = [inputs.request(i) for i in range(len(offsets))]
    max_wait = float(system.max_wait)
    t0 = time.monotonic()
    for r, o in zip(reqs, offsets):
        r.due = t0 + float(o)
    w = Window(reqs, t0, t0 + seconds, deadline=t0 + seconds + DRAIN_S)
    i, waiting = 0, {}
    while True:
        now = time.monotonic()
        if tracer is not None:
            tracer.poll(now, t0)
        while i < len(reqs) and reqs[i].due <= now:
            r = reqs[i]
            r.submitted = now
            system.submit(r, r.due)
            waiting[r.uid] = r
            i += 1
        if now >= w.t1 and not w.at_close:
            w.at_close = system.counters()
        for r in run_step(system, now):
            waiting.pop(r.uid, None)
        if i == len(reqs) and not waiting:
            break
        now = time.monotonic()
        if now >= w.deadline:
            break
        nxt = min([reqs[i].due] if i < len(reqs) else [math.inf])
        if waiting:
            nxt = min(nxt, min(r.due for r in waiting.values()) + max_wait)
        if nxt > now:
            time.sleep(min(nxt - now, w.deadline - now))
    if tracer is not None:
        tracer.stop()
    if not w.at_close:
        w.at_close = system.counters()
    return w
