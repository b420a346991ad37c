"""Closed loop: a fixed number of clients, each sending its next request as
soon as its last one is answered (callers that wait for a reply, such as a
labelling job's workers). The mix's parameters:

* ``clients``: how many requests are outstanding at every moment;
* ``lengths``: ``median``, ``sigma`` (of the log-normal), ``min``, ``max``;
* ``pairs``: the share of requests that are sentence pairs (default 0).

Every request sent inside the window is attempted; those still in flight
when it closes are served after it (late, not failed) and count toward
``correct``, but not toward the rate, which counts the answers that came
inside the window.
"""
from __future__ import annotations

import time

from portbench.harness.loadgen import Inputs, Window, run_step

DRAIN_S = 60.0


def drive(system, mix: dict, seed: int, seconds: float,
          tracer=None) -> Window:
    inputs = Inputs(mix, seed, system.vocab)
    t0 = time.monotonic()
    w = Window([], t0, t0 + seconds, deadline=t0 + seconds + DRAIN_S)

    def send(now: float) -> None:
        r = inputs.request(len(w.requests))
        r.due = r.submitted = now
        system.submit(r, now)
        w.requests.append(r)

    for _ in range(int(mix["clients"])):
        send(t0)
    while True:
        now = time.monotonic()
        if tracer is not None:
            tracer.poll(now, t0)
        if now >= w.t1:
            w.at_close = system.counters()
            break
        for r in run_step(system, now):
            if r.done < w.t1:
                send(r.done)
    if tracer is not None:
        tracer.stop()
    while system.outstanding() and time.monotonic() < w.deadline:
        run_step(system, time.monotonic(), force=True)
    return w
