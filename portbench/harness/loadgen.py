"""What every traffic kind shares: the request record, the set of lengths a
mix draws from, and the inputs of each request, all from the seed.

Every seed gets the same multiset of lengths (and of inter-arrival gaps),
in another order: the lengths are the quantiles of the mix's log-normal at
evenly spaced probabilities, clipped to the mix's range, and the seed only
permutes them. So two seeds ask the same work of the system, and the seed
moves which request comes when and which tokens it holds.
"""
from __future__ import annotations

import dataclasses
import math
import time
from statistics import NormalDist
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One request as the load generator sees it; times on the host's
    monotonic clock (seconds)."""
    uid: int
    tokens: np.ndarray
    segments: np.ndarray
    due: float = 0.0            # when the schedule wanted it sent
    submitted: Optional[float] = None
    done: Optional[float] = None
    logits: Optional[np.ndarray] = None
    max_tokens: int = 0         # tokens to generate (decode mixes)
    output: Optional[list] = None
    first_token: Optional[float] = None

    @property
    def length(self) -> int:
        return len(self.tokens)


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for one use of the seed."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def lognormal_set(n: int, median: float, sigma: float, lo: int,
                  hi: int) -> np.ndarray:
    """n lengths: the log-normal's quantiles at (i + 0.5) / n, rounded and
    clipped to [lo, hi], in increasing order."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.exp(math.log(median) + sigma * z)
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def exponential_set(n: int) -> np.ndarray:
    """n unit-mean exponential gaps at the quantiles (i + 0.5) / n."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u)


def _set(spec: dict, n: int, g: np.random.Generator) -> np.ndarray:
    return g.permutation(lognormal_set(n, spec["median"], spec["sigma"],
                                       spec["min"], spec["max"]))


class Inputs:
    """The requests of one run: lengths from the mix's set in the seed's
    order, tokens uniform over [1, vocab), and, for a share ``pairs`` of
    them (every other request at 0.5), a second segment over the back
    half of the tokens (a sentence pair). A mix with ``outputs`` also gives
    each request the number of tokens to generate, from that set."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        n = int(mix.get("pool", 4096))
        self.lengths = _set(mix["lengths"], n, rng(seed, 1))
        self.outputs = (_set(mix["outputs"], n, rng(seed, 4))
                        if "outputs" in mix else None)
        self.pairs = float(mix.get("pairs", 0.0))
        self.vocab = vocab
        self.tok_rng = rng(seed, 2)

    def request(self, uid: int) -> Request:
        n = int(self.lengths[uid % len(self.lengths)])
        toks = self.tok_rng.integers(1, self.vocab, n, dtype=np.int64)
        seg = np.zeros(n, np.int64)
        if self.pairs and n >= 2 and int(uid * self.pairs) != int(
                (uid + 1) * self.pairs):
            seg[n // 2:] = 1
        r = Request(uid, toks, seg)
        if self.outputs is not None:
            r.max_tokens = int(self.outputs[uid % len(self.outputs)])
        return r


@dataclasses.dataclass
class Window:
    """What one measured window left: the requests it sent (due inside it),
    its bounds on the monotonic clock, the deadline by which an unanswered
    request counts as failed, and the program's counters as the window
    closed."""
    requests: list
    t0: float
    t1: float
    deadline: float = 0.0
    at_close: dict = dataclasses.field(default_factory=dict)


def run_step(system, now: float, force: bool = False):
    """One engine step inside a benchmark span; stamps what it retired."""
    from torch.profiler import record_function
    with record_function("portbench.step"):
        retired = system.step(now, force=force)
    done = time.monotonic()
    for r in retired:
        r.done = done
    return retired
