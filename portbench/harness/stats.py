"""Rates, percentiles and latencies over a window's requests."""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q <= 100) by the nearest rank: the
    smallest value with at least q% of the sample at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of an empty sample")
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def rate(count: int, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate needs a window of positive length")
    return count / seconds


def completed_in(done_times: Iterable[Optional[float]], t0: float,
                 t1: float) -> int:
    """Requests that completed inside [t0, t1)."""
    return sum(1 for d in done_times if d is not None and t0 <= d < t1)


def latencies(requests, deadline: float) -> tuple[list[float], int]:
    """Each request's latency from its due time to its answer, and the
    count that never answered: a request unfinished at ``deadline``
    counts at its age then, and as failed."""
    out, failed = [], 0
    for r in requests:
        if r.done is None or r.done > deadline:
            out.append(deadline - r.due)
            failed += 1
        else:
            out.append(r.done - r.due)
    return out, failed
