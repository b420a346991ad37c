"""Requests answered inside the window over the window's seconds."""
from portbench.harness import stats

UNIT = "requests/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    w = run.window
    return stats.rate(stats.completed_in((r.done for r in w.requests),
                                         w.t0, w.t1), run.seconds)
