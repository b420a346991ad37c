"""95th percentile over every request due in the window of the time from
when it was due to its logits on the host; a request never answered counts
at its age at the deadline."""
from portbench.harness import readers, stats

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    lat, _ = stats.latencies(run.window.requests, run.window.deadline)
    return readers.p_ms(lat, 95)
