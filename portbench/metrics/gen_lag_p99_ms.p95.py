"""99th percentile of how late the load generator sent each request past
its due time (the loop is busy in a pass when a request falls due)."""
from portbench.harness import readers

LAYER = "load generator (portbench/traffic)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "encode_p95_ms"


def read(run):
    return readers.p_ms([r.submitted - r.due for r in run.window.requests
                         if r.submitted is not None], 99)
