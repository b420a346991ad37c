"""95th percentile, over the requests sent inside the window, of the time
from sending to the first generated token (on the host, after the tick
that made it); one that never made a token counts at its age at the
deadline."""
from portbench.harness import readers

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    w = run.window
    return readers.p_ms([(r.first_token if r.first_token is not None
                          else w.deadline) - r.submitted
                         for r in w.requests if w.t0 <= r.submitted < w.t1],
                        95)
