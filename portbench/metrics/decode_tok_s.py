"""Tokens generated inside the window over the window's seconds."""
UNIT = "tokens/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    w = run.window
    made = sum(n for t, n in run.system.generated if w.t0 <= t < w.t1)
    return made / run.seconds
