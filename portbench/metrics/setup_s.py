"""Set-up: from the process's start to the first measured request (weights,
calibration, quantization, engine and warm-up of the cell's buckets; and, in
a checkout's first run, the kernels' build)."""
LAYER = "harness"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
