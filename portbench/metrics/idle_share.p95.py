"""Share of the traced slice in which no operation ran on the device."""
from portbench.harness import readers

LAYER = "device (the H100)"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "encode_p95_ms"


def read(run):
    return readers.idle_pct(run)
