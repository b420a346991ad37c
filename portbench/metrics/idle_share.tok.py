"""Share of the traced slice in which no operation ran on the device."""
from portbench.harness import readers

LAYER = "device (the H100)"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "decode_tok_s"


def read(run):
    return readers.idle_pct(run)
