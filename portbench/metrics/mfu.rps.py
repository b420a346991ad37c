"""The whole step's share of the card's peak: the real tokens' model
operations in the traced slice, each at its precision's peak (int8, or
float32 with TF32 off), over the slice's wall time."""
from portbench.harness import readers

LAYER = "device (the H100)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "encode_rps"


def read(run):
    return readers.encoder_mfu_pct(run, run.system.n_out)
