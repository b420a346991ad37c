"""Host kernel launches (``cudaLaunchKernel`` and kin) per tick in the
traced slice."""
from portbench.harness import readers

LAYER = "backend (kernels/backend.py)"
UNIT = "launches"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "decode_tok_s"


def read(run):
    return readers.launches_per_pass(run)
