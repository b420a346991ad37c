"""Host kernel launches (``cudaLaunchKernel`` and kin) per micro-batch in
the traced slice."""
from portbench.harness import readers

LAYER = "backend (kernels/backend.py)"
UNIT = "launches"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "encode_p95_ms"


def read(run):
    return readers.launches_per_pass(run)
