"""Mean host wall of a pass of the engine (``Runtime.encode`` of one
micro-batch), from spans the benchmark records around the call."""
from portbench.harness import readers

LAYER = "engine (serve/encoder.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "encode_rps"


def read(run):
    return readers.mean_pass_ms(run)
