"""Mean host wall of a ``ServeEngine.step`` (one tick of every slot, to
its logits on the host), from spans the benchmark records around the
call, over the window's ticks outside the traced slice."""
from portbench.harness import readers

LAYER = "engine (serve/engine.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "decode_tok_s"


def read(run):
    return readers.mean_pass_ms(run)
