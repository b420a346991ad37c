"""The whole tick's share of the card's peak: the model operations of the
live slots' tokens in the traced slice (each at its position's context,
each op at its precision's peak) over the slice's wall time."""
from portbench.harness import flops

LAYER = "device (the H100)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "decode_tok_s"


def read(run):
    ticks = run.passes(traced=True)
    if not ticks:
        return None
    bound = sum(flops.decoder_token_bound_s(run.cfg, run.plan, int(p) + 1)
                for *_, pos in ticks for p in pos)
    return 100.0 * bound / run.trace["window_s"]
