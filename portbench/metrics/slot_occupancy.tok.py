"""Mean live slots over slots, per tick, over the window's ticks."""
LAYER = "admission (serve/scheduler.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "decode_tok_s"


def read(run):
    t = run.window.at_close["ticks"] - run.before["ticks"]
    live = run.window.at_close["tokens"] - run.before["tokens"]
    return 100.0 * live / (t * run.system.slots) if t else None
