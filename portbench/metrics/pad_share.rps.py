"""Padded tokens over real plus padded tokens of the window's passes
(``Runtime.stats``)."""
LAYER = "runtime (serve/runtime.py)"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "encode_rps"


def read(run):
    real = run.window.at_close["runtime_real_tokens"] - run.before["runtime_real_tokens"]
    pad = (run.window.at_close["runtime_padded_tokens"]
           - run.before["runtime_padded_tokens"])
    return 100.0 * pad / (real + pad) if real + pad else None
