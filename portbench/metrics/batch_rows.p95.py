"""Mean real rows per micro-batch over the window (the engine's
``batches`` and ``batched_rows`` counters)."""
LAYER = "admission (serve/scheduler.py)"
UNIT = "rows"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "encode_p95_ms"


def read(run):
    b = run.window.at_close["batches"] - run.before["batches"]
    rows = run.window.at_close["batched_rows"] - run.before["batched_rows"]
    return rows / b if b else None
