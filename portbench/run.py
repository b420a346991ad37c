"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up makes the weights and calibration batches from the seed,
calibrates and quantizes them through the program under the
configuration's plan, and warms every bucket of the cell; then the cell's
traffic runs for ``--seconds``. With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled slice of the window. The program's answers are then checked
against the plain reference; each number compared is printed beside its
limit, as the last lines on standard error and last in the result line.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's caches stay inside the checkout (its kernel build
    # already does: src/repro_torch/kernels/_build)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "portbench" / "_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "portbench" / "_cache" / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from portbench.harness import core
    from portbench.harness.manifest import Tree

    tree = Tree(ROOT)
    cell = tree.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (fails where the program is absent)

    result, checks = core.run_cell(tree, args.workload, args.seed,
                                   args.seconds, bool(args.trace),
                                   t_start=T_START, device="cuda")
    bad = core.forbidden_modules()
    if bad:
        print(f"modules that must not load here were loaded: {bad}",
              file=sys.stderr)
        return 4
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result, default=core.np_default))
    return 0


if __name__ == "__main__":
    sys.exit(main())
