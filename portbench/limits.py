"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 portbench/limits.py --workload <cell> --seeds 1,2,3 \
        --seconds 8 [--control-seeds 1,2,3]

For each seed, in one process: the program is set up as in a run, serves
the cell's own traffic for ``--seconds``, and the widest gap between what
it answered and the plain reference is read on the run's sample (the
program's reading). On the control seeds the reference computed one
precision lower (every int8 quantity in 4 bits, float32 matmuls in TF32)
is read on the same sample in the program's place (the control's reading),
and so are each of its two halves alone. Prints one JSON line per seed.
The benchmark's own runs do not run the control.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="fused",
                    help="the program's compute backend (a witness run "
                         "with 'reference')")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench.harness import core
    from portbench.harness.manifest import Tree

    tree = Tree(args.root)
    wl = tree.workload(args.workload)
    cfgdoc = tree.config(wl["config"])
    driver = importlib.import_module(f"portbench.drivers.{cfgdoc['driver']}")
    traffic = tree.module("traffic", wl["traffic"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        system = driver.System(cfgdoc, wl, tree.path(cfgdoc["plan"]), seed,
                               args.device, backend=args.backend)
        system.setup()
        window = traffic.drive(system, wl["mix"], seed, args.seconds)
        system.release()
        chosen = core.sample(window.requests, seed, int(wl["correct"]
                                                        ["sample"]))
        ref = system.reference(8)
        rec = {"seed": seed, "answered": len(chosen),
               "program": driver.compare(system, chosen, against=ref)}
        if seed in controls:
            rec["control"] = driver.compare(system, chosen, bits=4,
                                            tf32=True, against=ref)
            rec["control_int4_only"] = driver.compare(system, chosen, bits=4,
                                                      against=ref)
            rec["control_tf32_only"] = driver.compare(system, chosen,
                                                      tf32=True, against=ref)
        rec["seconds"] = time.perf_counter() - t
        print(json.dumps(rec), flush=True)
        del system, ref, window, chosen
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
