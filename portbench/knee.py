"""Sweep an open-loop cell's mean rate to find its knee: the highest rate,
under the mix's own bursts, at which the backlog does not grow across the
window.

    python3 portbench/knee.py --workload <cell> --rates 400,800,1200 \
        --seconds 30 --seed <n>

Each rate runs in a fresh process, as a benchmark run does: its own
set-up, then one window at that rate. For each rate it prints the backlog
(requests due and not yet answered) at the end of every burst period, as
the median over that period's last two seconds, the p95 latency from due
to answer, the answers inside the window and the generator's p99
lateness. A rate is sustained when no later period's backlog exceeds the
first period's by more than one micro-batch (``max_batch``). The last line
gives the knee (the highest rate sustained, with every lower rate swept
sustained too) and four fifths of it.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def outstanding_at(requests, t: float) -> int:
    return sum(1 for r in requests
               if r.due <= t and (r.done is None or r.done > t))


def backlog_of_period(requests, end: float, span: float = 2.0) -> float:
    """Median backlog over the last ``span`` seconds before ``end``, read
    every 0.1 s."""
    n = int(round(span / 0.1))
    return statistics.median(outstanding_at(requests, end - 0.1 * k)
                             for k in range(n))


def one_rate(args) -> dict:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench.harness import stats
    from portbench.harness.manifest import Tree

    tree = Tree(args.root)
    wl = tree.workload(args.workload)
    cfgdoc = tree.config(wl["config"])
    driver = importlib.import_module(f"portbench.drivers.{cfgdoc['driver']}")
    traffic = tree.module("traffic", wl["traffic"])
    system = driver.System(cfgdoc, wl, tree.path(cfgdoc["plan"]), args.seed,
                           args.device)
    system.setup()
    every = float(wl["mix"].get("burst", {}).get("every_s", args.seconds))
    mix = dict(wl["mix"], rate=args.rate)
    w = traffic.drive(system, mix, args.seed, args.seconds)
    ends = [w.t0 + k * every for k in range(1, int(args.seconds // every) + 1)]
    backlog = [backlog_of_period(w.requests, t) for t in ends]
    lat, failed = stats.latencies(w.requests, w.deadline)
    return {"rate": args.rate, "backlog_at_period_ends": backlog,
            "p95_ms": 1e3 * stats.percentile(lat, 95),
            "answered_in_window": stats.completed_in(
                (r.done for r in w.requests), w.t0, w.t1),
            "sent": len(w.requests), "failed": failed,
            "gen_lag_p99_ms": 1e3 * stats.percentile(
                [r.submitted - r.due for r in w.requests], 99),
            "sustained": bool(backlog) and max(backlog)
            <= backlog[0] + system.max_batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--rate", type=float, default=None,
                    help="one rate, in this process (what the sweep runs)")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    if args.rate is not None:
        print(json.dumps(one_rate(args)), flush=True)
        return 0
    recs = []
    for rate in (float(x) for x in args.rates.split(",")):
        out = subprocess.run(
            [sys.executable, __file__, "--workload", args.workload,
             "--rate", str(rate), "--seconds", str(args.seconds),
             "--seed", str(args.seed), "--device", args.device,
             "--root", args.root], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            return out.returncode
        recs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(recs[-1]), flush=True)
    knee = None
    for rec in sorted(recs, key=lambda r: r["rate"]):
        if not rec["sustained"]:
            break
        knee = rec["rate"]
    print(json.dumps({"knee": knee,
                      "four_fifths": None if knee is None else 0.8 * knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
