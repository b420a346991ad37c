"""One run of one cell: set the program up, drive the cell's traffic for the
window, read the metrics, check what the program answered against the
plain reference, and build the result line."""
from __future__ import annotations

import dataclasses
import importlib
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from portbench.harness import loadgen, trace
from portbench.harness.manifest import Tree

# modules that must not be loaded in the process that prints a result,
# compared by whole top-level name ("repro_torch" is not "repro")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    names = {m.split(".", 1)[0] for m in (modules or list(sys.modules))}
    return sorted(names.intersection(FORBIDDEN))


@dataclasses.dataclass
class RunView:
    """What a metric's reader may read."""
    window: loadgen.Window
    system: object
    before: dict
    trace: Optional[dict]
    setup_s: float
    seconds: float

    @property
    def plan(self):
        return self.system.plan

    @property
    def cfg(self) -> dict:
        return self.system.c

    def in_slice(self, t0: float, t1: float) -> bool:
        a, b = self.trace["t_host"]
        return a <= t0 and t1 <= b

    def passes(self, traced: bool) -> list:
        """The passes inside the window, inside (or outside) the traced
        slice."""
        w = self.window
        if traced:
            return ([] if self.trace is None else
                    [p for p in self.system.passes
                     if self.in_slice(p[0], p[1])])
        return [p for p in self.system.passes
                if w.t0 <= p[0] and p[1] < w.t1
                and (self.trace is None or not self.in_slice(p[0], p[1]))]


def sample(requests: list, seed: int, n: int) -> list:
    """Up to n answered requests drawn from the seed, the longest (prompt
    and output) among them."""
    done = [r for r in requests if r.done is not None]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.length + len(r.output or ()),
                                       -r.uid))
    rest = [r for r in done if r is not longest]
    g = loadgen.rng(seed, 7)
    pick = g.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def run_cell(tree: Tree, name: str, seed: int, seconds: float, traced: bool,
             *, t_start: float, device="cuda",
             fault: Optional[Callable] = None) -> tuple[dict, dict]:
    """Returns (the result line, the checks as {name: (value, limit)})."""
    wl = tree.workload(name)
    cfgdoc = tree.config(wl["config"])
    driver = importlib.import_module(f"portbench.drivers.{cfgdoc['driver']}")
    system = driver.System(cfgdoc, wl, tree.path(cfgdoc["plan"]), seed,
                           device)
    system.setup()
    if fault is not None:
        fault(system)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tracer = trace.Tracer(**wl["trace"]) if traced else None
    if tracer is not None:
        tracer.prewarm()
    before = system.counters()
    setup_s = time.perf_counter() - t_start
    traffic = tree.module("traffic", wl["traffic"])
    window = traffic.drive(system, wl["mix"], seed, seconds, tracer)
    summary = tracer.summary() if tracer is not None else None
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    view = RunView(window, system, before, summary, setup_s, seconds)
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in tree.metrics_of(name, section):
        value = tree.module("metrics", m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = sum(1 for r in window.requests
                 if r.done is None or r.done > window.deadline)
    system.release()

    limits = wl["correct"]
    chosen = sample(window.requests, seed, int(limits["sample"]))
    values = driver.compare(system, chosen)
    checks = {k: (v, float(limits[k])) for k, v in values.items()
              if k in limits}
    checks["unanswered"] = (failed, 0)
    correct = len(chosen) > 0 and all(v <= lim for v, lim in checks.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(window.requests),
              "failed": failed, "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = trace.breakdown(summary)
        print(f"traced slice {summary['window_s']:.3f} s, profiler start "
              f"{summary['start_cost_s']:.3f} s", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def np_default(o):
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(type(o).__name__)
