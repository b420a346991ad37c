"""The device trace of one steady slice of the window, reduced.

``torch.profiler`` runs over a fixed slice of the measured window (the
workload's ``trace`` entry: where it starts and how long it lasts), started
and stopped between two engine steps, so every pass inside it is whole.
The raw Kineto events are read once and reduced to:

* ``busy_s``: the union of the device's activity intervals (kernels,
  copies, sets) inside the slice, and ``window_s``, the slice's length;
* ``kernels``: device seconds and calls by kernel name;
* ``launches``: host calls that launch a kernel (``cudaLaunchKernel`` and
  its kin);
* ``gaps``: the device's idle intervals, the longest of them labelled by
  what the host was doing then (the innermost benchmark span and the
  innermost host operation that cover the gap's middle).
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Optional

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")
LABELLED_GAPS = 400         # the longest gaps that get a label
NAME_CHARS = 160


def _sync() -> bool:
    """Wait for the card, where there is one."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        return True
    return False


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


class Tracer:
    """Profiles [t0 + start_s, t0 + start_s + length_s) of a window that
    began at host time t0; :meth:`poll` is called between engine steps."""

    def __init__(self, start_s: float, length_s: float):
        self.start_s, self.length_s = float(start_s), float(length_s)
        self.prof = None
        self.state = "before"
        self.t_host = (None, None)      # the slice on the monotonic clock
        self.t_ns = (None, None)        # the slice on the profiler's clock

    def prewarm(self) -> None:
        """Start and stop the profiler once before the window: its first
        start loads and initialises the tracing library, which takes
        seconds and would otherwise stall the window."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if _sync():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        _sync()
        prof.stop()

    def poll(self, now: float, t0: float) -> None:
        if self.state == "before" and now >= t0 + self.start_s:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if _sync():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            t = time.monotonic()
            self.prof.start()
            self.t_ns = (time.time_ns(), None)
            self.t_host = (time.monotonic(), None)
            self.start_cost_s = self.t_host[0] - t
            self.state = "on"
        elif self.state == "on" and now >= self.t_host[0] + self.length_s:
            self.stop()

    def stop(self) -> None:
        if self.state != "on":
            return
        _sync()
        self.t_ns = (self.t_ns[0], time.time_ns())
        self.t_host = (self.t_host[0], time.monotonic())
        self.prof.stop()
        self.state = "done"

    def summary(self) -> Optional[dict]:
        if self.state != "done":
            return None
        events = self.prof.profiler.kineto_results.events()
        # a span recorded on the host also shows on the device's timeline
        # (a user annotation over its kernels): it is no device work
        out = reduce_events(
            [(e.name(), e.device_type().name, e.start_ns(), e.end_ns(),
              e.is_user_annotation()) for e in events],
            self.t_ns[0], self.t_ns[1], self.t_host)
        out["start_cost_s"] = self.start_cost_s
        return out


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(events, t0: int, t1: int, t_host=(None, None)) -> dict:
    """``events``: (name, device type name, start ns, end ns, whether it is
    a user annotation) on the profiler's clock; [t0, t1) the slice on the
    same clock."""
    dev, host = [], []
    kernels: dict = collections.defaultdict(lambda: [0, 0.0])
    launches = 0
    for name, dtype, s, e, note in events:
        if dtype == "CUDA" and (note or name.startswith("portbench.")):
            continue
        if dtype == "CUDA":
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            dev.append((s, e))
            k = kernels[_short(name)]
            k[0] += 1
            k[1] += (e - s) * 1e-9
        else:
            if name.startswith(LAUNCH_PREFIXES) and t0 <= s < t1:
                launches += 1
            host.append((s, e, name))
    busy = union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = sorted(h for h in host if h[2].startswith("portbench."))
    ops = sorted(h for h in host if not h[2].startswith("portbench."))
    starts = [h[0] for h in ops]
    labelled: dict = collections.defaultdict(float)
    gaps.sort(key=lambda g: g[0] - g[1])
    for s, e in gaps[:LABELLED_GAPS]:
        labelled[_label(spans, ops, starts, (s + e) // 2)] += (e - s) * 1e-9
    rest = sum(e - s for s, e in gaps[LABELLED_GAPS:]) * 1e-9
    if rest:
        labelled[f"shorter gaps ({len(gaps) - LABELLED_GAPS})"] += rest
    return {"busy_s": busy_s, "window_s": (t1 - t0) * 1e-9,
            "t_host": t_host, "launches": launches,
            "kernels": {k: (v[0], v[1]) for k, v in kernels.items()},
            "gaps": dict(labelled)}


def _label(spans, ops, starts, m: int, scan: int = 4000) -> str:
    """The innermost benchmark span and host op covering time ``m``."""
    inner = [(e - s, n) for s, e, n in spans if s <= m <= e]
    op = None
    i = bisect.bisect_right(starts, m)
    for j in range(i - 1, max(i - 1 - scan, -1), -1):
        s, e, name = ops[j]
        if e >= m and (op is None or e - s < op[0]):
            op = (e - s, name)
    parts = [p[1] for p in (min(inner, default=None), op) if p is not None]
    return _short(" > ".join(parts)) if parts else "no host event"


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:top]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v[1]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
