"""Readers that several metric files share (one per cell they serve)."""
from __future__ import annotations

from portbench.harness import flops, stats


def idle_pct(run):
    """Share of the traced slice in which no operation ran on the device."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def mean_pass_ms(run):
    """Mean host wall of a pass (``Runtime.encode``, from its call to its
    answer on the host), over the window's passes outside the traced
    slice."""
    ps = run.passes(traced=False)
    return 1e3 * sum(b - a for a, b, *_ in ps) / len(ps) if ps else None


def launches_per_pass(run):
    """Host kernel launches in the traced slice per pass inside it."""
    ps = run.passes(traced=True)
    return run.trace["launches"] / len(ps) if ps else None


def kernel_roofline_pct(run, marker: str, bound_s):
    """Least time of the calls over the device time of the kernels whose
    name holds ``marker``, in the traced slice; None if none ran."""
    if run.trace is None:
        return None
    t = sum(s for name, (_, s) in run.trace["kernels"].items()
            if marker in name)
    return 100.0 * bound_s / t if t > 0 else None


def encoder_mfu_pct(run, n_out: int):
    """The real tokens' model operations of the traced slice's passes at
    their precisions' peaks, over the slice's wall time."""
    ps = run.passes(traced=True)
    if not ps:
        return None
    bound = sum(flops.encoder_request_bound_s(run.cfg, run.plan, int(n), n_out)
                for *_, lengths in ps for n in lengths)
    return 100.0 * bound / run.trace["window_s"]


def p_ms(values, q):
    return 1e3 * stats.percentile(values, q) if values else None
