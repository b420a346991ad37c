"""Serving metrics (port of ``repro.serve.metrics``, numpy- and torch-free
like its original): one counters surface for both engines + a Prometheus
text-format registry for an HTTP front-end's ``/metrics`` endpoint.

Two layers:

* :func:`engine_counters` — the ONE place the scheduler/engine numbers
  (queue depth, batch occupancy, completed/evicted, runtime retraces) are
  read. Both ``ServeEngine.stats`` / ``EncoderServeEngine.stats`` and the
  ``/metrics`` endpoint go through it, so a dashboard and a ``stats()``
  call can never disagree about what the engine is doing.

* :class:`MetricsRegistry` with :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` — a minimal Prometheus exposition-format (0.0.4)
  registry. Gauges may be callback-backed, so scheduler state is sampled
  at scrape time rather than double-booked; histograms keep a bounded
  reservoir of recent samples so p50/p95/p99 can be exported next to the
  cumulative buckets.

No external dependency: the exporter is ~100 lines of text formatting,
which is the point — the serving stack stays stdlib-only.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Optional, Sequence

# Request-latency bucket upper bounds (seconds). Shared by the /metrics
# histogram and the benchmark artifacts (BENCH_serve.json), so client- and
# server-side histograms line up bucket for bucket.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# The metric names the front-end always exports — the CI smoke and the
# acceptance tests assert every one of these appears in a /metrics scrape.
CORE_METRICS = (
    "samp_build_info",
    "samp_queue_depth",
    "samp_batch_occupancy",
    "samp_requests_completed_total",
    "samp_requests_evicted_total",
    "samp_runtime_retraces_total",
    "samp_runtime_executables",
    "samp_requests_admitted_total",
    "samp_requests_rejected_total",
    "samp_requests_inflight",
    "samp_request_latency_seconds",
    "samp_kv_cache_bytes",
    "samp_kv_pages_in_use",
    "samp_cluster_requests_total",
    "samp_active_plans",
)


def engine_counters(engine) -> dict:
    """The unified counters surface for a serving engine (decode or
    encoder): ``queue_depth`` (requests admitted but not yet running),
    ``occupancy`` (busy decode slots / mean encoder micro-batch fill),
    ``capacity`` (slot count / flush size), ``completed``, ``evicted``
    (cancelled or deadline-evicted by the scheduler), the runtime's
    ``retraces`` / ``executables`` census (the port builds each cached
    callable once, and counts that build where JAX counts a trace), and
    the routing pair the JAX server exports: ``cluster_requests``
    (``samp_cluster_requests_total``, requests per traffic cluster at
    admission) and ``active_plans`` (``samp_active_plans``, distinct member
    fingerprints); an unrouted engine books every request under cluster 0
    and one plan."""
    rt = engine.runtime.stats
    router = getattr(engine, "router", None)
    base = {"retraces": rt["traces"], "executables": rt["executables"],
            "cluster_requests": (dict(router.requests_by_cluster)
                                 if router is not None
                                 else {0: engine._stats["requests"]}),
            "active_plans": (router.active_plans if router is not None
                             else 1)}
    sched = getattr(engine, "sched", None)
    if sched is not None:                               # decode engine
        return {"queue_depth": len(sched.queue),
                "occupancy": len(sched.live()),
                "capacity": sched.slots,
                "completed": engine._stats["retired"],
                "evicted": sched.evicted,
                "kv_cache_bytes": engine.kv_cache_bytes,
                "kv_pages_in_use": engine.kv_pages_in_use, **base}
    batcher = engine.batcher                            # encoder engine
    return {"queue_depth": len(batcher),
            "occupancy": (engine._stats["batched_rows"]
                          / max(engine._stats["batches"], 1)),
            "capacity": batcher.max_batch,
            "completed": engine._stats["retired"],
            "evicted": batcher.evicted, **base}


def latency_summary(latencies: Sequence[float], *,
                    buckets: Sequence[float] = LATENCY_BUCKETS) -> dict:
    """Quantiles + cumulative histogram for a latency sample set — the
    shape BENCH_serve.json records (and the shape the /metrics histogram
    exports, so benchmark and dashboard numbers are comparable)."""
    xs = sorted(float(x) for x in latencies)
    n = len(xs)

    def q(p: float) -> float:
        if not xs:
            return 0.0
        return xs[min(n - 1, int(round(p * (n - 1))))]

    hist = {}
    for le in buckets:
        hist[f"{le:g}"] = sum(1 for x in xs if x <= le)
    hist["+Inf"] = n
    return {"count": n,
            "p50_latency_s": q(0.50),
            "p95_latency_s": q(0.95),
            "p99_latency_s": q(0.99),
            "latency_sum_s": sum(xs),
            "latency_buckets": hist}


# ---------------------------------------------------------------------------
# Prometheus exposition primitives
# ---------------------------------------------------------------------------


def _fmt_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", r"\\").replace('"', r"\""))
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


@dataclasses.dataclass
class Counter:
    """Monotonic counter; ``inc`` is safe from any thread (one GIL-guarded
    add), reads are eventually consistent — fine for scrape-time export.
    A callback-backed counter (``fn=``) samples an externally-owned
    monotonic count at scrape time instead of double-booking it."""
    name: str
    labels: Optional[dict] = None
    value: float = 0.0
    fn: Optional[Callable[[], float]] = None

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def samples(self) -> list[tuple[str, Optional[dict], float]]:
        v = float(self.fn()) if self.fn is not None else self.value
        return [(self.name, self.labels, v)]


@dataclasses.dataclass
class Gauge:
    """Settable or callback-backed gauge; callbacks sample live state
    (scheduler queue depth, slot occupancy) at scrape time."""
    name: str
    labels: Optional[dict] = None
    value: float = 0.0
    fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def samples(self) -> list[tuple[str, Optional[dict], float]]:
        v = float(self.fn()) if self.fn is not None else self.value
        return [(self.name, self.labels, v)]


class Histogram:
    """Cumulative-bucket histogram + a bounded reservoir of recent samples
    for quantile export (`..._quantile{q="0.5|0.95|0.99"}`)."""

    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self, name: str, labels: Optional[dict] = None, *,
                 buckets: Sequence[float] = LATENCY_BUCKETS,
                 reservoir: int = 2048):
        self.name = name
        self.labels = labels
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)     # + the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self._recent: deque = deque(maxlen=reservoir)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.sum += v
            self.count += 1
            self._recent.append(v)
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self.counts[i] += 1
            self.counts[-1] += 1

    def quantile(self, q: float) -> float:
        with self._lock:
            xs = sorted(self._recent)
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]

    def samples(self) -> list[tuple[str, Optional[dict], float]]:
        base = dict(self.labels or {})
        out = []
        with self._lock:
            counts, total, s = list(self.counts), self.count, self.sum
        acc = 0
        for le, c in zip(self.buckets, counts):
            acc += c
            out.append((f"{self.name}_bucket",
                        {**base, "le": f"{le:g}"}, float(acc)))
        out.append((f"{self.name}_bucket", {**base, "le": "+Inf"},
                    float(total)))
        out.append((f"{self.name}_sum", base or None, s))
        out.append((f"{self.name}_count", base or None, float(total)))
        for q in self.QUANTILES:
            out.append((f"{self.name}_quantile",
                        {**base, "q": f"{q:g}"}, self.quantile(q)))
        return out


class MetricsRegistry:
    """Named metric families -> Prometheus text. One family may hold many
    label-sets (e.g. ``samp_queue_depth{engine="decode"|"encoder"}``);
    re-registering the same (name, labels) returns the existing metric."""

    def __init__(self):
        self._families: dict[str, dict] = {}    # name -> {"type", "help",
        self._lock = threading.Lock()           #          "metrics": {key}}

    def _register(self, kind: str, cls, name: str, help: str,
                  labels: Optional[dict], **kw):
        key = _fmt_labels(labels)
        with self._lock:
            fam = self._families.setdefault(
                name, {"type": kind, "help": help, "metrics": {}})
            if key not in fam["metrics"]:
                fam["metrics"][key] = cls(name, labels, **kw)
            return fam["metrics"][key]

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None,
                fn: Optional[Callable[[], float]] = None) -> Counter:
        c = self._register("counter", Counter, name, help, labels)
        if fn is not None:
            c.fn = fn
        return c

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._register("gauge", Gauge, name, help, labels)
        if fn is not None:
            g.fn = fn
        return g

    def register(self, metric, kind: str, help: str = ""):
        """Adopt an externally-created metric (e.g. a front-end's latency
        Histogram) into this registry's exposition output."""
        with self._lock:
            fam = self._families.setdefault(
                metric.name, {"type": kind, "help": help, "metrics": {}})
            fam["metrics"][_fmt_labels(metric.labels)] = metric
        return metric

    def histogram(self, name: str, help: str = "",
                  labels: Optional[dict] = None,
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._register("histogram", Histogram, name, help, labels,
                              buckets=buckets)

    def render(self) -> str:
        """The exposition text (content type
        ``text/plain; version=0.0.4``)."""
        lines = []
        with self._lock:
            families = {n: (f["type"], f["help"], list(f["metrics"].values()))
                        for n, f in sorted(self._families.items())}
        for name, (kind, help, metrics) in families.items():
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            for m in metrics:
                for sample, labels, value in m.samples():
                    lines.append(f"{sample}{_fmt_labels(labels)} {value:g}")
        return "\n".join(lines) + "\n"
