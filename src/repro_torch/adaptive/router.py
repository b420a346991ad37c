"""Serving-time plan routing: request -> cluster -> (params, plan, runtime)
(port of ``repro.adaptive.router``).

A :class:`PlanRouter` binds a
:class:`~repro_torch.adaptive.clusters.ClusterModel` to a
:class:`~repro_torch.core.plan.PlanSet` and the per-cluster PTQ outputs:

* admission: :meth:`PlanRouter.admit` stamps ``req.cluster`` from the
  request's tokens and traffic-class tag; from there the schedulers keep
  batches cluster-pure (:class:`~repro_torch.serve.scheduler.MicroBatcher`
  queues per (bucket, cluster), :class:`SlotScheduler` admits cluster-pure
  slot batches);
* execution: :meth:`PlanRouter.bind` derives one Runtime sibling per
  cluster from the engine's runtime through ``Runtime.share(...,
  cluster=cid)``. The siblings share one callable cache and counter set,
  and their keys differ in (member fingerprint, cluster id), so a routed
  deployment holds exactly K callables per (backend, bucket). The float
  weight leaves stay shared across the K quantized trees: PTQ copies
  containers, not tensors.

Build one with :func:`build_router` (float params + PlanSet + per-cluster
stats) or ``Artifact.router`` (a v3 bundle).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from repro_torch.adaptive.clusters import ClusterModel, EmbeddingKMeans
from repro_torch.core.plan import PlanSet, PrecisionPlan


@dataclasses.dataclass
class ClusterEntry:
    """Everything one cluster needs at serve time."""
    cluster: int
    precision: PrecisionPlan
    params: dict        # quantized under the member plan
    plan: tuple         # the member plan's execution plan
    runtime: Optional[object] = None    # Runtime sibling, set by bind()


class PlanRouter:
    """Cluster assignment and per-cluster execution resources."""

    def __init__(self, cfg, cluster_model: ClusterModel, planset: PlanSet,
                 entries: Mapping[int, ClusterEntry]):
        want, have = set(planset.cluster_ids), set(entries)
        if want != have:
            raise ValueError(f"entries {sorted(have)} do not match planset "
                             f"clusters {sorted(want)}")
        if cluster_model.num_clusters != len(planset):
            raise ValueError(
                f"cluster model yields {cluster_model.num_clusters} "
                f"clusters, planset has {len(planset)} members")
        self.cfg = cfg
        self.model = cluster_model
        self.planset = planset
        self.entries = dict(entries)
        # the samp_cluster_requests_total surface: admission-time counts
        self.requests_by_cluster = {c: 0 for c in planset.cluster_ids}

    @property
    def num_clusters(self) -> int:
        return len(self.planset)

    @property
    def active_plans(self) -> int:
        """Distinct member-plan fingerprints (K clusters may share plan
        content)."""
        return len({e.precision.fingerprint()
                    for e in self.entries.values()})

    def assign(self, tokens, *, traffic_class: Optional[str] = None) -> int:
        """Cluster id for one request; unknown ids fall to the default."""
        cid = int(self.model.assign(tokens, traffic_class=traffic_class))
        return cid if cid in self.entries else self.planset.default

    def admit(self, req) -> int:
        """Stamp ``req.cluster`` at admission (encoder ``tokens`` or decode
        ``prompt``) and count it."""
        tokens = getattr(req, "tokens", None)
        if tokens is None:
            tokens = req.prompt
        cid = self.assign(tokens,
                          traffic_class=getattr(req, "traffic_class", None))
        req.cluster = cid
        self.requests_by_cluster[cid] += 1
        return cid

    def entry(self, cluster: int) -> ClusterEntry:
        return self.entries.get(int(cluster),
                                self.entries[self.planset.default])

    def bind(self, runtime) -> "PlanRouter":
        """One Runtime sibling per cluster from ``runtime``, all sharing its
        callable cache; keys differ per (member fingerprint, cluster)."""
        for cid, e in self.entries.items():
            e.runtime = runtime.share(e.plan, precision=e.precision,
                                      cluster=cid)
        return self

    @property
    def bound(self) -> bool:
        return all(e.runtime is not None for e in self.entries.values())

    def uniform_kv(self) -> bool:
        """True when every member plan names the same per-layer KV-cache
        schemes, which the decode engine's shared caches require."""
        schemes = {e.precision.kv_schemes for e in self.entries.values()}
        return len(schemes) == 1

    def describe(self) -> str:
        return (f"router {self.model.describe()} "
                f"planset={self.planset.fingerprint()[:12]} "
                f"plans={self.active_plans}")


def _stats_for(stats: Mapping, cid: int, default: int):
    """Per-cluster stats: a cluster-keyed dict ({int: layer-stats}) serves
    each member its own slice (unseen clusters borrow the default
    cluster's); a flat layer-keyed dict is shared by every member."""
    if stats and all(isinstance(k, int) for k in stats):
        if cid in stats:
            return stats[cid]
        if default in stats:
            return stats[default]
        return stats[sorted(stats)[0]]
    return stats


def build_router(cfg, params: dict, planset: PlanSet, stats: Mapping, *,
                 cluster_model: ClusterModel, scheme=None, float_plan=None,
                 backend=None) -> PlanRouter:
    """Quantize ``params`` (float) once per member plan under that
    cluster's calibration stats and assemble the router. ``stats`` is the
    cluster-keyed dict from ``capture_stats(clusters=...)`` or a flat
    stats dict shared by every member. ``backend`` is the compute backend
    an EmbeddingKMeans model's admission embedder runs on."""
    from repro_torch.models import transformer as T
    from repro_torch.quant import ptq
    scheme = scheme if scheme is not None else T.QuantScheme()
    entries = {}
    for cid, precision in planset:
        qparams, plan = ptq.apply_plan(
            params, cfg, precision, _stats_for(stats, cid, planset.default),
            scheme=scheme, float_plan=float_plan)
        entries[cid] = ClusterEntry(cid, precision, qparams, plan)
    router = PlanRouter(cfg, cluster_model, planset, entries)
    bind_embedder(router, params, backend=backend)
    return router


def bind_embedder(router: PlanRouter, params: dict, *, backend=None) -> None:
    """Give an EmbeddingKMeans model its host-side embedding function: the
    deployment's own embedding table (never quantized, so any member's
    params would do), through ``backend``."""
    from repro_torch.adaptive.calibrate import single_row_embedder
    model = router.model
    if not isinstance(model, EmbeddingKMeans) or model._embed is not None:
        return
    model.bind(single_row_embedder(params, router.cfg, backend))
