"""The one-call SAMP facade: the paper's workflow as a fluent object (port
of ``repro.toolkit.samp``).

    samp = SAMP.from_config("bert-base", task="tnews", latency="wallclock")
    samp.pipeline.init_params(torch.Generator("cuda").manual_seed(0))
    report = samp.autotune()        # calibrate -> sweep -> recommend -> apply
    samp.save("bundle/")            # deployable artifact, no re-calibration
    server = SAMP.load("bundle/", backend="fused").serve()

Everything here delegates: :class:`~repro_torch.core.samp.SAMPEngine` is
the behavioral core (calibrate/sweep/recommend/apply are its methods); the
facade contributes the Pipeline wiring, the latency-backend resolution
(bound to the pipeline's compute backend and device, so ``wallclock`` times
the kernels that deploy), artifact persistence, and a serving handoff.

Input-adaptive precision (``calibrate(clusters=)``, ``apply_planset``,
plan-set files, ``autotune(clusters=)``) deploys a PlanSet through a
:class:`~repro_torch.adaptive.PlanRouter`, saved as a v3 bundle.
``serve_http`` wraps the serving engine in the HTTP/SSE front-end.
``finetune`` trains the float pipeline with :mod:`repro_torch.train`.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Sequence, Union

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import (PlanSet, PrecisionPlan, as_plan,
                                   load_plan_or_planset)
from repro_torch.core.precision import EncoderPolicy
from repro_torch.core.samp import SAMPEngine, SAMPResult, SweepPoint
from repro_torch.data.pipeline import get_batch
from repro_torch.distributed.sharding import mesh_fingerprint
from repro_torch.kernels.backend import get_backend
from repro_torch.models import transformer as T
from repro_torch.toolkit import artifact as A
from repro_torch.toolkit.latency import LatencyBackend
from repro_torch.toolkit.pipeline import Pipeline
from repro_torch.toolkit.registry import get_latency_backend, get_target
from repro_torch.train import AdamW, TrainConfig, Trainer, TrainState

if TYPE_CHECKING:
    from repro_torch.serve import EncoderServeEngine, ServeEngine


@dataclasses.dataclass
class AutotuneReport:
    """What autotune measured and what it chose."""
    points: list[SweepPoint]
    recommendations: list[SAMPResult]
    chosen: SAMPResult
    accuracy: float                      # deployed dev accuracy, re-measured
    artifact_path: Optional[str] = None
    strategy: str = "prefix_grid"
    # adaptive (clusters=) autotune only: the deployed PlanSet and the
    # per-cluster search record {cid: (points, recommendations, chosen)};
    # the flat fields above then describe the default cluster's search
    planset: Optional[PlanSet] = None
    per_cluster: Optional[dict] = None

    @property
    def plan(self) -> PrecisionPlan:
        """The deployed PrecisionPlan (serializable; ``plan.save(path)``)."""
        return self.chosen.point.plan

    def table(self) -> str:
        base = self.points[0]
        lines = ["mode             k  accuracy  speedup"]
        for pt in self.points:
            lines.append(f"{pt.mode_name:15s} {pt.k:2d}  {pt.accuracy:.4f}"
                         f"    {base.latency / pt.latency:.3f}x")
        return "\n".join(lines)

    def summary(self) -> str:
        """One line per recommended candidate family, naming the
        candidate's PrecisionPlan via its ``describe()`` string."""
        lines = []
        for rec in self.recommendations:
            r = rec.recommendation
            lines.append(
                f"SAMP recommends [{rec.mode_name}]: k={rec.point.k} "
                f"plan={rec.plan.describe()} "
                f"accuracy={r.accuracy:.4f} (drop {r.accuracy_drop:+.4f}) "
                f"speedup={r.speedup:.3f}x")
        return "\n".join(lines)


class SAMP:
    """End-to-end self-adaptive mixed-precision for one model + task."""

    def __init__(self, pipeline: Pipeline, *,
                 latency: Union[str, LatencyBackend] = "roofline",
                 latency_batch: int = 32):
        self.pipeline = pipeline
        self.engine = SAMPEngine(pipeline.cfg, pipeline.scheme,
                                 float_dtype=pipeline.policy.float_dtype)
        self.latency = (get_latency_backend(latency)() if isinstance(
            latency, str) else latency)
        self.latency_batch = latency_batch
        self.stats: Optional[dict] = None
        self.points: Optional[list[SweepPoint]] = None
        self.quantized: Optional[Pipeline] = None
        # input-adaptive precision (repro_torch.adaptive): set by
        # calibrate(clusters=...) / apply_planset / autotune(clusters=...)
        self.cluster_model = None
        self.planset: Optional[PlanSet] = None
        self.router = None
        # True for facades rebuilt from an artifact: the bundle holds only
        # the quantized params, so the tuning workflow has no float model
        # to operate on — predict/eval/serve only.
        self.deploy_only = False

    # -- construction --------------------------------------------------------
    @classmethod
    def from_config(cls, arch: Union[str, ArchConfig], *,
                    task: Optional[str] = None, target: Optional[str] = None,
                    n_out: Optional[int] = None, seq_len: int = 64,
                    float_dtype: str = "bfloat16",
                    scheme: T.QuantScheme = T.QuantScheme(),
                    latency: Union[str, LatencyBackend] = "roofline",
                    latency_batch: int = 32, tokenizer=None,
                    backend="reference",
                    device: Union[str, torch.device] = "cuda",
                    mesh=None) -> "SAMP":
        """Build the float pipeline for ``arch`` (a registry name or an
        explicit ArchConfig) on ``task`` and wrap it in the facade.
        ``backend`` names the compute backend quantized blocks execute on
        (reference | fused | auto — repro_torch.kernels.backend) and
        ``device`` where everything runs (``"cuda"``, an error without a
        card, or ``"cpu"``); both follow the pipeline through
        ``apply``/``autotune`` into serving, as does ``mesh``, the serving
        mesh its predictions run on."""
        cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
        if task is None:
            task = get_target(target).default_task if target else "tnews"
        pipe = Pipeline.build(cfg, task, target=target, n_out=n_out,
                              seq_len=seq_len, float_dtype=float_dtype,
                              scheme=scheme, tokenizer=tokenizer,
                              backend=backend, device=device, mesh=mesh)
        return cls(pipe, latency=latency, latency_batch=latency_batch)

    @classmethod
    def load(cls, directory: str, *,
             latency: Union[str, LatencyBackend] = "roofline",
             backend="reference",
             device: Union[str, torch.device] = "cuda",
             mesh=None) -> "SAMP":
        """Reload a saved artifact: the quantized pipeline is ready to
        predict/serve immediately — no calibration batches needed. The
        compute backend, the device and the serving mesh are deployment
        choices, not part of the artifact: pick them at load time."""
        art = A.load_artifact(directory, device=device)
        qpipe = art.pipeline(backend=backend, mesh=mesh)
        samp = cls(qpipe, latency=latency)
        samp.stats = art.stats
        samp.quantized = qpipe
        samp.deploy_only = True
        if art.adaptive:
            # v3: rebuild the router (K quantized trees from the stored
            # float tree) so serve() comes back input-adaptive; predict()
            # runs the default member
            samp.planset = art.planset
            samp.cluster_model = art.cluster_model
            samp.router = art.router(backend=qpipe.backend)
        return samp

    # -- convenience state ---------------------------------------------------
    @property
    def cfg(self) -> ArchConfig:
        return self.pipeline.cfg

    @property
    def task(self):
        return self.pipeline.task

    @property
    def current(self) -> Pipeline:
        """The pipeline a caller should run: quantized when one exists."""
        return self.quantized or self.pipeline

    def predict(self, batch):
        return self.current.predict(batch)

    def eval(self, **kw) -> float:
        return self.current.eval(**kw)

    # -- step 0: fine-tune ---------------------------------------------------
    def finetune(self, *, steps: int = 120, lr: float = 2e-3,
                 batch_size: int = 32, log_every: int = 0, seed: int = 0,
                 log=print) -> "SAMP":
        """Fine-tune the float pipeline on its task from a fresh init from
        ``seed``, on the pipeline's device, through ``Trainer.fit``; the
        loss computes in the plan's ``float_dtype``."""
        if self.deploy_only:
            self._require_params()          # raises the deploy-only error
        pipe = self.pipeline
        tcfg = TrainConfig(steps=steps, log_every=log_every or steps + 1,
                           compute_dtype=pipe.policy.float_dtype,
                           remat=False)
        trainer = Trainer(self.cfg, self.engine.float_precision,
                          optimizer=AdamW(lr=lr), tcfg=tcfg,
                          scheme=pipe.scheme, loss_fn=pipe.loss_fn(),
                          device=pipe.device)
        params = pipe.init_params(
            torch.Generator(pipe.device).manual_seed(seed))
        state = TrainState(params, trainer.optimizer.init(params), None)
        state = trainer.fit(
            state, lambda i: get_batch(self.task, i, batch_size), log=log)
        pipe.params = state.params
        # new weights invalidate everything measured on the old ones
        self.stats = None
        self.points = None
        self.quantized = None
        return self

    def _require_params(self) -> dict:
        if self.deploy_only:
            raise ValueError(
                "a facade rebuilt from an artifact bundle is deploy-only "
                "(the bundle holds just the quantized params): predict/"
                "eval/serve are available, but finetune/calibrate/sweep/"
                "apply need the float model — build one with "
                "SAMP.from_config")
        if self.pipeline.params is None:
            raise ValueError("pipeline has no params: call finetune(), "
                             "pipeline.init_params(), bind params, or "
                             "SAMP.load()")
        return self.pipeline.params

    # -- step 1: calibration -------------------------------------------------
    def calibrate(self, batches: Optional[Sequence[dict]] = None, *,
                  num_batches: int = 4, batch_size: int = 16,
                  calibrator: Optional[str] = None,
                  precision: Optional[PrecisionPlan] = None,
                  clusters=None, batch_classes=None, **kw) -> dict:
        """Observe activation ranges. Default batches come from the task's
        training stream (disjoint indices from fine-tuning).

        ``calibrator`` names one of the four PTQ calibrators
        (minmax/percentile/mse/entropy) for every site; ``precision``
        instead honors a plan's per-block calibrator choices. Default:
        min-max everywhere (paper §4.1).

        ``clusters`` (a :class:`repro_torch.adaptive.ClusterModel`)
        switches to cluster-conditional calibration: the model is fitted
        where it needs fitting (EmbeddingKMeans, on the pipeline's compute
        backend), every batch row is assigned a cluster, and the stats are
        keyed ``{cluster: {layer: {site: amax}}}``. Without explicit
        batches a synthetic stream covering every cluster is generated
        (task batches are fixed-width, so LengthBuckets would see one bin).
        ``batch_classes`` tags each batch with a traffic class (for
        :class:`~repro_torch.adaptive.TaskLabel`)."""
        params = self._require_params()
        if batches is None:
            if clusters is not None:
                from repro_torch.adaptive import clustered_synthetic_batches
                batches, batch_classes = clustered_synthetic_batches(
                    self.cfg, clusters,
                    batches_per_cluster=max(
                        1, num_batches // clusters.num_clusters),
                    batch_size=batch_size, max_len=self.task.seq_len)
            else:
                batches = [self.pipeline._model_inputs(
                    get_batch(self.task, 999 + i, batch_size))
                    for i in range(num_batches)]
        if clusters is not None:
            from repro_torch.adaptive import batch_clusters, fit_cluster_model
            fit_cluster_model(clusters, params, batches, self.cfg,
                              backend=self.pipeline.backend)
            kw["clusters"] = batch_clusters(clusters, batches,
                                            batch_classes=batch_classes)
            self.cluster_model = clusters
        # on a serving mesh the batches split over its ranks
        kw.setdefault("mesh", self.pipeline.mesh)
        self.stats = self.engine.calibrate(params, batches,
                                           calibrator=calibrator,
                                           precision=precision, **kw)
        # sweep results and applied quantization depended on the old stats
        self.points = None
        self.quantized = None
        self.planset = None
        self.router = None
        return self.stats

    @property
    def _clustered(self) -> bool:
        """True when the current stats are cluster-keyed."""
        return bool(self.stats) and all(isinstance(k, int)
                                        for k in self.stats)

    def _default_stats(self) -> dict:
        """The flat {layer: {site: amax}} view single-plan paths consume:
        the default cluster's slice when stats are cluster-keyed."""
        if not self._clustered:
            return self.stats
        d = (self.planset.default if self.planset is not None
             else sorted(self.stats)[0])
        return self.stats.get(d, self.stats[sorted(self.stats)[0]])

    # -- step 2: search --------------------------------------------------------
    def sweep(self, *, strategy: str = "prefix_grid", stride: int = 1,
              eval_batches: int = 3, eval_batch_size: int = 64, modes=None,
              **strategy_kw) -> list[SweepPoint]:
        """Measure (accuracy, latency) over a search strategy's candidates
        (default: the paper's prefix grid; see ``SEARCH_STRATEGIES``)."""
        params = self._require_params()
        if self.stats is None:
            self.calibrate()
        eval_fn, latency_fn = self._search_fns(eval_batches, eval_batch_size)
        kw = dict(strategy_kw)
        if strategy in ("prefix_grid", "latency_budget"):
            kw["stride"] = stride
            if modes is not None:
                kw["modes"] = modes
        self.points = self.engine.search(strategy, params,
                                         self._default_stats(),
                                         eval_fn, latency_fn, **kw)
        return self.points

    def _search_fns(self, eval_batches: int, eval_batch_size: int):
        """(eval_fn, latency_fn) pair every search strategy consumes; the
        latency backend is bound to the pipeline's compute backend and
        device."""

        def eval_fn(qp, plan, pol):
            return self.pipeline.with_policy(qp, plan, pol).eval(
                batches=eval_batches, batch_size=eval_batch_size)

        latency_fn = self.latency.bind(
            self.cfg, batch=self.latency_batch, seq=self.task.seq_len,
            scheme=self.pipeline.scheme, backend=self.pipeline.backend,
            device=self.pipeline.device)
        return eval_fn, latency_fn

    # -- step 3: recommend -----------------------------------------------------
    def recommend(self, *, max_latency: Optional[float] = None,
                  min_accuracy: Optional[float] = None) -> list[SAMPResult]:
        if self.points is None:
            raise ValueError("no sweep points yet: call sweep() or "
                             "autotune()")
        return self.engine.recommend(self.points, max_latency=max_latency,
                                     min_accuracy=min_accuracy)

    # -- step 4: apply ---------------------------------------------------------
    def apply(self, policy: Union[PrecisionPlan, EncoderPolicy]) -> Pipeline:
        """Quantize under a PrecisionPlan (or an EncoderPolicy, converted
        through the shim) and bind the deployable pipeline."""
        params = self._require_params()
        if self.stats is None:
            self.calibrate()
        precision = as_plan(policy,
                            dynamic_acts=self.pipeline.scheme.dynamic_acts)
        qparams, qplan = self.engine.apply(params, self._default_stats(),
                                           precision)
        self.quantized = self.pipeline.with_policy(qparams, qplan, precision)
        return self.quantized

    def apply_planset(self, planset: PlanSet):
        """Deploy a :class:`~repro_torch.core.plan.PlanSet`: quantize the
        float tree once per member under that cluster's calibration stats
        and build the :class:`~repro_torch.adaptive.PlanRouter` serving
        routes through. The default member also binds as
        ``self.quantized``, so ``predict()``/``eval()`` keep working
        unrouted. Needs ``calibrate(clusters=...)`` first."""
        params = self._require_params()
        if self.cluster_model is None or not self._clustered:
            raise ValueError(
                "apply_planset needs cluster-conditional calibration: call "
                "calibrate(clusters=<ClusterModel>) first")
        if self.cluster_model.num_clusters != len(planset):
            raise ValueError(
                f"cluster model yields {self.cluster_model.num_clusters} "
                f"clusters but the planset has {len(planset)} members")
        from repro_torch.adaptive import build_router
        self.router = build_router(self.cfg, params, planset, self.stats,
                                   cluster_model=self.cluster_model,
                                   scheme=self.pipeline.scheme,
                                   float_plan=self.engine.float_plan,
                                   backend=self.pipeline.backend)
        self.planset = planset
        d = self.router.entry(planset.default)
        self.quantized = self.pipeline.with_policy(d.params, d.plan,
                                                   d.precision)
        return self.router

    def apply_plan_file(self, path: str) -> Pipeline:
        """Load a saved ``plan.json`` or ``planset.json`` and deploy it:
        plan sets route, single plans bind directly."""
        loaded = load_plan_or_planset(path)
        if isinstance(loaded, PrecisionPlan):
            return self.apply(loaded)
        self.apply_planset(loaded)
        return self.quantized

    # -- the one call ----------------------------------------------------------
    def autotune(self, *, strategy: str = "prefix_grid",
                 max_latency: Optional[float] = None,
                 min_accuracy: Optional[float] = None,
                 prefer: Optional[str] = None, stride: int = 1,
                 eval_batches: int = 3, eval_batch_size: int = 64,
                 save_to: Optional[str] = None, clusters=None,
                 **strategy_kw) -> AutotuneReport:
        """calibrate -> search -> allocator recommend -> apply, one call.

        ``strategy`` names a registered search strategy (``prefix_grid`` —
        the paper's grid, ``greedy`` — per-layer sensitivity subsets,
        ``latency_budget`` — the grid pruned to a latency ceiling).
        ``prefer`` picks which candidate family's recommendation to deploy
        when the allocator returns one per family (default: Quant-FFN-Only
        when the strategy produced it — the paper's preferred configuration
        — else the first family); thresholds flow to the Appendix-A
        policies. ``save_to`` additionally writes the deployable artifact
        bundle (the chosen plan itself is ``report.plan``). Sweep points
        cached by an earlier sweep()/autotune() on the same weights+stats
        are reused (so ``strategy``/``stride``/``eval_*`` only apply to a
        fresh search); calibrate() invalidates the cache.

        ``clusters`` (a :class:`repro_torch.adaptive.ClusterModel`), or an
        earlier ``calibrate(clusters=...)``, switches to input-adaptive
        autotune: one search per cluster over that cluster's stats, the
        winners assembled into a PlanSet and deployed through a PlanRouter.
        The report's flat fields then describe the default cluster;
        ``report.planset`` and ``report.per_cluster`` the whole."""
        self._require_params()
        if clusters is not None:
            self.calibrate(clusters=clusters)
        elif self.stats is None:
            self.calibrate()
        if self._clustered:
            return self._autotune_adaptive(
                strategy=strategy, max_latency=max_latency,
                min_accuracy=min_accuracy, prefer=prefer, stride=stride,
                eval_batches=eval_batches, eval_batch_size=eval_batch_size,
                save_to=save_to, **strategy_kw)
        if self.points is None:
            if strategy == "latency_budget" and max_latency is not None:
                strategy_kw.setdefault("max_latency", max_latency)
            self.sweep(strategy=strategy, stride=stride,
                       eval_batches=eval_batches,
                       eval_batch_size=eval_batch_size, **strategy_kw)
        recs = self.recommend(max_latency=max_latency,
                              min_accuracy=min_accuracy)
        if not recs:
            raise ValueError("the search produced no quantized candidates "
                             "to recommend from")
        if prefer is None:
            chosen = next((r for r in recs
                           if r.mode_name == "quant_ffn_only"), recs[0])
        else:
            chosen = next((r for r in recs if r.mode_name == prefer), None)
            if chosen is None:
                raise KeyError(
                    f"prefer={prefer!r} matches no recommended mode;"
                    f" have {[r.mode_name for r in recs]}")
        pipe = self.apply(chosen.point.plan)
        acc = pipe.eval(batches=eval_batches, batch_size=eval_batch_size)
        path = self.save(save_to) if save_to else None
        return AutotuneReport(points=self.points, recommendations=recs,
                              chosen=chosen, accuracy=acc,
                              artifact_path=path, strategy=strategy)

    def _autotune_adaptive(self, *, strategy: str, max_latency, min_accuracy,
                           prefer, stride: int, eval_batches: int,
                           eval_batch_size: int, save_to,
                           **strategy_kw) -> AutotuneReport:
        """The clusters= branch of autotune: one search per cluster ->
        PlanSet -> router deployment."""
        from repro_torch.adaptive import autotune_planset
        params = self._require_params()
        eval_fn, latency_fn = self._search_fns(eval_batches, eval_batch_size)
        kw = dict(strategy_kw)
        if strategy in ("prefix_grid", "latency_budget"):
            kw["stride"] = stride
            if strategy == "latency_budget" and max_latency is not None:
                kw.setdefault("max_latency", max_latency)
        planset, details = autotune_planset(
            self.engine, params, self.stats, eval_fn=eval_fn,
            latency_fn=latency_fn, strategy=strategy,
            max_latency=max_latency, min_accuracy=min_accuracy,
            prefer=prefer, **kw)
        # clusters the calibration stream never observed borrow the default
        # member: the set must cover every cluster the model can emit
        missing = (set(range(self.cluster_model.num_clusters))
                   - set(planset.cluster_ids))
        if missing:
            fallback = planset.plan_for(planset.default)
            planset = PlanSet(planset.members
                              + tuple((c, fallback) for c in sorted(missing)),
                              default=planset.default)
        self.apply_planset(planset)
        acc = self.quantized.eval(batches=eval_batches,
                                  batch_size=eval_batch_size)
        path = self.save(save_to) if save_to else None
        d_points, d_recs, d_chosen = details[min(details)]
        self.points = d_points
        return AutotuneReport(points=d_points, recommendations=d_recs,
                              chosen=d_chosen, accuracy=acc,
                              artifact_path=path, strategy=strategy,
                              planset=planset, per_cluster=details)

    # -- persistence / serving ---------------------------------------------------
    def save(self, directory: str) -> str:
        """Write the deployed pipeline as an artifact bundle: v2 (quantized
        params + plan + stats) for a single plan, v3 (float params +
        PlanSet + cluster model + per-cluster stats) when a plan set is
        deployed."""
        if self.quantized is None:
            raise ValueError("nothing to save: call autotune() or apply() "
                             "first")
        if self.stats is None:
            raise ValueError("missing calibration stats")
        if self.planset is not None:
            return A.save_adaptive_artifact(
                directory, cfg=self.cfg, planset=self.planset,
                cluster_model=self.cluster_model, cluster_stats=self.stats,
                float_params=self.pipeline.params,
                scheme=self.pipeline.scheme, task=self.task,
                target=self.pipeline.target.spec.name,
                n_out=self.pipeline.target.n_out,
                tokenizer=self.pipeline.tokenizer.tokenizer)
        return A.save_artifact(
            directory, cfg=self.cfg, policy=self.quantized.precision,
            stats=self.stats, params=self.quantized.params,
            scheme=self.pipeline.scheme, task=self.task,
            target=self.pipeline.target.spec.name,
            n_out=self.pipeline.target.n_out,
            tokenizer=self.pipeline.tokenizer.tokenizer)

    def serve(self, *, batch_slots: int = 4, max_len: int = 256,
              **kw) -> Union[ServeEngine, EncoderServeEngine]:
        """Hand the current (quantized if available) pipeline to a serving
        engine, dispatching on the workload: decode-capable configs with an
        LM target get the token-level continuous-batching engine;
        encoder-only configs (and any non-LM target head) get the
        micro-batching encoder engine, which shares the pipeline's runtime,
        so predict() and serving hit one callable cache. ``batch_slots``
        sets the slot count (decode) / the micro-batch flush size
        (encoder). ``backend=`` / ``mesh=`` override the pipeline's compute
        backend / serving mesh for this server (both engine types). Decode
        engines additionally take ``page_size=`` and ``kv_cache=``; a
        PrecisionPlan's per-layer ``kv_cache`` schemes apply automatically.
        A deployed PlanSet serves routed (``router=None`` opts out)."""
        # imported here: the serving engines import the toolkit's targets
        from repro_torch.serve import EncoderServeEngine, ServeEngine
        pipe = self.current
        if pipe.params is None:
            raise ValueError("pipeline has no params to serve")
        backend = kw.pop("backend", None)
        mesh = kw.pop("mesh", pipe.mesh)
        router = kw.pop("router", self.router)
        if pipe.cfg.supports_decode and pipe.target.spec.name == "lm":
            kw.setdefault("precision", pipe.precision)
            return ServeEngine(pipe.cfg, pipe.params, pipe.plan,
                               scheme=pipe.scheme, batch_slots=batch_slots,
                               max_len=max_len,
                               backend=(pipe.backend if backend is None
                                        else backend), mesh=mesh,
                               router=router, device=pipe.device, **kw)
        enc_kw = dict(target=pipe.target.spec, scheme=pipe.scheme,
                      max_batch=kw.pop("max_batch", batch_slots),
                      max_len=max_len, router=router)
        if (backend is not None
                and get_backend(backend).name != pipe.backend.name) \
                or mesh_fingerprint(mesh) != mesh_fingerprint(pipe.mesh):
            # explicit override: a fresh runtime on the requested backend or
            # topology (an equal mesh built separately compares equal by
            # fingerprint and keeps the pipeline's runtime)
            return EncoderServeEngine(pipe.cfg, pipe.params, pipe.plan,
                                      backend=(pipe.backend if backend is
                                               None else backend),
                                      device=pipe.device, mesh=mesh,
                                      **enc_kw, **kw)
        return EncoderServeEngine(pipe.cfg, pipe.params, pipe.plan,
                                  runtime=pipe.runtime, **enc_kw, **kw)

    def serve_http(self, *, host: str = "127.0.0.1", port: int = 8000,
                   max_pending: int = 64,
                   default_deadline_s: Optional[float] = None,
                   batch_slots: int = 4, max_len: int = 256,
                   log=print, **kw):
        """Wrap :meth:`serve` in the asyncio HTTP/SSE front-end
        (docs/http-serving.md): encoder pipelines mount ``POST /v1/encode``
        (JSON), decode pipelines mount ``POST /v1/generate`` (SSE token
        streaming); both get ``/metrics`` and ``/healthz``. Returns the
        unstarted :class:`~repro_torch.serve.frontend.HTTPFrontend` — call
        ``run_forever()`` (blocking, SIGTERM-drains) or ``await start()``
        inside an event loop. Engine kwargs (``backend=``, ``max_wait=``,
        ...) pass through to :meth:`serve`."""
        from repro_torch.serve import ServeEngine
        from repro_torch.serve.frontend import HTTPFrontend
        engine = self.serve(batch_slots=batch_slots, max_len=max_len, **kw)
        sides = ({"decode": engine} if isinstance(engine, ServeEngine)
                 else {"encoder": engine})
        return HTTPFrontend(host=host, port=port, max_pending=max_pending,
                            default_deadline_s=default_deadline_s, log=log,
                            **sides)
