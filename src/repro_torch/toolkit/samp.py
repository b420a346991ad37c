"""The one-call SAMP facade: the paper's workflow as a fluent object (port
of ``repro.toolkit.samp``, single-plan deployments).

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

Not ported yet, each raising ``NotImplementedError`` that names its item of
ROADMAP queue 1: ``finetune`` (item 7, training), input-adaptive precision
(``clusters=``, ``apply_planset``, plan-set files; item 4) and
``serve_http`` (item 5).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Sequence, Union

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import PrecisionPlan, as_plan, load_plan_or_planset
from repro_torch.core.precision import EncoderPolicy
from repro_torch.core.samp import SAMPEngine, SAMPResult, SweepPoint
from repro_torch.data.pipeline import get_batch
from repro_torch.kernels.backend import get_backend
from repro_torch.models import transformer as T
from repro_torch.toolkit import artifact as A
from repro_torch.toolkit.latency import LatencyBackend
from repro_torch.toolkit.pipeline import Pipeline
from repro_torch.toolkit.registry import get_latency_backend, get_target

if TYPE_CHECKING:
    from repro_torch.serve import EncoderServeEngine, ServeEngine


def _not_ported(what: str, item: int, topic: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue 1 item {item} ({topic})")


@dataclasses.dataclass
class AutotuneReport:
    """What autotune measured and what it chose."""
    points: list[SweepPoint]
    recommendations: list[SAMPResult]
    chosen: SAMPResult
    accuracy: float                      # deployed dev accuracy, re-measured
    artifact_path: Optional[str] = None
    strategy: str = "prefix_grid"

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
                    device: Union[str, torch.device] = "cuda") -> "SAMP":
        """Build the float pipeline for ``arch`` (a registry name or an
        explicit ArchConfig) on ``task`` and wrap it in the facade.
        ``backend`` names the compute backend quantized blocks execute on
        (reference | fused | auto — repro_torch.kernels.backend) and
        ``device`` where everything runs (``"cuda"``, an error without a
        card, or ``"cpu"``); both follow the pipeline through
        ``apply``/``autotune`` into serving."""
        cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
        if task is None:
            task = get_target(target).default_task if target else "tnews"
        pipe = Pipeline.build(cfg, task, target=target, n_out=n_out,
                              seq_len=seq_len, float_dtype=float_dtype,
                              scheme=scheme, tokenizer=tokenizer,
                              backend=backend, device=device)
        return cls(pipe, latency=latency, latency_batch=latency_batch)

    @classmethod
    def load(cls, directory: str, *,
             latency: Union[str, LatencyBackend] = "roofline",
             backend="reference",
             device: Union[str, torch.device] = "cuda") -> "SAMP":
        """Reload a saved artifact: the quantized pipeline is ready to
        predict/serve immediately — no calibration batches needed. The
        compute backend and the device are deployment choices, not part of
        the artifact: pick them at load time."""
        art = A.load_artifact(directory, device=device)
        qpipe = art.pipeline(backend=backend)
        samp = cls(qpipe, latency=latency)
        samp.stats = art.stats
        samp.quantized = qpipe
        samp.deploy_only = True
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
    def finetune(self, **kw) -> "SAMP":
        raise _not_ported("SAMP.finetune", 7, "train/")

    def _require_params(self) -> dict:
        if self.deploy_only:
            raise ValueError(
                "a facade rebuilt from an artifact bundle is deploy-only "
                "(the bundle holds just the quantized params): predict/"
                "eval/serve are available, but calibrate/sweep/apply need "
                "the float model — build one with SAMP.from_config")
        if self.pipeline.params is None:
            raise ValueError("pipeline has no params: call "
                             "pipeline.init_params(), bind params, or "
                             "SAMP.load()")
        return self.pipeline.params

    # -- step 1: calibration -------------------------------------------------
    def calibrate(self, batches: Optional[Sequence[dict]] = None, *,
                  num_batches: int = 4, batch_size: int = 16,
                  calibrator: Optional[str] = None,
                  precision: Optional[PrecisionPlan] = None,
                  clusters=None, **kw) -> dict:
        """Observe activation ranges. Default batches come from the task's
        training stream (disjoint indices from fine-tuning).

        ``calibrator`` names one of the four PTQ calibrators
        (minmax/percentile/mse/entropy) for every site; ``precision``
        instead honors a plan's per-block calibrator choices. Default:
        min-max everywhere (paper §4.1)."""
        if clusters is not None:
            raise _not_ported("cluster-conditional calibration (clusters=)",
                              4, "adaptive precision")
        params = self._require_params()
        if batches is None:
            batches = [self.pipeline._model_inputs(
                get_batch(self.task, 999 + i, batch_size))
                for i in range(num_batches)]
        self.stats = self.engine.calibrate(params, batches,
                                           calibrator=calibrator,
                                           precision=precision, **kw)
        # sweep results and applied quantization depended on the old stats
        self.points = None
        self.quantized = None
        return self.stats

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
        self.points = self.engine.search(strategy, params, self.stats,
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
        qparams, qplan = self.engine.apply(params, self.stats, precision)
        self.quantized = self.pipeline.with_policy(qparams, qplan, precision)
        return self.quantized

    def apply_planset(self, planset):
        raise _not_ported("SAMP.apply_planset", 4, "adaptive precision")

    def apply_plan_file(self, path: str) -> Pipeline:
        """Load a saved ``plan.json`` and deploy it (plan-set files need
        :meth:`apply_planset`)."""
        loaded = load_plan_or_planset(path)
        if isinstance(loaded, PrecisionPlan):
            return self.apply(loaded)
        return self.apply_planset(loaded)

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
        fresh search); calibrate() invalidates the cache."""
        if clusters is not None:
            raise _not_ported("autotune(clusters=)", 4,
                              "adaptive precision")
        self._require_params()
        if self.stats is None:
            self.calibrate()
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

    # -- persistence / serving ---------------------------------------------------
    def save(self, directory: str) -> str:
        """Write the deployed pipeline as a v2 artifact bundle (quantized
        params + plan + stats)."""
        if self.quantized is None:
            raise ValueError("nothing to save: call autotune() or apply() "
                             "first")
        if self.stats is None:
            raise ValueError("missing calibration stats")
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
        (encoder). ``backend=`` overrides the pipeline's compute backend
        for this server. Decode engines additionally take ``page_size=``
        and ``kv_cache=``; a PrecisionPlan's per-layer ``kv_cache`` schemes
        apply automatically."""
        # imported here: the serving engines import the toolkit's targets
        from repro_torch.serve import EncoderServeEngine, ServeEngine
        pipe = self.current
        if pipe.params is None:
            raise ValueError("pipeline has no params to serve")
        backend = kw.pop("backend", None)
        if pipe.cfg.supports_decode and pipe.target.spec.name == "lm":
            kw.setdefault("precision", pipe.precision)
            return ServeEngine(pipe.cfg, pipe.params, pipe.plan,
                               scheme=pipe.scheme, batch_slots=batch_slots,
                               max_len=max_len,
                               backend=(pipe.backend if backend is None
                                        else backend),
                               device=pipe.device, **kw)
        enc_kw = dict(target=pipe.target.spec, scheme=pipe.scheme,
                      max_batch=kw.pop("max_batch", batch_slots),
                      max_len=max_len)
        if backend is not None \
                and get_backend(backend).name != pipe.backend.name:
            # explicit override: a fresh runtime on the requested backend
            return EncoderServeEngine(pipe.cfg, pipe.params, pipe.plan,
                                      backend=backend, device=pipe.device,
                                      **enc_kw, **kw)
        return EncoderServeEngine(pipe.cfg, pipe.params, pipe.plan,
                                  runtime=pipe.runtime, **enc_kw, **kw)

    def serve_http(self, **kw):
        raise _not_ported("SAMP.serve_http", 5, "the HTTP/SSE front-end")
