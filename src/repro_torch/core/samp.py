"""The SAMP engine: calibrate → search → recommend → apply (paper §3.2;
port of ``repro.core.samp``, whole).

Ties the substrate together:

* :mod:`repro_torch.quant.ptq` turns float params + calibration stats into
  mixed-precision params for any :class:`~repro_torch.core.plan.PrecisionPlan`;
* the engine runs a *search strategy* from the :data:`SEARCH_STRATEGIES`
  registry — every strategy emits :class:`SweepPoint`\\ s carrying the
  candidate's PrecisionPlan, its measured accuracy (user-supplied dev-set
  eval) and its latency (the wall clock of the forward on the card, or the
  roofline model — both flow through the same interface):

  - ``prefix_grid``     — the paper's Table-2 candidate grid (both modes ×
    k = 0..N quantized-prefix layers), duplicates deduped;
  - ``greedy``          — beyond-paper per-layer sensitivity search:
    single-layer probes order the layers by measured accuracy cost, then
    the cumulative subsets are evaluated (allocator.greedy_subset_schedule);
  - ``latency_budget``  — the prefix grid with candidates over a latency
    ceiling skipped before the (expensive) accuracy eval;

* :mod:`repro_torch.core.allocator` (Algorithm 1 + Appendix-A thresholds)
  picks the recommended combination per candidate family;
* the chosen plan's params/execution-plan are returned ready for inference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

from repro_torch.configs.base import ArchConfig
from repro_torch.core import allocator
from repro_torch.core.plan import (LayerPlan, PrecisionPlan, QuantSpec,
                                   as_plan, plan_from_policy)
from repro_torch.core.precision import EncoderPolicy, LayerMode, paper_grid
from repro_torch.models.transformer import QuantScheme, build_plan
from repro_torch.quant import ptq

# Callbacks receive (qparams, execution_plan, precision) — ``precision`` is
# the candidate's PrecisionPlan: per-layer LayerPlans under
# ``precision.layers`` (each a per-block QuantSpec via ``.spec(block)``),
# plus ``.num_layers`` / ``.float_dtype`` / ``.describe()`` /
# ``.fingerprint()`` and the quantized-layer counts ``.num_quant_ffn`` /
# ``.num_quant_mha``.
EvalFn = Callable[[dict, tuple, PrecisionPlan], float]
LatencyFn = Callable[[dict, tuple, PrecisionPlan], float]


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One measured candidate of a search strategy. ``plan`` is the
    candidate's :class:`~repro_torch.core.plan.PrecisionPlan` — the
    declarative per-layer/per-block precision description every consumer
    speaks (``plan.describe()`` / ``plan.fingerprint()`` /
    ``plan.save(path)``).
    """
    mode_name: str            # candidate family: 'float' | 'fully_quant' |
    #                           'quant_ffn_only' | 'greedy' | ...
    k: int                    # number of quantized layers
    plan: PrecisionPlan       # the candidate's precision description
    accuracy: float
    latency: float


@dataclasses.dataclass(frozen=True)
class SAMPResult:
    mode_name: str
    point: SweepPoint
    recommendation: allocator.Recommendation

    @property
    def plan(self) -> PrecisionPlan:
        return self.point.plan


# ---------------------------------------------------------------------------
# search strategies
# ---------------------------------------------------------------------------

SEARCH_STRATEGIES: dict[str, Callable] = {}


def register_strategy(name: str):
    """Register a search strategy: ``fn(engine, params, stats, eval_fn,
    latency_fn, **kw) -> list[SweepPoint]``. The first point must be the
    float baseline; every point carries its PrecisionPlan."""
    def deco(fn):
        if name in SEARCH_STRATEGIES:
            raise KeyError(f"strategy {name!r} already registered")
        SEARCH_STRATEGIES[name] = fn
        return fn
    return deco


def get_strategy(name: str) -> Callable:
    if name not in SEARCH_STRATEGIES:
        raise KeyError(f"unknown search strategy {name!r}; have "
                       f"{sorted(SEARCH_STRATEGIES)}")
    return SEARCH_STRATEGIES[name]


def _measure(engine: "SAMPEngine", params, stats, precision: PrecisionPlan,
             eval_fn: EvalFn, latency_fn: LatencyFn) -> tuple[float, float]:
    qparams, plan = ptq.apply_plan(params, engine.cfg, precision, stats,
                                   scheme=engine.scheme,
                                   float_plan=engine.float_plan)
    return eval_fn(qparams, plan, precision), latency_fn(qparams, plan,
                                                         precision)


def int8_dataflow_variant(precision: PrecisionPlan
                          ) -> Optional[PrecisionPlan]:
    """The whole-layer int8-dataflow variant of a candidate (schema v3):
    ``softmax='uint8'`` on every layer whose attention bmms run int8, and
    ``norm='int8'`` wherever the attn_out/ffn_in blocks carry static int8
    activations — the maximal span the plan's GEMM choices support.
    Returns None when no layer is eligible (the variant would duplicate
    the base candidate)."""
    layers, changed = [], False
    for lp in precision.layers:
        sm = "uint8" if lp.qkv.quantized else None
        nm = ("int8" if all(lp.spec(b).quantized and lp.spec(b).static_acts
                            for b in ("attn_out", "ffn_in")) else None)
        nlp = lp.with_dataflow(softmax=sm, norm=nm)
        changed = changed or nlp != lp
        layers.append(nlp)
    if not changed:
        return None
    return dataclasses.replace(precision, layers=tuple(layers))


def moe_family_variant(precision: PrecisionPlan, *,
                       dynamic_acts: bool = False
                       ) -> Optional[PrecisionPlan]:
    """The per-expert ``experts``-family variant of a candidate (schema
    v4): every layer whose ffn blocks quantize additionally routes its
    expert GEMMs through int8_per_channel weights (per-expert (E, 1, F)
    scales) with per-expert activation scales. Returns None when no layer
    is eligible — a dense plan, or families already set — so the grid
    never emits duplicate candidates."""
    act = "int8_per_token" if dynamic_acts else "int8_per_tensor"
    spec = QuantSpec(weight="int8_per_channel", act=act)
    layers, changed = [], False
    for lp in precision.layers:
        if lp.ffn_in.quantized and lp.experts is None:
            layers.append(lp.with_families(experts=spec))
            changed = True
        else:
            layers.append(lp)
    if not changed:
        return None
    return dataclasses.replace(precision, layers=tuple(layers))


def _grid_candidates(engine: "SAMPEngine", stride: int,
                     modes: Sequence[LayerMode], calibrator: str,
                     dataflow: bool = False, moe_families: bool = False):
    """The paper's (mode, k) grid as (name, k, PrecisionPlan) candidates;
    ``dataflow`` doubles each eligible candidate with its whole-layer
    int8-dataflow variant (family ``<mode>+int8flow``); ``moe_families``
    (MoE configs only) adds the per-expert variant (``<mode>+experts``)."""
    for name, k, policy in paper_grid(engine.cfg.num_layers,
                                      engine.float_dtype, stride):
        if name != "float" and not any(m.value == name for m in modes):
            continue
        precision = plan_from_policy(
            policy, dynamic_acts=engine.scheme.dynamic_acts,
            calibrator=calibrator)
        yield name, k, precision
        if dataflow:
            flow = int8_dataflow_variant(precision)
            if flow is not None:
                yield name + "+int8flow", k, flow
        if moe_families and engine.cfg.moe is not None:
            moe = moe_family_variant(
                precision, dynamic_acts=engine.scheme.dynamic_acts)
            if moe is not None:
                yield name + "+experts", k, moe


@register_strategy("prefix_grid")
def prefix_grid_strategy(engine: "SAMPEngine", params, stats, eval_fn,
                         latency_fn, *, stride: int = 1,
                         modes: Sequence[LayerMode] = (
                             LayerMode.FULLY_QUANT,
                             LayerMode.QUANT_FFN_ONLY),
                         calibrator: str = "minmax",
                         dataflow: bool = False,
                         moe_families: bool = False) -> list[SweepPoint]:
    """The paper's Table-2 grid: both modes × every quantized-prefix depth
    (dedupe in :func:`paper_grid` drops the k=0 duplicates). ``dataflow``
    adds the whole-layer int8-dataflow variant of each eligible candidate
    to the search space (schema-v3 softmax/norm schemes); ``moe_families``
    adds the per-expert schema-v4 variant on MoE configs."""
    points: list[SweepPoint] = []
    for name, k, precision in _grid_candidates(engine, stride, modes,
                                               calibrator, dataflow,
                                               moe_families):
        acc, lat = _measure(engine, params, stats, precision, eval_fn,
                            latency_fn)
        points.append(SweepPoint(name, k, precision, acc, lat))
    return points


@register_strategy("greedy")
def greedy_strategy(engine: "SAMPEngine", params, stats, eval_fn, latency_fn,
                    *, mode: LayerMode = LayerMode.QUANT_FFN_ONLY,
                    calibrator: str = "minmax",
                    max_layers: Optional[int] = None) -> list[SweepPoint]:
    """Greedy per-layer sensitivity search (beyond-paper: *which* layers,
    not just how many). Probes each layer alone, orders layers by measured
    accuracy cost via :func:`allocator.greedy_subset_schedule`, then
    re-measures every cumulative subset honestly."""
    n = engine.cfg.num_layers
    layer = LayerPlan.for_mode(mode, dynamic_acts=engine.scheme.dynamic_acts,
                               calibrator=calibrator)
    base = PrecisionPlan.full_float(n, engine.float_dtype)
    base_acc, base_lat = _measure(engine, params, stats, base, eval_fn,
                                  latency_fn)
    points = [SweepPoint("float", 0, base, base_acc, base_lat)]

    probe_acc, probe_gain = [], []
    for j in range(n):
        pj = PrecisionPlan.subset(n, [j], layer, engine.float_dtype)
        acc_j, lat_j = _measure(engine, params, stats, pj, eval_fn,
                                latency_fn)
        probe_acc.append(acc_j)
        probe_gain.append(base_lat - lat_j)

    schedule = allocator.greedy_subset_schedule(probe_acc, base_acc,
                                                probe_gain, base_lat)
    limit = max_layers if max_layers is not None else n
    for step in schedule[1:limit + 1]:
        ps = PrecisionPlan.subset(n, step.layers, layer, engine.float_dtype)
        acc, lat = _measure(engine, params, stats, ps, eval_fn, latency_fn)
        points.append(SweepPoint("greedy", len(step.layers), ps, acc, lat))
    return points


@register_strategy("latency_budget")
def latency_budget_strategy(engine: "SAMPEngine", params, stats, eval_fn,
                            latency_fn, *, max_latency: float,
                            stride: int = 1,
                            modes: Sequence[LayerMode] = (
                                LayerMode.FULLY_QUANT,
                                LayerMode.QUANT_FFN_ONLY),
                            calibrator: str = "minmax",
                            dataflow: bool = False) -> list[SweepPoint]:
    """Budgeted prefix-grid search: candidates whose latency exceeds
    ``max_latency`` are dropped *before* the expensive work. Analytic
    backends (roofline) price a candidate from its plan alone, so
    over-budget candidates skip even the PTQ weight quantization; measured
    backends (wallclock) need the quantized params, so those prune after
    quantization but still before the accuracy eval. A latency callable
    is analytic when its ``analytic`` attribute is true (the roofline's
    ``bind`` sets it); any other is measured. The float baseline is
    always measured (the allocator's anchor) even when it is itself over
    budget."""
    analytic = getattr(latency_fn, "analytic", False)
    points: list[SweepPoint] = []
    for name, k, precision in _grid_candidates(engine, stride, modes,
                                               calibrator, dataflow):
        # param-free probe: analytic backends ignore (qparams, plan)
        lat = latency_fn(None, None, precision) if analytic else None
        if lat is not None and name != "float" and lat > max_latency:
            continue
        qparams, plan = ptq.apply_plan(params, engine.cfg, precision, stats,
                                       scheme=engine.scheme,
                                       float_plan=engine.float_plan)
        if lat is None:
            lat = latency_fn(qparams, plan, precision)
            if name != "float" and lat > max_latency:
                continue
        acc = eval_fn(qparams, plan, precision)
        points.append(SweepPoint(name, k, precision, acc, lat))
    return points


class SAMPEngine:
    """End-to-end self-adaptive mixed-precision search for one model."""

    def __init__(self, cfg: ArchConfig, scheme: QuantScheme = QuantScheme(),
                 float_dtype: str = "bfloat16"):
        self.cfg = cfg
        self.scheme = scheme
        self.float_dtype = float_dtype
        self.float_precision = PrecisionPlan.full_float(cfg.num_layers,
                                                        float_dtype)
        self.float_plan = build_plan(cfg, self.float_precision)

    # -- step 1: calibration ------------------------------------------------
    def calibrate(self, params: dict, batches: Sequence[dict], *,
                  calibrator: Optional[str] = None,
                  precision: Optional[PrecisionPlan] = None, **kw):
        """Observe activation ranges on calibration batches. ``calibrator``
        names one calibrator for every site (paper §4.1 uses min-max);
        ``precision`` honors a plan's per-block calibrator choices."""
        return ptq.capture_stats(params, batches, self.cfg, self.float_plan,
                                 self.scheme, calibrator=calibrator,
                                 precision=precision, **kw)

    # -- step 2: candidate search -------------------------------------------
    def search(self, strategy: str, params: dict, stats: dict,
               eval_fn: EvalFn, latency_fn: LatencyFn,
               **kw) -> list[SweepPoint]:
        """Run a registered search strategy; every returned point carries
        its candidate :class:`PrecisionPlan` (``point.plan``)."""
        return get_strategy(strategy)(self, params, stats, eval_fn,
                                      latency_fn, **kw)

    def sweep(self, params: dict, stats: dict, eval_fn: EvalFn,
              latency_fn: LatencyFn, *, stride: int = 1,
              modes: Sequence[LayerMode] = (LayerMode.FULLY_QUANT,
                                            LayerMode.QUANT_FFN_ONLY),
              ) -> list[SweepPoint]:
        """The paper's grid — shorthand for ``search("prefix_grid", ...)``.
        Candidate ('float', 0) is always first."""
        return self.search("prefix_grid", params, stats, eval_fn, latency_fn,
                           stride=stride, modes=modes)

    # -- step 3: recommendation ----------------------------------------------
    @staticmethod
    def recommend(points: Sequence[SweepPoint], *,
                  max_latency: Optional[float] = None,
                  min_accuracy: Optional[float] = None) -> list[SAMPResult]:
        """Run the accuracy-decay-aware allocator per candidate family
        (Table 2 underlines one combination per mode), or the Appendix-A
        threshold policies when the user states requirements."""
        base = next(p for p in points if p.mode_name == "float")
        families = [m for m in dict.fromkeys(p.mode_name for p in points)
                    if m != "float"]
        results = []
        for mode_name in families:
            series = sorted((p for p in points if p.mode_name == mode_name),
                            key=lambda p: p.k)
            if not series:
                continue
            cand = [base] + series
            rec = allocator.recommend(
                [p.accuracy for p in cand], [p.latency for p in cand],
                max_latency=max_latency, min_accuracy=min_accuracy)
            results.append(SAMPResult(mode_name, cand[rec.index], rec))
        return results

    def top5(self, points: Sequence[SweepPoint]) -> list[SweepPoint]:
        """Appendix A: neither threshold set -> top-5 by speedup/accuracy-loss."""
        base = next(p for p in points if p.mode_name == "float")
        rest = [p for p in points if p is not base]
        cand = [base] + rest
        recs = allocator.top_k_by_efficiency(
            [p.accuracy for p in cand], [p.latency for p in cand], k=5)
        return [cand[r.index] for r in recs]

    # -- step 4: apply -------------------------------------------------------
    def apply(self, params: dict, stats: dict,
              precision: Union[PrecisionPlan, EncoderPolicy]):
        """Produce the production-ready (params, plan) for a chosen
        PrecisionPlan (EncoderPolicies convert via the shim)."""
        precision = as_plan(precision, dynamic_acts=self.scheme.dynamic_acts)
        return ptq.apply_plan(params, self.cfg, precision, stats,
                              scheme=self.scheme,
                              float_plan=self.float_plan)
