"""Quantized artifact bundles: deploy a tuned model without re-calibration
(port of ``repro.toolkit.artifact``: single-plan bundles, v1 and v2, and
adaptive v3 bundles).

An artifact is everything SAMP chose plus everything PTQ produced, saved as
one directory in the JAX package's format, so a bundle either package
writes loads in the other:

* ``artifact.json``  — the architecture config, the chosen
  :class:`~repro_torch.core.plan.PrecisionPlan` (with its ``fingerprint``
  recorded for integrity checks), the quantization scheme, the calibration
  stats (per-layer/site amax values), the task + target head identity, and
  the parameter dtype;
* ``step_00000000/`` — every parameter leaf (int8 weights, scales, float
  residue) written through :mod:`repro_torch.checkpoint.store` under the
  JAX package's key paths: the port's per-layer params are restacked into
  scan groups (:func:`repro_torch.interop.params_to_numpy`).

Loading rebuilds the per-layer params from the saved leaves' names and
shapes (:func:`repro_torch.interop.tree_from_names`) under the execution
plan of the saved PrecisionPlan, and checks them against that plan and the
saved stats: every GEMM the plan quantizes is int8, every other float, and
a static activation scale sits exactly where the plan and the stats put
one. Outputs are bit-identical to the pipeline that was saved, the
reloaded plan's ``fingerprint()`` is byte-identical to the recorded one,
and no calibration batches are needed at deployment time.

v1 bundles stored an ``EncoderPolicy`` (``policy`` key); they load through
the lossless policy -> plan shim. v3 bundles are adaptive: they hold the
FLOAT parameters, a :class:`~repro_torch.core.plan.PlanSet`, the cluster
model and the per-cluster calibration stats (keyed by string cluster id),
and loading rebuilds each member's quantized tree with ``ptq.apply_plan``
(the default member's at once, every member's in :meth:`Artifact.router`),
bit-identical to the trees that were served. The port computes in float32
whatever ``compute_dtype`` a bundle names; bundles it writes say float32.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.plan import (PlanSet, PrecisionPlan, as_plan,
                                   plan_from_policy)
from repro_torch.core.precision import EncoderPolicy, LayerMode
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.data.pipeline import TaskSpec
from repro_torch.interop import (flatten_names, params_from_numpy,
                                 params_to_numpy, tree_from_names)
from repro_torch.models import transformer as T
from repro_torch.quant import ptq
from repro_torch.toolkit.registry import get_target

METADATA = "artifact.json"
VERSION = 3                 # the newest version the port reads
SINGLE_PLAN_VERSION = 2     # what save_artifact writes


@dataclasses.dataclass
class Artifact:
    """A loaded bundle, ready to serve: ``params`` live on ``device``."""
    cfg: ArchConfig
    precision: PrecisionPlan
    scheme: T.QuantScheme
    stats: dict
    params: dict
    plan: tuple
    task: Optional[TaskSpec]
    target_name: str
    n_out: int
    path: str
    device: torch.device
    tokenizer: Optional[object] = None       # WordPieceTokenizer
    # v3 adaptive bundles only:
    planset: Optional[PlanSet] = None
    cluster_model: Optional[object] = None   # repro_torch.adaptive model
    cluster_stats: Optional[dict] = None     # {cluster: {layer: {site: v}}}
    float_params: Optional[dict] = None      # the shared float weight tree

    @property
    def adaptive(self) -> bool:
        return self.planset is not None

    def router(self, backend=None):
        """Rebuild the :class:`~repro_torch.adaptive.PlanRouter` a v3
        bundle was deployed with: each member re-quantizes the shared float
        tree under its own cluster's stats. ``backend`` is the compute
        backend an EmbeddingKMeans model's admission embedder runs on."""
        if not self.adaptive:
            raise ValueError(f"{self.path}: not an adaptive (v3) bundle — "
                             f"no PlanSet to route over")
        from repro_torch.adaptive import build_router
        return build_router(self.cfg, self.float_params, self.planset,
                            self.cluster_stats,
                            cluster_model=self.cluster_model,
                            scheme=self.scheme, backend=backend)

    def pipeline(self, backend="reference", mesh=None):
        """Rebuild the (quantized) Pipeline this artifact was saved from, on
        the compute backend ``backend`` and the serving mesh ``mesh``
        (deployment-time choices: the bundle persists the plan, not how or
        where it executes)."""
        from repro_torch.toolkit.pipeline import Pipeline
        task = self.task or TaskSpec(name="lm", kind="lm", n_classes=0,
                                     vocab_size=self.cfg.vocab_size,
                                     seq_len=64)
        float_pipe = Pipeline(self.cfg, task, get_target(self.target_name),
                              n_out=self.n_out, scheme=self.scheme,
                              tokenizer=self.tokenizer, backend=backend,
                              device=self.device, mesh=mesh)
        return float_pipe.with_policy(self.params, self.plan, self.precision)


def _cfg_from_dict(d: dict) -> ArchConfig:
    d = dict(d)
    if d.get("moe"):
        d["moe"] = MoEConfig(**d["moe"])
    if d.get("mla"):
        d["mla"] = MLAConfig(**d["mla"])
    d["pattern"] = tuple(d["pattern"])
    return ArchConfig(**d)


def _param_dtype(tree: dict) -> str:
    for _, leaf in flatten_names(tree):
        if np.issubdtype(leaf.dtype, np.floating):
            return str(leaf.dtype)
    return "float32"


def save_artifact(directory: str, *, cfg: ArchConfig,
                  policy: Union[PrecisionPlan, EncoderPolicy],
                  stats: dict, params: dict,
                  scheme: T.QuantScheme = T.QuantScheme(),
                  task: Optional[TaskSpec] = None,
                  target: str = "lm", n_out: int = 0,
                  tokenizer=None) -> str:
    """Write a deployable v2 bundle. ``params`` must be the PTQ output for
    ``policy`` (a PrecisionPlan, or an EncoderPolicy coerced through the
    shim); ``stats`` the calibration stats the plan was applied with."""
    precision = as_plan(policy, dynamic_acts=scheme.dynamic_acts)
    tree = params_to_numpy(params, T.build_plan(cfg, precision))
    os.makedirs(directory, exist_ok=True)
    meta = {
        "version": SINGLE_PLAN_VERSION,
        "arch": dataclasses.asdict(cfg),
        "plan": precision.to_dict(),
        "plan_fingerprint": precision.fingerprint(),
        "scheme": dataclasses.asdict(scheme),
        "stats": stats,
        "task": dataclasses.asdict(task) if task is not None else None,
        "target": {"name": target, "n_out": n_out},
        "param_dtype": _param_dtype(tree),
        "compute_dtype": "float32",
        "tokenizer": ({"vocab": tokenizer.vocab,
                       "granularity": tokenizer.granularity}
                      if tokenizer is not None else None),
    }
    _write(directory, meta, tree)
    return directory


def _write(directory: str, meta: dict, tree: dict) -> None:
    tmp = os.path.join(directory, METADATA + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.rename(tmp, os.path.join(directory, METADATA))
    store.save(directory, 0, tree, keep_last=1)


def _float_plan(cfg: ArchConfig):
    """The execution plan float params are packed under."""
    return T.build_plan(cfg, PrecisionPlan.full_float(cfg.num_layers,
                                                      "float32"))


def save_adaptive_artifact(directory: str, *, cfg: ArchConfig,
                           planset: PlanSet, cluster_model,
                           cluster_stats: dict, float_params: dict,
                           scheme: T.QuantScheme = T.QuantScheme(),
                           task: Optional[TaskSpec] = None,
                           target: str = "lm", n_out: int = 0,
                           tokenizer=None) -> str:
    """Write an adaptive (v3) bundle: the FLOAT parameter tree, the
    PlanSet, the cluster model and the per-cluster calibration stats. The K
    quantized trees are not stored: :func:`load_artifact` rebuilds them
    with ``ptq.apply_plan`` from the same inputs."""
    if set(cluster_stats) - set(planset.cluster_ids):
        raise ValueError(f"cluster_stats covers {sorted(cluster_stats)} but "
                         f"the planset only {list(planset.cluster_ids)}")
    tree = params_to_numpy(float_params, _float_plan(cfg))
    os.makedirs(directory, exist_ok=True)
    meta = {
        "version": 3,
        "arch": dataclasses.asdict(cfg),
        "planset": planset.to_dict(),
        "planset_fingerprint": planset.fingerprint(),
        "cluster_model": cluster_model.to_dict(),
        "cluster_model_fingerprint": cluster_model.fingerprint(),
        "scheme": dataclasses.asdict(scheme),
        # JSON objects key on strings; load restores the int cluster ids
        "cluster_stats": {str(c): st for c, st in cluster_stats.items()},
        "task": dataclasses.asdict(task) if task is not None else None,
        "target": {"name": target, "n_out": n_out},
        "param_dtype": _param_dtype(tree),
        "compute_dtype": "float32",
        "tokenizer": ({"vocab": tokenizer.vocab,
                       "granularity": tokenizer.granularity}
                      if tokenizer is not None else None),
    }
    _write(directory, meta, tree)
    return directory


def _coerce_stats(sites_by_layer: dict) -> dict:
    # per-head KV-cache stats round-trip as lists; everything else is scalar
    return {layer: {site: (v if isinstance(v, list) else float(v))
                    for site, v in sites.items()}
            for layer, sites in sites_by_layer.items()}


def _precision_from_meta(meta: dict) -> PrecisionPlan:
    if meta["version"] >= 2:
        precision = PrecisionPlan.from_dict(meta["plan"])
        want = meta.get("plan_fingerprint")
        if want is not None and precision.fingerprint() != want:
            raise ValueError(
                f"plan fingerprint mismatch: metadata says {want}, "
                f"reloaded plan hashes to {precision.fingerprint()} — "
                f"the bundle's artifact.json was edited or corrupted")
        return precision
    # v1: an EncoderPolicy (modes + float_dtype) through the lossless shim
    policy = EncoderPolicy(
        tuple(LayerMode(m) for m in meta["policy"]["modes"]),
        meta["policy"]["float_dtype"])
    scheme = T.QuantScheme(**meta["scheme"])
    return plan_from_policy(policy, dynamic_acts=scheme.dynamic_acts)


def _check_layout(params: dict, cfg: ArchConfig, precision: PrecisionPlan,
                  stats: dict, path: str) -> None:
    """The structure ``ptq.apply_plan`` gives under the saved plan and
    stats: each GEMM weight int8 exactly where the plan quantizes its
    block, and a static activation scale ``xs`` exactly where the plan asks
    for static activations and the stats observed the site."""
    kinds = cfg.layer_kinds()
    for i, lp in enumerate(params["layers"]):
        layer, amax = precision.layers[i], stats.get(f"layer{i}", {})
        for _g, gpath, site, block in ptq._kind_entries(cfg, kinds[i]):
            spec, expert_site = ptq._entry_spec(layer, kinds[i], gpath,
                                                block)
            sub = ptq._get_path(lp, gpath)
            if sub is None:
                continue
            where = f"{path}: layer {i} {'/'.join(gpath)}"
            got = ("int8" if isinstance(sub["w"], QuantizedTensor)
                   else "float")
            if (got == "int8") != spec.quantized:
                raise ValueError(f"{where}: the saved weight is {got}, the "
                                 f"plan says {spec.weight!r}")
            static = spec.quantized and spec.static_acts and (
                expert_site is not None or site in amax)
            if ("xs" in sub) != static:
                raise ValueError(f"{where}: activation scale "
                                 f"{'missing' if static else 'unexpected'} "
                                 f"under act={spec.act!r}")


def load_artifact(directory: str,
                  device: Union[str, torch.device] = "cuda") -> Artifact:
    """Reload a bundle onto ``device``: v1-v2, the per-layer params from the
    saved leaves, checked against the saved plan and stats; v3, the float
    tree and the default member's quantized tree rebuilt from it. No
    re-calibration."""
    device = resolve_device(device)
    with open(os.path.join(directory, METADATA)) as f:
        meta = json.load(f)
    if not 1 <= meta["version"] <= VERSION:
        raise ValueError(f"artifact version {meta['version']} not in "
                         f"[1, {VERSION}]")
    cfg = _cfg_from_dict(meta["arch"])
    scheme = T.QuantScheme(**meta["scheme"])
    task = TaskSpec(**meta["task"]) if meta["task"] is not None else None
    tokenizer = None
    if meta.get("tokenizer"):
        from repro_torch.data.tokenizer import WordPieceTokenizer
        tokenizer = WordPieceTokenizer(meta["tokenizer"]["vocab"],
                                       meta["tokenizer"]["granularity"])
    leaves = tree_from_names(store.load_leaves(directory, 0))
    adaptive = {}
    if meta["version"] >= 3:
        from repro_torch.adaptive import cluster_model_from_dict
        planset = PlanSet.from_dict(meta["planset"])
        want = meta.get("planset_fingerprint")
        if want is not None and planset.fingerprint() != want:
            raise ValueError(
                f"planset fingerprint mismatch: metadata says {want}, "
                f"reloaded set hashes to {planset.fingerprint()} — the "
                f"bundle's artifact.json was edited or corrupted")
        cluster_stats = {int(c): _coerce_stats(st)
                         for c, st in meta["cluster_stats"].items()}
        precision = planset.plan_for(planset.default)
        stats = cluster_stats.get(planset.default,
                                  cluster_stats[sorted(cluster_stats)[0]])
        float_plan = _float_plan(cfg)
        float_params = params_from_numpy(leaves, float_plan, device)
        # the default member's tree; Artifact.router() rebuilds every
        # member the same way
        params, plan = ptq.apply_plan(float_params, cfg, precision, stats,
                                      scheme=scheme, float_plan=float_plan)
        adaptive = dict(planset=planset, cluster_stats=cluster_stats,
                        cluster_model=cluster_model_from_dict(
                            meta["cluster_model"]),
                        float_params=float_params)
    else:
        precision = _precision_from_meta(meta)
        stats = _coerce_stats(meta["stats"])
        plan = T.build_plan(cfg, precision)
        params = params_from_numpy(leaves, plan, device)
        _check_layout(params, cfg, precision, stats, directory)
    return Artifact(cfg=cfg, precision=precision, scheme=scheme, stats=stats,
                    params=params, plan=plan, task=task,
                    target_name=meta["target"]["name"],
                    n_out=int(meta["target"]["n_out"]), path=directory,
                    device=device, tokenizer=tokenizer, **adaptive)
