"""Quantized artifact bundles: deploy a tuned model without re-calibration
(port of ``repro.toolkit.artifact``, single-plan bundles, v1 and v2).

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
the lossless policy -> plan shim. v3 (adaptive) bundles need the port of
``PlanSet`` routing and raise. The port computes in float32 whatever
``compute_dtype`` a bundle names; bundles it writes say float32.
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
from repro_torch.core.plan import PrecisionPlan, as_plan, plan_from_policy
from repro_torch.core.precision import EncoderPolicy, LayerMode
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.data.pipeline import TaskSpec
from repro_torch.interop import (flatten_names, params_from_numpy,
                                 params_to_numpy, tree_from_names)
from repro_torch.models import transformer as T
from repro_torch.quant import ptq
from repro_torch.toolkit.registry import get_target

METADATA = "artifact.json"
VERSION = 2                 # the newest version the port reads and writes


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

    def pipeline(self, backend="reference"):
        """Rebuild the (quantized) Pipeline this artifact was saved from, on
        the compute backend ``backend`` (a deployment-time choice: the
        bundle persists the plan, not how it executes)."""
        from repro_torch.toolkit.pipeline import Pipeline
        task = self.task or TaskSpec(name="lm", kind="lm", n_classes=0,
                                     vocab_size=self.cfg.vocab_size,
                                     seq_len=64)
        float_pipe = Pipeline(self.cfg, task, get_target(self.target_name),
                              n_out=self.n_out, scheme=self.scheme,
                              tokenizer=self.tokenizer, backend=backend,
                              device=self.device)
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
        "version": VERSION,
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
    tmp = os.path.join(directory, METADATA + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    os.rename(tmp, os.path.join(directory, METADATA))
    store.save(directory, 0, tree, keep_last=1)
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
    """Reload a bundle onto ``device``: the per-layer params from the saved
    leaves, checked against the saved plan and stats. No re-calibration."""
    device = resolve_device(device)
    with open(os.path.join(directory, METADATA)) as f:
        meta = json.load(f)
    if meta["version"] == 3:
        raise ValueError(
            f"{directory}: a v3 (adaptive, PlanSet) bundle; the port does "
            f"not route over plan sets yet (ROADMAP queue 1 item 4)")
    if not 1 <= meta["version"] <= VERSION:
        raise ValueError(f"artifact version {meta['version']} not in "
                         f"[1, {VERSION}]")
    cfg = _cfg_from_dict(meta["arch"])
    precision = _precision_from_meta(meta)
    stats = _coerce_stats(meta["stats"])
    scheme = T.QuantScheme(**meta["scheme"])
    task = TaskSpec(**meta["task"]) if meta["task"] is not None else None
    tokenizer = None
    if meta.get("tokenizer"):
        from repro_torch.data.tokenizer import WordPieceTokenizer
        tokenizer = WordPieceTokenizer(meta["tokenizer"]["vocab"],
                                       meta["tokenizer"]["granularity"])
    plan = T.build_plan(cfg, precision)
    params = params_from_numpy(tree_from_names(store.load_leaves(
        directory, 0)), plan, device)
    _check_layout(params, cfg, precision, stats, directory)
    return Artifact(cfg=cfg, precision=precision, scheme=scheme, stats=stats,
                    params=params, plan=plan, task=task,
                    target_name=meta["target"]["name"],
                    n_out=int(meta["target"]["n_out"]), path=directory,
                    device=device, tokenizer=tokenizer)
