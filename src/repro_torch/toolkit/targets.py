"""Target heads — the pluggable last stage of a
:class:`~repro_torch.toolkit.pipeline.Pipeline` (port of
``repro.toolkit.targets``).

The paper's "target" layer (§3.1) handles the downstream task on top of the
encoder output. Each head is a :class:`TargetSpec` in the ``TARGETS``
registry; the built-ins cover the paper's CLUE-style text-processing tasks:

* ``cls``          — CLS-pool classification (TNEWS/IFLYTEK-like)
* ``pair_matching``— sentence-pair matching (AFQMC-like): the pair is packed
                     as ``[CLS] a [SEP] b [SEP]`` with segment ids, so the
                     head itself is the CLS-pool classifier over 2 classes
* ``seq_labeling`` — per-token tagging (NER-like)
* ``lm``           — next-token language modeling (no head params; logits
                     come from the tied/untied unembedding)

``init(gen, cfg, n_out, device=, dtype=) -> head params`` (``gen`` a
``torch.Generator`` on ``device``) and ``apply(params, hidden, cfg) ->
logits`` are the whole contract; ``apply`` receives the full params and
reads the head from ``params["head"]``. The Pipeline wires loss, prediction
and eval around them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.toolkit.registry import TARGETS, get_target, register_target

InitFn = Callable[..., Optional[dict]]
ApplyFn = Callable[[dict, torch.Tensor, ArchConfig], torch.Tensor]

__all__ = ["CLS", "LM", "PAIR_MATCHING", "SEQ_LABELING",
           "TARGET_FOR_TASK_KIND", "TARGETS", "TargetSpec", "get_target"]


@dataclasses.dataclass(frozen=True)
class TargetSpec:
    """One downstream-task head. ``token_level`` marks per-position outputs;
    ``default_task`` names the synthetic data task it pairs with."""

    name: str
    init: InitFn
    apply: ApplyFn
    token_level: bool = False
    default_task: str = "tnews"

    def predict(self, logits):
        return torch.argmax(torch.as_tensor(logits), dim=-1)

    def loss(self, logits: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        return T.cross_entropy(logits, labels)


def _cls_init(gen: torch.Generator, cfg: ArchConfig, n_out: int, *,
              device=None, dtype=torch.float32) -> dict:
    kw = dict(device=device, dtype=dtype)
    return {"pool": L.init_linear(gen, cfg.d_model, cfg.d_model, True, **kw),
            "out": L.init_linear(gen, cfg.d_model, n_out, True, **kw)}


def _cls_apply(params: dict, hidden: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    return T.apply_head(hidden, params, "cls")


def _tok_init(gen: torch.Generator, cfg: ArchConfig, n_out: int, *,
              device=None, dtype=torch.float32) -> dict:
    return {"out": L.init_linear(gen, cfg.d_model, n_out, True,
                                 device=device, dtype=dtype)}


def _tok_apply(params: dict, hidden: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    return T.apply_head(hidden, params, "ner")


def _lm_init(gen: torch.Generator, cfg: ArchConfig, n_out: int, *,
             device=None, dtype=torch.float32) -> None:
    return None                      # unembedding lives in the base params


def _lm_apply(params: dict, hidden: torch.Tensor,
              cfg: ArchConfig) -> torch.Tensor:
    return T.unembed(hidden, params, cfg)


CLS = register_target("cls", TargetSpec(
    name="cls", init=_cls_init, apply=_cls_apply, default_task="tnews"))

PAIR_MATCHING = register_target("pair_matching", TargetSpec(
    name="pair_matching", init=_cls_init, apply=_cls_apply,
    default_task="afqmc"))

SEQ_LABELING = register_target("seq_labeling", TargetSpec(
    name="seq_labeling", init=_tok_init, apply=_tok_apply,
    token_level=True, default_task="ner"))

LM = register_target("lm", TargetSpec(
    name="lm", init=_lm_init, apply=_lm_apply,
    token_level=True, default_task="lm"))

# data-task kind -> default head name (TaskSpec.kind values)
TARGET_FOR_TASK_KIND = {"cls": "cls", "match": "pair_matching",
                        "ner": "seq_labeling", "lm": "lm"}
