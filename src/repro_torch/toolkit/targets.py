"""Target heads — the last stage of an encoder pipeline (port of
``repro.toolkit.targets``; this slice ports the ``cls`` head).

``init(gen, cfg, n_out, device=, dtype=) -> head params`` and
``apply(params, hidden, cfg) -> logits`` are the whole contract; ``apply``
receives the full params and reads the head from ``params["head"]``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

InitFn = Callable[..., Optional[dict]]
ApplyFn = Callable[[dict, torch.Tensor, ArchConfig], torch.Tensor]


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


def _cls_init(gen: torch.Generator, cfg: ArchConfig, n_out: int, *,
              device=None, dtype=torch.float32) -> dict:
    kw = dict(device=device, dtype=dtype)
    return {"pool": L.init_linear(gen, cfg.d_model, cfg.d_model, True, **kw),
            "out": L.init_linear(gen, cfg.d_model, n_out, True, **kw)}


def _cls_apply(params: dict, hidden: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    return T.apply_head(hidden, params, "cls")


CLS = TargetSpec(name="cls", init=_cls_init, apply=_cls_apply,
                 default_task="tnews")

TARGETS: dict[str, TargetSpec] = {"cls": CLS}


def get_target(name: str) -> TargetSpec:
    if name not in TARGETS:
        raise KeyError(f"unknown target head {name!r}; available: "
                       f"{sorted(TARGETS)}")
    return TARGETS[name]
