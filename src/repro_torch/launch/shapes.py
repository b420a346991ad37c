"""The named input-shape grid and abstract specs per cell (port of
``repro.launch.shapes``).

Four shapes per LM architecture:

    train_4k      seq 4096,   global_batch 256   -> train step
    prefill_32k   seq 32768,  global_batch 32    -> prefill (fwd + cache)
    decode_32k    seq 32768,  global_batch 128   -> serve step (1 new token)
    long_500k     seq 524288, global_batch 1     -> serve step, sub-quadratic
                                                    archs only

Encoder-only archs (hubert) have no decode; ``long_500k`` runs only where
decode state is bounded. The specs are tensors on the ``meta`` device: the
shapes and dtypes, with nothing allocated.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.precision import EncoderPolicy
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """(supported, reason-if-not), by the JAX package's skip rules."""
    cell = SHAPES[shape_name]
    if cell.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch: no decode step"
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 500k decode is not sub-quadratic"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, cell: ShapeCell,
                compute_dtype=torch.bfloat16) -> dict:
    """Meta tensors for the raw model inputs of one cell."""
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        return {"tokens": _meta((B, 1), torch.int32)}
    if cfg.frontend == "audio":
        return {"frames": _meta((B, S, cfg.frontend_dim), compute_dtype),
                "labels": _meta((B, S), torch.int32)}
    batch = {}
    if cfg.frontend == "vision":
        P = cfg.num_prefix_embeds
        batch["prefix_embeds"] = _meta((B, P, cfg.frontend_dim),
                                       compute_dtype)
        batch["tokens"] = _meta((B, S - P), torch.int32)
    else:
        batch["tokens"] = _meta((B, S), torch.int32)
    if cfg.family == "bert":
        batch["segments"] = _meta((B, S), torch.int32)
        batch["labels"] = _meta((B,), torch.int32)
    return batch


def cache_specs(cfg: ArchConfig, plan, cell: ShapeCell,
                cache_dtype=torch.bfloat16) -> list:
    """Decode caches of one cell on the meta device (the real
    constructor, nothing allocated)."""
    return T.init_caches(cfg, plan, cell.global_batch, cell.seq_len,
                         cache_dtype, device="meta")


def params_specs(cfg: ArchConfig, policy: EncoderPolicy,
                 param_dtype=torch.bfloat16, head=None) -> dict:
    """The float parameter tree on the meta device."""
    return T.init_params(cfg, policy, head=head, device="meta",
                         dtype=param_dtype)
