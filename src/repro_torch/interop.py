"""Carry the JAX package's parameters across into the port.

:func:`params_from_numpy` takes the JAX parameter tree as nested dicts,
lists and tuples of numpy arrays — each ``QuantizedTensor`` as a dict
``{"values", "scale", "zero_point"}`` — and returns the port's params: the
same leaves as tensors on ``device``, with the scan-stacked
``params["groups"][g]["layers"][j]`` unstacked into the per-layer list
``params["layers"]``. Any leaf carries as it is, so a BERT tree, a qwen2
tree (GLU ``wg``/``wu``/``wd``, QKV biases, the static KV-cache scales
``kc_scale``/``vc_scale`` and ``p_scale``) and a mixtral tree all come
across whole; unstacking slices only the scan axis, so an expert stack
``(steps, E, D, F)`` arrives as (E, D, F), its scales as (E, 1, F) and a
per-expert ``xs`` as (E, 1, 1). Converting jax arrays to numpy is the
caller's job; this module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.quantize import QuantizedTensor

_QT_KEYS = {"values", "scale", "zero_point"}


def _is_qt(node) -> bool:
    return isinstance(node, dict) and set(node) == _QT_KEYS


def _index(node, s: int):
    """Slice step ``s`` off every leaf of a stacked subtree."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _index(v, s) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_index(v, s) for v in node)
    return np.asarray(node)[s]


def _convert(node, device: torch.device):
    if node is None:
        return None
    if _is_qt(node):
        return QuantizedTensor(_convert(node["values"], device),
                               _convert(node["scale"], device),
                               _convert(node["zero_point"], device))
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device) for v in node]
    return torch.from_numpy(np.array(node, copy=True)).to(device)


def params_from_numpy(tree: dict, plan,
                      device: Union[str, torch.device] = "cuda") -> dict:
    """JAX-layout numpy params + the execution plan they were packed under
    (``repro_torch.models.transformer.build_plan`` of the same precision
    description, which groups layers exactly as the JAX package does) ->
    the port's params on ``device``."""
    device = resolve_device(device)
    groups = tree["groups"]
    if len(groups) != len(plan):
        raise ValueError(f"tree has {len(groups)} layer groups, plan "
                         f"{len(plan)}")
    out = {k: _convert(v, device) for k, v in tree.items() if k != "groups"}
    layers = []
    for g, gp in zip(plan, groups):
        for s in range(g.steps):
            for j in range(len(g.kinds)):
                layers.append(_convert(_index(gp["layers"][j], s), device))
    out["layers"] = layers
    return out
