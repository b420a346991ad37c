"""Carry parameters between the JAX package's layout and the port's.

:func:`params_from_numpy` takes the JAX parameter tree as nested dicts,
lists and tuples of numpy arrays — each ``QuantizedTensor`` as a dict
``{"values", "scale", "zero_point"}`` — and returns the port's params: the
same leaves as tensors on ``device``, with the scan-stacked
``params["groups"][g]["layers"][j]`` unstacked into the per-layer list
``params["layers"]``. Any leaf carries as it is, so a BERT tree, a qwen2
tree (GLU ``wg``/``wu``/``wd``, QKV biases, the static KV-cache scales
``kc_scale``/``vc_scale`` and ``p_scale``) and a mixtral tree all come
across whole, as do the recurrent layers' leaves (the RG-LRU's ``lam``
and ``conv``, the sLSTM's per-head ``r`` (4, H, dh, dh)); unstacking
slices only the scan axis, so an expert stack
``(steps, E, D, F)`` arrives as (E, D, F), its scales as (E, 1, F) and a
per-expert ``xs`` as (E, 1, 1). :func:`params_to_numpy` is its inverse:
it restacks the port's per-layer list into ``groups[g]["layers"][j]`` with
the scan axis first.

A tree in that layout is named leaf by leaf with the JAX package's key
paths (``embed/tok``, ``groups/0/layers/0/attn/wq/w/values``, ...): dict
keys in sorted order, list indices, and a quantized tensor's ``values``,
``scale`` and, where it is not None, ``zero_point``. :func:`flatten_names`,
:func:`map_leaves` and :func:`tree_from_names` go between a tree and those
names; the checkpoint store and the artifact bundles address leaves by
them, so a bundle either package writes loads in the other. Converting
jax arrays to numpy is the caller's job; this module imports neither JAX
nor the JAX package.
"""
from __future__ import annotations

from typing import Any, Callable, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.quantize import QuantizedTensor

_QT_KEYS = ("values", "scale", "zero_point")


def _is_qt(node) -> bool:
    """A quantized tensor as a dict: ``values`` and ``scale``, and a
    ``zero_point`` that a tree rebuilt from names may not carry."""
    return (isinstance(node, dict) and {"values", "scale"} <= set(node)
            <= set(_QT_KEYS))


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
                               _convert(node.get("zero_point"), device))
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


# ---------------------------------------------------------------------------
# the port's params -> the JAX layout
# ---------------------------------------------------------------------------


def _to_numpy(node):
    if node is None:
        return None
    if isinstance(node, QuantizedTensor):
        return {"values": _to_numpy(node.values),
                "scale": _to_numpy(node.scale),
                "zero_point": _to_numpy(node.zero_point)}
    if isinstance(node, dict):
        return {k: _to_numpy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_numpy(v) for v in node]
    if torch.is_tensor(node):
        return node.detach().cpu().numpy()
    return np.asarray(node)


def _stack(nodes: list):
    """Stack same-structured trees along a new leading (scan) axis."""
    first = nodes[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([n[k] for n in nodes]) for k in first}
    if isinstance(first, list):
        return [_stack([n[i] for n in nodes]) for i in range(len(first))]
    return np.stack(nodes)


def params_to_numpy(params: dict, plan) -> dict:
    """The port's params (a per-layer list under ``params["layers"]``) + the
    execution plan they run under -> the JAX package's layout as numpy:
    ``groups[g]["layers"][j]`` stacks the g-th group's j-th layer kind over
    its ``steps``, each quantized tensor a ``{"values", "scale",
    "zero_point"}`` dict. The inverse of :func:`params_from_numpy`."""
    layers = params["layers"]
    if sum(g.stop - g.start for g in plan) != len(layers):
        raise ValueError(f"params hold {len(layers)} layers, plan "
                         f"{sum(g.stop - g.start for g in plan)}")
    out = {k: _to_numpy(v) for k, v in params.items() if k != "layers"}
    out["groups"] = [
        {"layers": [_stack([_to_numpy(layers[g.start + s * len(g.kinds) + j])
                            for s in range(g.steps)])
                    for j in range(len(g.kinds))]}
        for g in plan]
    return out


# ---------------------------------------------------------------------------
# leaf names
# ---------------------------------------------------------------------------


def _children(node):
    """(key, child) pairs of an inner node in the JAX package's flatten
    order, or None for a leaf."""
    if isinstance(node, QuantizedTensor):
        node = {"values": node.values, "scale": node.scale,
                "zero_point": node.zero_point}
    if _is_qt(node):
        return [(k, node[k]) for k in _QT_KEYS
                if node.get(k) is not None]
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten_names(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(name, leaf)`` for every leaf of ``tree``; None leaves are absent,
    as in a JAX pytree."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += flatten_names(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def map_leaves(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(name, leaf)``; containers
    keep their types (a port ``QuantizedTensor`` stays one)."""
    def name(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if tree is None:
        return None
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(
            map_leaves(tree.values, fn, name("values")),
            map_leaves(tree.scale, fn, name("scale")),
            map_leaves(tree.zero_point, fn, name("zero_point")))
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn, name(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(v, fn, name(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_from_names(leaves: dict) -> dict:
    """Rebuild a nested tree from ``{name: array}``: each name's parts are
    dict keys, except that a node whose keys are exactly ``0..n-1`` becomes
    a list (``groups/0`` is the first group)."""
    root: dict = {}
    for full, arr in leaves.items():
        node = root
        parts = full.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"leaf {full!r} runs through a leaf")
        if parts[-1] in node:
            raise ValueError(f"leaf {full!r} named twice or under a node")
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            idx = sorted(int(k) for k in node)
            if idx == list(range(len(idx))):
                return [node[str(i)] for i in idx]
        return node
    return listify(root)
