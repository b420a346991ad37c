"""Logical-axis sharding rules for every arch family (port of
``repro.distributed.sharding``), and the slicing of a parameter tree to one
rank's block.

The rules are the JAX package's, leaf for leaf: a parameter, batch or cache
leaf is named by its JAX key path (``embed/tok``,
``groups/0/layers/0/attn/wq/w/values``, ...) and gets a
:class:`PartitionSpec` over the ``(data, model)`` mesh:

* TP over ``model``: attention q/k/v out-features, the FFN hidden units,
  the vocab of a tied table; the row-parallel projections (``wo``, ``wd``)
  on their in-features. A dim takes ``model`` only when the axis size
  divides it: other params replicate, never padded.
* FSDP over ``data`` (training; serving passes ``fsdp=False``).
* int8 ``values`` take their weight's spec; a per-channel ``scale`` rides
  the same axis (its size-1 broadcast dims never shard); per-tensor scales,
  zero points and static activation scales replicate.

The port runs SPMD: every rank of the mesh runs the same program on its own
block. :func:`shard_params` slices an already quantized tree to the rank's
block under the rules (``values`` and per-channel scales along their
weight's axis, biases along theirs), so a shard is never quantized on its
own: a per-tensor scale stays the global one. The JAX package's activation
``constrain`` tags have no counterpart here; the places they mark are where
:mod:`repro_torch.models.layers` runs its collectives.

:func:`mesh_fingerprint` is the topology part of the serving runtime's
cache key, the same strings as the JAX package's (``"unmeshed"``,
``"data=2,model=1"``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantize import QuantizedTensor


class PartitionSpec(tuple):
    """One entry a tensor dim: an axis name, a tuple of axis names, or None
    (replicated) — the port's counterpart of ``jax.sharding.PartitionSpec``,
    compared as a plain tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str = "model"
    pod: Optional[str] = None      # present on the multi-pod mesh

    @property
    def dp(self) -> tuple:
        """Axes that shard the batch (pod is pure-DP)."""
        return (self.pod, self.data) if self.pod else (self.data,)


def infer_axes(mesh) -> MeshAxes:
    return MeshAxes(pod="pod" if "pod" in mesh.axis_names else None)


def mesh_fingerprint(mesh) -> str:
    """Stable topology identity for cache keys: axis names and sizes in mesh
    order (``"data=2,model=1"``), ``"unmeshed"`` for None. It names the
    topology only: the process-group backend is not part of it."""
    if mesh is None:
        return "unmeshed"
    return ",".join(f"{a}={int(mesh.shape[a])}" for a in mesh.axis_names)


def _div(dim: int, size: int) -> bool:
    return dim % size == 0


class Rules:
    """Parameter sharding rule engine bound to (cfg, mesh); ``mesh`` needs
    only ``.shape`` (axis -> size) and ``.axis_names``."""

    def __init__(self, cfg: ArchConfig, mesh, *, fsdp: bool = True):
        self.cfg = cfg
        self.mesh = mesh
        self.axes = infer_axes(mesh)
        self.msize = mesh.shape["model"]
        self.dsize = mesh.shape["data"]
        self.fsdp = fsdp

    # -- helpers -------------------------------------------------------------
    def _f(self, dim: int):
        return self.axes.data if self.fsdp and _div(dim, self.dsize) else None

    def _m(self, dim: int):
        return self.axes.model if _div(dim, self.msize) else None

    def _col(self, shape):       # (D_in, N_out): FSDP in, TP out
        return (self._f(shape[0]), self._m(shape[1]))

    def _row(self, shape):       # (N_in, D_out): TP in, FSDP out
        return (self._m(shape[0]), self._f(shape[1]))

    def _expert(self, shape, row: bool):
        E = shape[0]
        if _div(E, self.dsize):
            return ((self.axes.data, self._m(shape[1]), None) if row
                    else (self.axes.data, None, self._m(shape[2])))
        return ((None, self._m(shape[1]), self._f(shape[2])) if row
                else (None, self._f(shape[1]), self._m(shape[2])))

    # -- the rule table --------------------------------------------------------
    _COL = ("wq/w", "wk/w", "wv/w", "wg/w", "wu/w", "wi/w", "wz/w", "wx/w",
            "up/w", "wq_b/w", "wq_a/w", "wkv_b/w", "wa/w")
    _ROW = ("wo/w", "wd/w", "down/w", "proj/w")

    def spec_body(self, path: str, shape) -> tuple:
        """Spec for the trailing (non-stack) dims of a layer-body leaf."""
        if re.search(r"ffn/(wg|wu|wd)/w$", path) and len(shape) == 3:
            return self._expert(shape, row=path.endswith("wd/w"))
        if re.search(r"ffn/(wg|wu|wd)/xs$", path) and len(shape) == 3:
            return ((self.axes.data if _div(shape[0], self.dsize) else None),
                    None, None)
        if path.endswith("router/w"):
            return (None, None)
        if re.search(r"rec/(wa|wi)/w$", path):
            return (None, self._m(shape[1]))
        if re.search(r"blk/(wq|wk|wv|wif)/w$", path):
            return (None, self._m(shape[1]))
        if re.search(r"blk/(wi|wf|wo|wz)/w$", path):
            return (None, self._m(shape[1]))
        if any(path.endswith(s) for s in self._ROW):
            return self._row(shape)
        if any(path.endswith(s) for s in self._COL):
            return self._col(shape)
        if path.endswith("/b"):                     # biases follow out dim
            return (self._m(shape[-1]),)
        if path.endswith("wkv_a/w"):
            return (self._f(shape[0]), None)
        return (None,) * len(shape)

    def spec_for(self, path: str, shape) -> PartitionSpec:
        """Full spec for any param leaf named by its JAX key path (the
        group stack dim of a ``/layers/`` leaf first, and the
        ``values`` / ``scale`` / ``zero_point`` leaves of a quantized
        tensor)."""
        for suf in ("/values", "/scale", "/zero_point"):
            if path.endswith(suf):
                path = path[: -len(suf)]
                break
        in_body = "/layers/" in path
        if in_body:
            stack, body_shape = tuple(shape[:1]), tuple(shape[1:])
        else:
            stack, body_shape = (), tuple(shape)
        if not body_shape:                          # scalars (zero_point)
            return P()
        if in_body:
            base = self.spec_body(path, body_shape)
        else:
            base = self._top_level(path, body_shape)
        base = tuple(None if body_shape[i] == 1 else base[i]
                     for i in range(len(base)))
        return P(*((None,) * len(stack) + base))

    def _top_level(self, path: str, shape) -> tuple:
        if path.endswith("embed/tok"):
            # a tied table is also the LM head: vocab over 'model', so the
            # logits come out vocab-parallel; an untied one shards d_model
            if self.cfg.tie_embeddings:
                return (self._m(shape[0]), None)
            return (None, self._m(shape[1]))
        if path.endswith("embed/pos") or path.endswith("embed/seg"):
            return (None, self._m(shape[1]))
        if "lm_head" in path and path.endswith("/w"):
            return (self._f(shape[0]), self._m(shape[1]))
        if "frontend_proj" in path and path.endswith("/w"):
            return (None, self._m(shape[1]))
        return (None,) * len(shape)

    # -- public API -------------------------------------------------------------
    def params_spec(self, params) -> dict:
        """``{name: PartitionSpec}`` over the JAX-layout names of
        ``params``: a JAX-layout tree (``groups/g/layers/j/...`` leaves with
        their stack dim; any leaf with a ``.shape``), or the port's own tree
        (a per-layer list under ``layers``), whose layer leaves are named
        ``groups/0/layers/0/...`` and carry no stack dim in their spec."""
        return {name: spec for name, spec, _ in _named_specs(self, params)}

    @property
    def dp_size(self) -> int:
        """Total batch-sharding factor (product of the dp axes). Serving
        rounds batch buckets up to multiples of this."""
        bsz = 1
        for a in self.axes.dp:
            bsz *= self.mesh.shape[a]
        return bsz

    def batch_spec(self, batch: dict) -> dict:
        dp = self.axes.dp
        bsz = self.dp_size

        def spec(leaf):
            if len(leaf.shape) == 0:
                return P()
            # as the JAX package writes it: P(dp) or P(), then one None a
            # trailing dim
            b = (dp,) if leaf.shape[0] % bsz == 0 else ()
            return P(*(b + (None,) * (len(leaf.shape) - 1)))
        return {k: spec(v) for k, v in batch.items()}

    def cache_spec(self, caches) -> dict:
        """``{name: PartitionSpec}`` for decode caches named as the JAX
        package's (``0/0/pages_k``: group, kind, key; leaves carry the stack
        dim): the batch over dp where divisible; KV heads over model when
        divisible, else the ring's sequence axis takes model; a paged pool
        never shards its page axis (page ids are global). The port's own
        cache list (one dict a layer, no stack dim) is named
        ``<layer>/0/<key>`` and its specs carry no stack dim."""
        return {name: spec for name, spec in _named_cache_specs(self, caches)}

    def _cache_leaf_spec(self, path: str, shape) -> PartitionSpec:
        dp = self.axes.dp
        bsz = self.dp_size
        ndim = len(shape)
        if ndim <= 2 or path.endswith("k_pos") or path.endswith("pos"):
            return P(*(None,) * ndim)
        if "pages_" in path:
            if (path.endswith("pages_k") or path.endswith("pages_v")
                    or path.endswith("pages_ks")
                    or path.endswith("pages_vs")) \
                    and _div(shape[3], self.msize):
                return P(*(None, None, None, self.axes.model)
                         + (None,) * (ndim - 4))
            return P(*(None,) * ndim)
        b = dp if shape[1] % bsz == 0 else None
        if path.endswith("/k") or path.endswith("/v"):
            if _div(shape[3], self.msize):
                return P(None, b, None, self.axes.model, None)
            return P(None, b, self.axes.model, None, None)
        if path.endswith("ckv") or path.endswith("krope"):
            return P(None, b, self.axes.model, None)
        if path.endswith("/C"):
            return P(None, b, None, None, None)
        return P(*((None, b) + (None,) * (ndim - 2)))

    def seq_shard_attn(self, B: int, S: int, H: int,
                       budget_bytes: float = 6e9) -> bool:
        """Context-parallel attention: on when the sequence splits evenly
        over 'model' and the per-device score tensor fits the budget."""
        if S % self.msize or S < self.msize:
            return False
        bsz = self.dsize * (self.mesh.shape.get("pod", 1)
                            if self.axes.pod else 1)
        b_loc = max(B // max(bsz, 1), 1)
        score_bytes = b_loc * H * (S // self.msize) * S * 4.0
        return score_bytes <= budget_bytes

    def attn_chunk(self, B: int, S: int, H: int, default: int = 512):
        """Query-chunk size matching the sharding choice (None =
        unchunked, when attention is sequence-sharded)."""
        return None if self.seq_shard_attn(B, S, H) else default


# ---------------------------------------------------------------------------
# naming trees with the JAX package's key paths
# ---------------------------------------------------------------------------


def _named_leaves(tree, prefix: str = ""):
    """(name, leaf) in the JAX package's flatten order: dict keys sorted,
    list indices, a quantized tensor's values / scale / zero_point (a dict
    of exactly those keys counts as one)."""
    if tree is None:
        return
    if isinstance(tree, QuantizedTensor):
        tree = {"values": tree.values, "scale": tree.scale,
                "zero_point": tree.zero_point}
        for k in ("values", "scale", "zero_point"):
            if tree[k] is not None:
                yield from _named_leaves(tree[k], f"{prefix}/{k}")
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k],
                                     f"{prefix}/{k}" if prefix else str(k))
        return
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}/{i}" if prefix else str(i))
        return
    yield prefix, tree


def _named_specs(rules: Rules, params):
    """(name, spec, leaf) for every leaf; the port's per-layer list is
    named as group 0's first layer and specced without its stack dim."""
    port_layers = isinstance(params.get("layers"), list) \
        and "groups" not in params
    for name, leaf in _named_leaves({k: v for k, v in params.items()
                                     if not (port_layers and k == "layers")}):
        yield name, rules.spec_for(name, tuple(leaf.shape)), leaf
    if port_layers:
        for i, lp in enumerate(params["layers"]):
            for sub, leaf in _named_leaves(lp):
                spec = rules.spec_for(f"groups/0/layers/0/{sub}",
                                      (1,) + tuple(leaf.shape))
                yield f"layers/{i}/{sub}", P(*spec[1:]), leaf


def _named_cache_specs(rules: Rules, caches):
    port = (isinstance(caches, list) and caches
            and isinstance(caches[0], dict))
    if port:
        for i, c in enumerate(caches):
            for key in sorted(c):
                spec = rules._cache_leaf_spec(f"{i}/0/{key}",
                                              (1,) + tuple(c[key].shape))
                yield f"{i}/0/{key}", P(*spec[1:])
        return
    for name, leaf in _named_leaves(caches):
        yield name, rules._cache_leaf_spec(name, tuple(leaf.shape))


# ---------------------------------------------------------------------------
# one rank's block
# ---------------------------------------------------------------------------


class ShardedParams(dict):
    """A parameter tree sliced to one rank's block by :func:`shard_params`;
    ``topology`` is ``(mesh fingerprint, rank)``, so a runtime can tell a
    block of its own mesh from a whole tree."""

    topology: tuple = ()


def _axis_index(mesh, entry) -> tuple[int, int]:
    """(size, this rank's index) of a spec entry: one axis, or a tuple of
    axes taken in row-major order."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    size, index = 1, 0
    for a in axes:
        n = int(mesh.shape[a])
        size, index = size * n, index * n + int(mesh.coords[a])
    return size, index


def shard_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: each sharded dim cut into
    equal contiguous blocks in axis order. A tensor with no sharded dim
    comes back as it is."""
    out = t
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        size, index = _axis_index(mesh, entry)
        if size == 1:
            continue
        n = t.shape[dim] // size
        out = out.narrow(dim, index * n, n)
    return out.contiguous() if out is not t else t


def shard_params(params: dict, rules: Rules, mesh) -> ShardedParams:
    """The rank's block of an already quantized (or float) port tree under
    ``rules``: int8 ``values``, per-channel scales along their weight's
    axis and biases along theirs are sliced; per-tensor scales, norms and
    the replicated leaves are the same tensors. Nothing is quantized
    here."""
    specs = {name: spec for name, spec, _ in _named_specs(rules, params)}

    def walk(node, prefix):
        if node is None:
            return None
        if isinstance(node, QuantizedTensor):
            return QuantizedTensor(
                walk(node.values, f"{prefix}/values"),
                walk(node.scale, f"{prefix}/scale"),
                walk(node.zero_point, f"{prefix}/zero_point"))
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(node))
        return shard_tensor(node, specs[prefix], mesh)

    out = ShardedParams(walk(params, ""))
    out.topology = (mesh_fingerprint(mesh), int(mesh.rank))
    return out
