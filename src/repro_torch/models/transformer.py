"""Config-driven encoder model (port of ``repro.models.transformer``, the
attention-body subset).

Parameters are ``{"embed", "layers": [one dict per layer], "final_norm",
["lm_head"], ["head"]}``: a plain Python list of per-layer dicts where the
JAX package stacks each execution group for ``lax.scan``. The execution
plan (:func:`build_plan`) is the same tuple of :class:`Group` runs as in the
JAX package; here it drives a Python loop over layers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.core.device import resolve_device
from repro_torch.core.precision import EncoderPolicy, LayerMode
from repro_torch.kernels.backend import ffn_input_scale
from repro_torch.models import layers as L

DEFAULT_CHUNK = 512          # query-block size for attention


@dataclasses.dataclass(frozen=True)
class QuantScheme:
    """Numeric scheme knobs orthogonal to the per-layer policy lattice."""
    softmax_mode: str = "symmetric"   # paper default; 'unsigned' = the fix
    dynamic_acts: bool = False        # per-token activation quant (no xs)


@dataclasses.dataclass(frozen=True)
class Group:
    """One execution group: layers [start, stop), all in ``mode``, whose
    kind-sequence is ``kinds`` repeated ``steps`` times. ``quant_bmm`` gates
    the attention int8 bmms (None = follow the mode); ``softmax`` is the
    schema-v3 per-layer softmax scheme (None = the global QuantScheme)."""
    start: int
    stop: int
    mode: LayerMode
    kinds: tuple[BlockKind, ...]
    steps: int
    quant_bmm: Optional[bool] = None
    softmax: Optional[str] = None


def build_plan(cfg: ArchConfig, policy) -> tuple[Group, ...]:
    """Execution plan for an ``EncoderPolicy`` or a ``PrecisionPlan``: the
    same greedy maximal runs as the JAX package's, so both packages group
    (and the carried-across parameter trees unstack) identically."""
    if policy.num_layers != cfg.num_layers:
        raise ValueError(
            f"policy has {policy.num_layers} layers, arch {cfg.num_layers}")
    kinds = cfg.layer_kinds()
    p = len(cfg.pattern)
    groups: list[Group] = []
    bmm_fn = getattr(policy, "bmm_quantized", None)
    sm_fn = getattr(policy, "softmax_scheme", None)
    for (s, e, mode) in policy.group_boundaries():
        quant_bmm = bmm_fn(s) if bmm_fn is not None else mode.quant_mha
        sm = sm_fn(s) if sm_fn is not None else None
        sm = None if sm == "float" else sm
        i = s
        while i < e:
            j1 = i + 1
            while j1 < e and kinds[j1] == kinds[i]:
                j1 += 1
            jp = i
            if p > 1 and i + p <= e:
                period = tuple(kinds[i:i + p])
                jp = i + p
                while jp + p <= e and tuple(kinds[jp:jp + p]) == period:
                    jp += p
            if jp - i > max(j1 - i, p):
                groups.append(Group(i, jp, mode, tuple(kinds[i:i + p]),
                                    (jp - i) // p, quant_bmm, sm))
                i = jp
            else:
                groups.append(Group(i, j1, mode, (kinds[i],), j1 - i,
                                    quant_bmm, sm))
                i = j1
    return tuple(groups)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ArchConfig, kind: BlockKind, *,
               device=None, dtype=torch.float32) -> dict:
    if kind.body != "attn" or kind.moe or cfg.mla is not None:
        raise NotImplementedError(
            f"layer body {kind} is not ported yet (attention bodies only)")
    kw = dict(device=device, dtype=dtype)
    return {"norm1": L.init_norm(cfg.norm_kind, cfg.d_model, **kw),
            "attn": L.init_attention(gen, cfg, **kw),
            "norm2": L.init_norm(cfg.norm_kind, cfg.d_model, **kw),
            "ffn": L.init_ffn(gen, cfg, **kw)}


def init_params(cfg: ArchConfig, policy=None, *, seed: int = 0,
                head: Optional[tuple[str, int]] = None,
                device: Union[str, torch.device] = "cuda",
                dtype=torch.float32) -> dict:
    """Float parameter init from ``seed`` (a ``torch.Generator`` on
    ``device``). Quantized params come from these via
    :func:`repro_torch.quant.ptq.apply_plan`. The weights are random like
    the JAX package's, but not the same numbers: parity tests carry JAX
    parameters across with :func:`repro_torch.interop.params_from_numpy`."""
    device = resolve_device(device)
    policy = policy or EncoderPolicy.full_float(cfg.num_layers)
    plan = build_plan(cfg, policy)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, dtype=dtype)
    params: dict = {"embed": L.init_embeddings(gen, cfg, **kw)}
    kinds = cfg.layer_kinds()
    params["layers"] = [init_layer(gen, cfg, kinds[i], **kw)
                        for g in plan for i in range(g.start, g.stop)]
    params["final_norm"] = L.init_norm(cfg.norm_kind, cfg.d_model, **kw)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                          False, **kw)
    if head is not None:
        kind, n_out = head
        if kind == "cls":     # CLS-pool classifier (classification/matching)
            params["head"] = {"pool": L.init_linear(gen, cfg.d_model,
                                                    cfg.d_model, True, **kw),
                              "out": L.init_linear(gen, cfg.d_model, n_out,
                                                   True, **kw)}
        elif kind == "ner":   # per-token tagger
            params["head"] = {"out": L.init_linear(gen, cfg.d_model, n_out,
                                                   True, **kw)}
        else:
            raise ValueError(f"unknown head kind {kind!r}")
    return params


def unpack_layers(params: dict, plan: tuple[Group, ...]) -> list:
    """Per-layer list of ``params`` (the port keeps layers unstacked, so
    this checks the count against ``plan`` and copies the list)."""
    layers = list(params["layers"])
    n = sum(g.stop - g.start for g in plan)
    if len(layers) != n:
        raise ValueError(f"params hold {len(layers)} layers, plan {n}")
    return layers


def pack_layers(layer_list: Sequence, plan: tuple[Group, ...]) -> list:
    """Per-layer list -> the params' ``layers`` entry for ``plan``."""
    n = sum(g.stop - g.start for g in plan)
    if len(layer_list) != n:
        raise ValueError(f"{len(layer_list)} layers for a plan of {n}")
    return list(layer_list)


def repack(params: dict, old_plan: tuple[Group, ...],
           new_plan: tuple[Group, ...], transform=None) -> dict:
    """Re-pack ``params`` from ``old_plan`` to ``new_plan``, optionally
    applying ``transform(layer_idx, layer_params)`` per layer."""
    layers = unpack_layers(params, old_plan)
    if transform is not None:
        layers = [transform(i, lp) for i, lp in enumerate(layers)]
    out = dict(params)
    out["layers"] = pack_layers(layers, new_plan)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def layer_forward(x, lp, cfg: ArchConfig, kind: BlockKind, mode: LayerMode,
                  scheme: QuantScheme, *, positions, obs, chunk,
                  quant_bmm=None, softmax=None, backend=None):
    """One pre-LN attention layer: x + attn(norm1(x)), then
    x + ffn(norm2(x)); the fused backend collapses the add + norm2 +
    requantization into ``addnorm_quant`` when the ffn_in GEMM has a static
    int8 scale to feed."""
    if kind.body != "attn" or kind.moe or cfg.mla is not None:
        raise NotImplementedError(f"layer body {kind} is not ported yet")
    quant = L.AttnQuant(enabled=(mode.quant_mha if quant_bmm is None
                                 else quant_bmm),
                        softmax_mode=scheme.softmax_mode,
                        plan_scheme=softmax)
    spec = L.MaskSpec(causal=cfg.causal,
                      window=cfg.sliding_window if kind.local else None)
    h = L.norm(x, lp["norm1"], cfg.norm_kind)
    a = L.attention_block(h, lp["attn"], cfg, positions=positions, spec=spec,
                          quant=quant, obs=obs, chunk=chunk, backend=backend)
    ns = (ffn_input_scale(lp["ffn"], cfg.ffn_kind)
          if backend is not None else None)
    x, h2 = L.residual_norm(a, x, lp["norm2"], cfg.norm_kind, next_scale=ns,
                            backend=backend)
    return x + L.ffn_block(h2, lp["ffn"], cfg, obs=obs, backend=backend)


def run_groups(x, params, cfg: ArchConfig, plan: tuple[Group, ...],
               scheme: QuantScheme, *, positions, obs=None,
               chunk=DEFAULT_CHUNK, backend=None):
    """Execute every layer of every group, in order. Observer capture
    (``obs`` not None) always runs the reference path and records each
    layer's sites as ``obs["layer{i}/{site}"]``."""
    if obs is not None:
        backend = None
    layers = params["layers"]
    for g in plan:
        for s in range(g.steps):
            for j, kind in enumerate(g.kinds):
                idx = g.start + s * len(g.kinds) + j
                lobs = None
                if obs is not None:
                    lobs = {"__values__": True} if obs.get("__values__") \
                        else {}
                x = layer_forward(x, layers[idx], cfg, kind, g.mode, scheme,
                                  positions=positions, obs=lobs, chunk=chunk,
                                  quant_bmm=g.quant_bmm, softmax=g.softmax,
                                  backend=backend)
                if obs is not None:
                    for site, v in lobs.pop("__raw__", {}).items():
                        obs.setdefault("__raw__", {})[
                            f"layer{idx}/{site}"] = v
                    lobs.pop("__values__", None)
                    for site, v in lobs.items():
                        obs[f"layer{idx}/{site}"] = v
    return x


def embed_inputs(params, batch: dict, cfg: ArchConfig, *, positions,
                 backend=None) -> torch.Tensor:
    """Map token inputs to the first-layer activation."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.frontend!r} front-ends are not ported yet")
    return L.embed(batch["tokens"], params["embed"], cfg,
                   positions=positions, segments=batch.get("segments"),
                   backend=backend)


def unembed(x, params, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"]["tok"].t())
    else:
        logits = L.dense(x, params["lm_head"])
    return L.softcap(logits, cfg.final_softcap)


def forward(params, batch: dict, cfg: ArchConfig, plan: tuple[Group, ...],
            scheme: QuantScheme = QuantScheme(), *,
            obs: Optional[dict] = None, chunk: Optional[int] = DEFAULT_CHUNK,
            return_hidden: bool = False, backend=None) -> torch.Tensor:
    """Full-sequence forward of token tensors ``batch["tokens"]`` (B, S)
    (+ ``"segments"``). Returns the final-norm hidden states when the params
    carry a task head (or ``return_hidden``), else the logits."""
    S = batch["tokens"].shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=batch["tokens"].device)
    x = embed_inputs(params, batch, cfg, positions=positions,
                     backend=None if obs is not None else backend)
    x = run_groups(x, params, cfg, plan, scheme, positions=positions,
                   obs=obs, chunk=chunk, backend=backend)
    x = L.norm(x, params["final_norm"], cfg.norm_kind)
    if return_hidden or "head" in params:
        return x
    return unembed(x, params, cfg)


def apply_head(hidden, params, kind: str) -> torch.Tensor:
    """Downstream-task module (paper §3.1): classification / matching pool
    the CLS position; NER tags every token."""
    if kind == "cls":
        pooled = torch.tanh(L.dense(hidden[:, 0], params["head"]["pool"]))
        return L.dense(pooled, params["head"]["out"])
    if kind == "ner":
        return L.dense(hidden, params["head"]["out"])
    raise ValueError(f"unknown head kind {kind!r}")
