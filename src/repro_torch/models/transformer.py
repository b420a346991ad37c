"""Config-driven model driver (port of ``repro.models.transformer``): BERT
encoders, rope / GQA / GLU decoders with their decode caches (gemma2's
local layers keep sliding-window rings beside its paged global layers), MoE
decoders (mixtral with sliding-window rings, deepseek-v2 with MLA and its
latent cache), the audio encoder (hubert, ``frames`` in), the vision
prefix-LM (paligemma, ``prefix_embeds`` before the tokens), and the
recurrent bodies: recurrentgemma's RG-LRU layers beside its local attention
and xlstm's mLSTM and sLSTM blocks, whose decode caches are recurrent
states. The training loss (:func:`lm_loss`) runs the same forward with no
compute backend, each layer optionally recomputed in the backward pass.

Parameters are ``{"embed", "layers": [one dict per layer], "final_norm",
["lm_head"], ["head"]}``: a plain Python list of per-layer dicts where the
JAX package stacks each execution group for ``lax.scan``. The execution
plan (:func:`build_plan`) is the same tuple of :class:`Group` runs as in the
JAX package; here it drives a Python loop over layers. Decode caches are
likewise a plain list with one dict per layer (:func:`init_caches`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.core.device import resolve_device
from repro_torch.core.precision import EncoderPolicy, LayerMode
from repro_torch.distributed import autograd as dist_ag
from repro_torch.kernels.backend import ffn_input_scale
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import xlstm as X

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
    kw = dict(device=device, dtype=dtype)
    norm1 = L.init_norm(cfg.norm_kind, cfg.d_model, **kw)
    if kind.body == "attn":
        return {"norm1": norm1,
                "attn": (L.init_mla(gen, cfg, **kw) if cfg.mla is not None
                         else L.init_attention(gen, cfg, **kw)),
                "norm2": L.init_norm(cfg.norm_kind, cfg.d_model, **kw),
                "ffn": (L.init_moe(gen, cfg, **kw) if kind.moe
                        else L.init_ffn(gen, cfg, **kw))}
    if kind.body == "rglru":
        return {"norm1": norm1, "rec": R.init_rglru(gen, cfg, **kw),
                "norm2": L.init_norm(cfg.norm_kind, cfg.d_model, **kw),
                "ffn": L.init_ffn(gen, cfg, **kw)}
    if kind.body == "mlstm":
        return {"norm1": norm1, "blk": X.init_mlstm(gen, cfg, **kw)}
    if kind.body == "slstm":
        return {"norm1": norm1, "blk": X.init_slstm(gen, cfg, **kw)}
    raise ValueError(f"unknown block body {kind.body!r}")


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
    # the meta device (abstract shapes) has no generator
    gen = (torch.Generator(device=device).manual_seed(seed)
           if device.type != "meta" else None)
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
                  quant_bmm=None, softmax=None, backend=None, cache=None,
                  active=None, pages=None, mesh=None, moe_groups=1,
                  data_shard=False):
    """One pre-LN attention layer: x + attn(norm1(x)), then
    x + ffn(norm2(x)); the fused backend collapses the add + norm2 +
    requantization into ``addnorm_quant`` when the ffn_in GEMM has a static
    int8 scale to feed. An MoE layer keeps the float residual boundary (a
    requantized attention output is dequantized) and runs
    :func:`~repro_torch.models.layers.moe_block` in place of the FFN. An
    MLA layer runs :func:`~repro_torch.models.layers.mla_block` (on the
    reference path) in place of the attention block. An RG-LRU layer runs
    x + rglru_mix(norm1(x)), then x + ffn(norm2(x)) (the FFN on
    ``backend``), and an mLSTM or sLSTM layer x + block(norm1(x)); their
    recurrent bodies run on the reference path, and ``cache`` is their
    recurrent state, which ``active`` gates. Returns x, or
    ``(x, new_cache)`` with a ``cache``. ``mesh``: the tensor-parallel
    forward of :mod:`repro_torch.models.layers` and the recurrent bodies;
    ``moe_groups`` and ``data_shard``: an MoE layer's token groups
    (:func:`~repro_torch.models.layers.moe_block`)."""
    if kind.body != "attn":
        return _recurrent_layer(x, lp, cfg, kind, obs=obs, backend=backend,
                                cache=cache, active=active, mesh=mesh)
    quant = L.AttnQuant(enabled=(mode.quant_mha if quant_bmm is None
                                 else quant_bmm),
                        softmax_mode=scheme.softmax_mode,
                        plan_scheme=softmax)
    # a vision prefix attends bidirectionally (prefix-LM)
    spec = L.MaskSpec(
        causal=cfg.causal,
        window=cfg.sliding_window if kind.local else None,
        prefix_len=cfg.num_prefix_embeds if cfg.frontend == "vision" else 0)
    h = L.norm(x, lp["norm1"], cfg.norm_kind)
    if cfg.mla is not None:
        a = L.mla_block(h, lp["attn"], cfg, positions=positions, spec=spec,
                        quant=quant, obs=obs, chunk=chunk, kv_cache=cache,
                        active=active, pages=pages, mesh=mesh)
    else:
        a = L.attention_block(h, lp["attn"], cfg, positions=positions,
                              spec=spec, quant=quant, obs=obs, chunk=chunk,
                              backend=backend, kv_cache=cache, active=active,
                              pages=pages, mesh=mesh)
    if cache is not None:
        a, new_cache = a
    ns = (ffn_input_scale(lp["ffn"], cfg.ffn_kind)
          if backend is not None and not kind.moe else None)
    x, h2 = L.residual_norm(a, x, lp["norm2"], cfg.norm_kind, next_scale=ns,
                            backend=backend)
    if kind.moe:
        x = x + L.moe_block(h2, lp["ffn"], cfg, obs=obs, backend=backend,
                            groups=moe_groups, mesh=mesh,
                            data_shard=data_shard)
    else:
        x = x + L.ffn_block(h2, lp["ffn"], cfg, obs=obs, backend=backend,
                            mesh=mesh)
    return x if cache is None else (x, new_cache)


def _recurrent_layer(x, lp, cfg: ArchConfig, kind: BlockKind, *, obs,
                     backend, cache, active, mesh):
    h = L.norm(x, lp["norm1"], cfg.norm_kind)
    if kind.body == "rglru":
        a, new_cache = R.rglru_mix(h, lp["rec"], cfg, obs=obs, state=cache,
                                   active=active, mesh=mesh)
        x = x + a
        h2 = L.norm(x, lp["norm2"], cfg.norm_kind)
        x = x + L.ffn_block(h2, lp["ffn"], cfg, obs=obs, backend=backend,
                            mesh=mesh)
    else:
        blk = X.mlstm_block if kind.body == "mlstm" else X.slstm_block
        a, new_cache = blk(h, lp["blk"], cfg, obs=obs, state=cache,
                           active=active, mesh=mesh)
        x = x + a
    return x if cache is None else (x, new_cache)


def run_groups(x, params, cfg: ArchConfig, plan: tuple[Group, ...],
               scheme: QuantScheme, *, positions, obs=None,
               chunk=DEFAULT_CHUNK, backend=None, caches=None, active=None,
               pages=None, remat: bool = False, mesh=None, moe_groups=1,
               data_shard=False):
    """Execute every layer of every group, in order. Observer capture
    (``obs`` not None) always runs the reference path and records each
    layer's sites as ``obs["layer{i}/{site}"]``. With ``caches`` (one per
    layer) returns ``(x, new_caches)``, else x.

    ``remat``: recompute each layer in the backward pass (activation
    checkpointing at layer granularity: only the residual stream between
    layers is saved). Observer capture and decode caches run without it,
    as the JAX package's observed layers do.

    ``mesh`` (the JAX package's ``constrain`` slot): a serving mesh whose
    model axis runs the tensor-parallel forward over ``params``, this
    rank's block, and whose data axis holds the MoE layers' experts
    (:func:`~repro_torch.models.layers.moe_block`). ``moe_groups`` is the
    MoE layers' token-group count over the rows ``x`` holds, and
    ``data_shard`` says that those rows are this rank's block of a batch
    the data axis split (one group). Observers see whole tensors only:
    calibration on a mesh splits batches, not layers
    (:func:`repro_torch.quant.ptq.capture_stats`), so it runs whole
    batches, one token group each, as the JAX package's observers do."""
    if obs is not None and L._tp(mesh) is not None:
        raise ValueError("observer capture runs unsharded params: "
                         "calibrate with capture_stats(mesh=...)")
    if obs is not None:
        backend = None
    remat = remat and obs is None and caches is None
    layers = params["layers"]
    new_caches = [] if caches is not None else None
    for g in plan:
        for s in range(g.steps):
            for j, kind in enumerate(g.kinds):
                idx = g.start + s * len(g.kinds) + j
                lobs = None
                if obs is not None:
                    lobs = {"__values__": True} if obs.get("__values__") \
                        else {}
                kw = dict(positions=positions, obs=lobs, chunk=chunk,
                          quant_bmm=g.quant_bmm, softmax=g.softmax,
                          backend=backend,
                          cache=None if caches is None else caches[idx],
                          active=active, pages=pages, mesh=mesh,
                          moe_groups=moe_groups, data_shard=data_shard)
                if remat:
                    x = checkpoint(layer_forward, x, layers[idx], cfg, kind,
                                   g.mode, scheme, use_reentrant=False, **kw)
                else:
                    x = layer_forward(x, layers[idx], cfg, kind, g.mode,
                                      scheme, **kw)
                if caches is not None:
                    x, nc = x
                    new_caches.append(nc)
                if obs is not None:
                    for site, v in lobs.pop("__raw__", {}).items():
                        obs.setdefault("__raw__", {})[
                            f"layer{idx}/{site}"] = v
                    lobs.pop("__values__", None)
                    for site, v in lobs.items():
                        obs[f"layer{idx}/{site}"] = v
    return x if caches is None else (x, new_caches)


def embed_inputs(params, batch: dict, cfg: ArchConfig, *, positions,
                 backend=None, mesh=None) -> torch.Tensor:
    """Map raw inputs to the first-layer activation per family: audio
    ``frames`` (B, T, frontend_dim) through ``frontend_proj``; tokens
    through the embedding, after a vision config's projected (and, for the
    gemma family, sqrt(d)-scaled) ``prefix_embeds`` (B, P, frontend_dim)
    when the batch has them."""
    emb = params["embed"]

    def frontend(feats):
        # frontend_proj's weight is column-parallel over d_model on a mesh
        # (its bias whole): the rank's columns, all-gathered as the
        # embedding tables' are
        p = emb["frontend_proj"]
        n = p["w"].shape[-1]
        if "b" in p:
            p = {**p, "b": L.tp_cols(p["b"], n, mesh)}
        return L.tp_whole(L.tp_dense(feats.to(torch.float32), p, cfg.d_model,
                                     mesh), cfg.d_model, mesh)
    if cfg.frontend == "audio":
        return frontend(batch["frames"])
    x = L.embed(batch["tokens"], emb, cfg, positions=positions,
                segments=batch.get("segments"), backend=backend, mesh=mesh)
    if cfg.frontend == "vision" and "prefix_embeds" in batch:
        pfx = frontend(batch["prefix_embeds"])
        if cfg.emb_scale_by_sqrt_dim:
            pfx = pfx * math.sqrt(cfg.d_model)
        x = torch.cat([pfx, x], dim=1)
    return x


def unembed(x, params, cfg: ArchConfig, mesh=None) -> torch.Tensor:
    """Logits over the vocab; on a tensor-parallel ``mesh`` a rank's
    vocab-parallel logits (its rows of a tied table, its columns of
    ``lm_head``) are all-gathered before the softcap."""
    if cfg.tie_embeddings:
        tok = params["embed"]["tok"]
        if tok.shape[0] != cfg.vocab_size:
            x = dist_ag.copy_to(x, mesh, "model")
        logits = torch.matmul(x, tok.t())
    else:
        logits = L.tp_dense(x, params["lm_head"], cfg.vocab_size, mesh)
    logits = L.tp_whole(logits, cfg.vocab_size, mesh)
    return L.softcap(logits, cfg.final_softcap)


def forward(params, batch: dict, cfg: ArchConfig, plan: tuple[Group, ...],
            scheme: QuantScheme = QuantScheme(), *,
            obs: Optional[dict] = None, chunk: Optional[int] = DEFAULT_CHUNK,
            return_hidden: bool = False, backend=None, caches=None, pos=None,
            active=None, pages=None, remat: bool = False, mesh=None,
            moe_groups: int = 1, data_shard: bool = False):
    """Full-sequence (encode, prefill) or incremental (decode) forward of
    token tensors ``batch["tokens"]`` (B, S) (+ ``"segments"``; audio
    configs take ``"frames"`` (B, T, frontend_dim) instead, vision configs
    ``"prefix_embeds"`` (B, P, frontend_dim) before the S tokens, P + S
    positions in all). Returns the
    final-norm hidden states when the params carry a task head (or
    ``return_hidden``), else the logits; with ``caches``, the pair
    ``(output, new_caches)``.

    Decode passes ``caches`` (:func:`init_caches`) and ``pos``: an int (a
    synchronized batch) or a (B,) tensor (continuous batching: per-row
    positions, with ``active`` (B,) bool gating idle slots' cache writes);
    ``pages`` is the (B, pages_per_slot) page table of paged caches.
    ``remat`` recomputes each layer in the backward pass, and ``mesh``
    runs the tensor-parallel forward over this rank's block of ``params``,
    with the MoE token groups ``moe_groups`` and ``data_shard``
    (:func:`run_groups`)."""
    lead = batch["frames"] if cfg.frontend == "audio" else batch["tokens"]
    S = lead.shape[1]
    if cfg.frontend == "vision" and "prefix_embeds" in batch:
        S += batch["prefix_embeds"].shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=lead.device)
    if pos is not None:
        pos = torch.as_tensor(pos, dtype=torch.int32, device=lead.device)
        positions = (positions[None] + pos[:, None] if pos.ndim == 1
                     else positions + pos)
    x = embed_inputs(params, batch, cfg, positions=positions,
                     backend=None if obs is not None else backend, mesh=mesh)
    x = run_groups(x, params, cfg, plan, scheme, positions=positions,
                   obs=obs, chunk=chunk, backend=backend, caches=caches,
                   active=active, pages=pages, remat=remat, mesh=mesh,
                   moe_groups=moe_groups, data_shard=data_shard)
    if caches is not None:
        x, caches = x
    x = L.norm(x, params["final_norm"], cfg.norm_kind)
    if not (return_hidden or "head" in params):
        x = unembed(x, params, cfg, mesh)
    return x if caches is None else (x, caches)


def apply_head(hidden, params, kind: str) -> torch.Tensor:
    """Downstream-task module (paper §3.1): classification / matching pool
    the CLS position; NER tags every token."""
    if kind == "cls":
        pooled = torch.tanh(L.dense(hidden[:, 0], params["head"]["pool"]))
        return L.dense(pooled, params["head"]["out"])
    if kind == "ner":
        return L.dense(hidden, params["head"]["out"])
    raise ValueError(f"unknown head kind {kind!r}")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits`` (float32
    logsumexp); with ``mask``, the mean over its nonzero positions."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0] - lse
    nll = -ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def lm_loss(params, batch: dict, cfg: ArchConfig, plan,
            scheme: QuantScheme = QuantScheme(), *, remat: bool = False,
            chunk: Optional[int] = DEFAULT_CHUNK, **kw) -> torch.Tensor:
    """Next-token CE for decoder LMs; frame CE for audio (``labels`` (B, T));
    the text region only for vision; head CE for params with a task head
    (``ner`` when ``labels`` is (B, S), else ``cls``). The forward runs
    without a compute backend: training is float, as in the JAX package.
    ``kw`` goes to :func:`forward` (a training mesh's ``mesh``,
    ``moe_groups`` and ``data_shard``)."""
    if "head" in params:
        hidden = forward(params, batch, cfg, plan, scheme, remat=remat,
                         chunk=chunk, **kw)
        kind = "ner" if batch["labels"].ndim == 2 else "cls"
        return cross_entropy(apply_head(hidden, params, kind),
                             batch["labels"])
    logits = forward(params, batch, cfg, plan, scheme, remat=remat,
                     chunk=chunk, **kw)
    if cfg.frontend == "audio":
        return cross_entropy(logits, batch["labels"])
    if cfg.frontend == "vision":
        # loss over the text region only
        logits = logits[:, batch["prefix_embeds"].shape[1]:]
    tokens = batch["tokens"]
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


def _layer_cache(cfg: ArchConfig, kind: BlockKind, batch: int, max_len: int,
                 dtype, device, *, page_size: Optional[int] = None,
                 num_pages: int = 0, kv_scheme: str = "float",
                 kv_heads: Optional[int] = None, mesh=None) -> dict:
    if kind.body == "rglru":
        return R.init_state(cfg, batch, dtype, device, mesh)
    if kind.body == "mlstm":
        return X.mlstm_state(cfg, batch, dtype, device, mesh)
    if kind.body == "slstm":
        return X.slstm_state(cfg, batch, dtype, device, mesh)
    H, hd = kv_heads or cfg.num_kv_heads, cfg.head_dim
    kw = dict(device=device)
    # a local (sliding-window) layer keeps its dense ring of W positions
    # even when the engine pages: the ring is already W-bounded, and its
    # KV scheme is inert, as in the JAX package
    W = min(cfg.sliding_window, max_len) if kind.local else max_len
    m = cfg.mla
    if page_size is not None and not kind.local:
        # pooled token pages + per-slot pos; the (B, pages_per_slot) page
        # table is a separate operand (PagePool), not a cache entry
        ps, NP = page_size, num_pages
        if m is not None:
            # MLA pages its latent, in the cache dtype: it is already the
            # compressed form, and the KV scheme is inert
            return {"pages_ckv": torch.zeros((NP, ps, m.kv_lora_rank),
                                             dtype=dtype, **kw),
                    "pages_krope": torch.zeros((NP, ps, m.qk_rope_dim),
                                               dtype=dtype, **kw),
                    "pages_pos": torch.full((NP, ps), -1, dtype=torch.int32,
                                            **kw),
                    "pos": torch.zeros((batch,), dtype=torch.int32, **kw)}
        kv_dtype = torch.int8 if kv_scheme.startswith("int8") else dtype
        d = {"pages_k": torch.zeros((NP, ps, H, hd), dtype=kv_dtype, **kw),
             "pages_v": torch.zeros((NP, ps, H, hd), dtype=kv_dtype, **kw),
             "pages_pos": torch.full((NP, ps), -1, dtype=torch.int32, **kw),
             "pos": torch.zeros((batch,), dtype=torch.int32, **kw)}
        if kv_scheme == "int8_per_token":
            d["pages_ks"] = torch.zeros((NP, ps, H), dtype=torch.float32,
                                        **kw)
            d["pages_vs"] = torch.zeros((NP, ps, H), dtype=torch.float32,
                                        **kw)
        return d
    if m is not None:
        return {"ckv": torch.zeros((batch, W, m.kv_lora_rank), dtype=dtype,
                                   **kw),
                "krope": torch.zeros((batch, W, m.qk_rope_dim), dtype=dtype,
                                     **kw),
                "k_pos": torch.full((batch, W), -1, dtype=torch.int32, **kw),
                "pos": torch.zeros((batch,), dtype=torch.int32, **kw)}
    return {"k": torch.zeros((batch, W, H, hd), dtype=dtype, **kw),
            "v": torch.zeros((batch, W, H, hd), dtype=dtype, **kw),
            "k_pos": torch.full((batch, W), -1, dtype=torch.int32, **kw),
            "pos": torch.zeros((batch,), dtype=torch.int32, **kw)}


def pages_per_slot(max_len: int, page_size: int) -> int:
    return -(-max_len // page_size)


def init_caches(cfg: ArchConfig, plan: tuple[Group, ...], batch: int,
                max_len: int, dtype=torch.float32, *,
                page_size: Optional[int] = None,
                num_pages: Optional[int] = None,
                kv_schemes: Optional[Sequence[str]] = None,
                device: Union[str, torch.device] = "cuda",
                mesh=None) -> list:
    """Decode caches, one dict per layer. ``page_size`` switches the
    full-attention layers to the paged layout (see
    :mod:`repro_torch.models.layers`; local layers keep their ring of
    min(sliding_window, max_len) positions); ``num_pages``
    sizes the shared page pool (default ``batch * pages_per_slot``: no
    oversubscription); ``kv_schemes`` gives each layer's KV-cache scheme
    (``PrecisionPlan.kv_schemes``), default all float. A scheme may not
    change inside an execution group, as in the JAX package, whose scan
    groups share one cache layout. On a tensor-parallel ``mesh`` the
    attention caches hold the rank's KV heads
    (:func:`~repro_torch.models.layers.local_kv_heads`), an MLA cache the
    whole latent, and a recurrent state the rank's channels or heads;
    ``batch`` is the slots this rank holds."""
    device = resolve_device(device)
    kv_heads = L.local_kv_heads(cfg, mesh)
    if page_size is not None and num_pages is None:
        num_pages = batch * pages_per_slot(max_len, page_size)
    kinds = cfg.layer_kinds()
    caches = []
    for g in plan:
        for li in range(g.start, g.stop):
            if kv_schemes is not None and \
                    kv_schemes[li] != kv_schemes[g.start]:
                raise ValueError(
                    f"kv_cache scheme changes inside execution group "
                    f"[{g.start}, {g.stop}) at layer {li}; rebuild the "
                    f"execution plan from the PrecisionPlan")
            scheme = kv_schemes[li] if kv_schemes is not None else "float"
            caches.append(_layer_cache(cfg, kinds[li], batch, max_len, dtype,
                                       device, page_size=page_size,
                                       num_pages=num_pages or 0,
                                       kv_scheme=scheme, kv_heads=kv_heads,
                                       mesh=mesh))
    return caches


def cache_slots(caches) -> int:
    """The batch slots a cache list holds: its first layer's ``pos`` (an
    attention cache) or leading axis (a recurrent state)."""
    c = caches[0]
    return int(c["pos"].shape[0] if "pos" in c
               else next(iter(c.values())).shape[0])


def cache_bytes(caches) -> int:
    """Total KV and recurrent-state footprint in bytes, every tensor of
    every layer."""
    return int(sum(t.numel() * t.element_size()
                   for c in caches for t in c.values()))


def kv_geometry(caches) -> tuple:
    """Structural (scheme, page_size, num_pages) summary of the caches: part
    of the runtime's callable key, so float and int8 caches, and different
    page geometries, never share an entry."""
    ps = np_ = None
    has_scales = has_int8 = False
    for c in caches:
        if "pages_pos" in c:
            np_, ps = (int(n) for n in c["pages_pos"].shape)
        has_scales |= "pages_ks" in c or "pages_vs" in c
        has_int8 |= any(c[k].dtype == torch.int8
                        for k in ("pages_k", "pages_v") if k in c)
    scheme = ("int8_per_token" if has_scales
              else "int8_per_head" if has_int8 else "float")
    return (scheme, ps, np_)


def decode_step(params, tokens, caches, pos, cfg: ArchConfig, plan,
                scheme: QuantScheme = QuantScheme(), *, active=None,
                pages=None, backend=None, mesh=None, moe_groups=1,
                data_shard=False):
    """One serving step: tokens (B, 1) at absolute position(s) ``pos`` (an
    int: a synchronized batch; (B,): continuous batching, with ``active``
    gating idle slots). ``pages`` is the (B, pages_per_slot) page table of
    paged caches. Returns (logits (B, 1, V), new_caches)."""
    return forward(params, {"tokens": tokens}, cfg, plan, scheme,
                   caches=caches, pos=pos, active=active, chunk=None,
                   pages=pages, backend=backend, mesh=mesh,
                   moe_groups=moe_groups, data_shard=data_shard)
