"""Post-training quantization: apply a precision plan to float params (port
of ``repro.quant.ptq``).

    float params --capture_stats(calibration batches)--> amax per (layer, site)
                 --apply_plan(PrecisionPlan)--> mixed-precision params + plan

Per layer and GEMM block, the plan's QuantSpec names the weight scheme
(int8 per channel or per tensor), the activation scheme (static per-tensor
``xs`` from the calibrator, or per-token dynamic: no ``xs``) and the
calibrator. A statically quantized qkv block also gets the attention bmm
scales ``{q,k,p,v}_scale``. The schema-v3 dataflow fields attach their
kernel operands: ``softmax='uint8'`` an unsigned ``p_scale`` (amax / 255),
``norm='int8'`` the requant scales ``out_xs`` of the attn_out GEMM (from the
pre-norm ``attn_delta`` site) and of a GELU FFN's input GEMM (from
``ffn_hidden``). The schema-v2 ``kv_cache='int8_per_head'`` attaches the
static per-head KV-cache scales ``kc_scale``/``vc_scale`` from the per-head
``k_cache``/``v_cache`` sites, and a layer that quantizes only its KV cache
under ``softmax='uint8'`` gets the decode-side ``p_scale``. On MoE layers
the schema-v4 ``experts`` family governs the routed expert stacks
(per-expert-per-channel weight scales (E, 1, F); static activation scales
per expert, (E, 1, 1), from the (E,) ``expert_in``/``expert_hidden``
vectors) and ``shared_ffn`` the shared expert's GEMMs. An MLA layer's qkv
block covers its query and latent projections (``wq_a``, ``wq_b``,
``wkv_a``, ``wkv_b``), observed at ``attn_in``, ``q_lat`` and ``c_kv``.
The recurrent bodies' projections (an RG-LRU layer's, and its FFN; an
mLSTM or sLSTM block's) are FFN-group GEMMs; the attention-only operands
(the bmm scales, ``p_scale``, the span, the KV-cache scales) go to
attention layers alone.

``capture_stats(clusters=)`` is the input-adaptive capture: per-row cluster
ids partition the calibration rows, and the stats come back keyed
``{cluster: {layer: {site: amax}}}``.
"""
from __future__ import annotations

import inspect
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, BlockKind
from repro_torch.core.calibration import (CALIBRATORS, Calibrator,
                                          make_calibrator)
from repro_torch.core.plan import LayerPlan, PlanSet, PrecisionPlan
from repro_torch.core.quantize import (UINT8_MAX, QuantizedTensor,
                                       compute_scale_symmetric, divide,
                                       quantize)
from repro_torch.models import transformer as T

# (group, param_path, site, block): ``block`` is the PrecisionPlan block
# whose QuantSpec governs the weight; ``site`` the activation observation
# feeding the GEMM.
SITE_MAP: dict[str, list[tuple[str, tuple[str, ...], str, str]]] = {
    "attn": [
        ("mha", ("attn", "wq"), "attn_in", "qkv"),
        ("mha", ("attn", "wk"), "attn_in", "qkv"),
        ("mha", ("attn", "wv"), "attn_in", "qkv"),
        ("mha", ("attn", "wo"), "attn_out", "attn_out"),
    ],
    "attn_mla": [
        ("mha", ("attn", "wq_a"), "attn_in", "qkv"),
        ("mha", ("attn", "wq_b"), "q_lat", "qkv"),
        ("mha", ("attn", "wq"), "attn_in", "qkv"),   # q_lora_rank == 0
        ("mha", ("attn", "wkv_a"), "attn_in", "qkv"),
        ("mha", ("attn", "wkv_b"), "c_kv", "qkv"),
        ("mha", ("attn", "wo"), "attn_out", "attn_out"),
    ],
    "ffn_glu": [
        ("ffn", ("ffn", "wg"), "ffn_in", "ffn_in"),
        ("ffn", ("ffn", "wu"), "ffn_in", "ffn_in"),
        ("ffn", ("ffn", "wd"), "ffn_hidden", "ffn_out"),
    ],
    "ffn_gelu": [
        ("ffn", ("ffn", "wi"), "ffn_in", "ffn_in"),
        ("ffn", ("ffn", "wo"), "ffn_hidden", "ffn_out"),
    ],
    "moe": [
        ("ffn", ("ffn", "wg"), "ffn_in_e", "ffn_in"),
        ("ffn", ("ffn", "wu"), "ffn_in_e", "ffn_in"),
        ("ffn", ("ffn", "wd"), "ffn_hidden", "ffn_out"),
        ("ffn", ("ffn", "shared", "wg"), "shared_ffn_in", "ffn_in"),
        ("ffn", ("ffn", "shared", "wu"), "shared_ffn_in", "ffn_in"),
        ("ffn", ("ffn", "shared", "wd"), "shared_ffn_hidden", "ffn_out"),
    ],
    # the recurrent bodies' projections form the FFN group
    "rglru": [
        ("ffn", ("rec", "wx"), "rec_in", "ffn_in"),
        ("ffn", ("rec", "wg"), "rec_in", "ffn_in"),
        ("ffn", ("rec", "wa"), "rec_gate_in", "ffn_in"),
        ("ffn", ("rec", "wi"), "rec_gate_in", "ffn_in"),
        ("ffn", ("rec", "wo"), "rec_out", "ffn_out"),
    ],
    "mlstm": [
        ("ffn", ("blk", "up"), "blk_in", "ffn_in"),
        ("ffn", ("blk", "wq"), "qkv_in", "ffn_in"),
        ("ffn", ("blk", "wk"), "qkv_in", "ffn_in"),
        ("ffn", ("blk", "wif"), "qkv_in", "ffn_in"),
        ("ffn", ("blk", "wv"), "xm", "ffn_in"),
        ("ffn", ("blk", "down"), "blk_hidden", "ffn_out"),
    ],
    "slstm": [
        ("ffn", ("blk", "wz"), "blk_in", "ffn_in"),
        ("ffn", ("blk", "wo"), "blk_in", "ffn_in"),
        ("ffn", ("blk", "wi"), "blk_conv_in", "ffn_in"),
        ("ffn", ("blk", "wf"), "blk_conv_in", "ffn_in"),
        ("ffn", ("blk", "proj"), "blk_hidden", "ffn_out"),
    ],
}

BMM_SITES = ("q", "k", "p", "v")    # attention batched-matmul operands

SITE_BLOCK: dict[str, str] = {
    site: block
    for entries in SITE_MAP.values()
    for (_g, _p, site, block) in entries
}
SITE_BLOCK.update({s: "qkv" for s in BMM_SITES})
SITE_BLOCK["attn_delta"] = "attn_out"
# the per-expert vector sites recorded inside the routed expert GEMMs ride
# the experts family (LayerPlan.spec resolves its pre-v4 fallback)
SITE_BLOCK["expert_in"] = "experts"
SITE_BLOCK["expert_hidden"] = "experts"

HIST_SITES = ("attn_in", "attn_out", "attn_delta", "ffn_in", "ffn_hidden",
              "p")


def _kind_entries(cfg: ArchConfig, kind: BlockKind):
    """The SITE_MAP entries of one layer body: an attention layer's
    attention and FFN (or MoE), an RG-LRU layer's recurrence projections and
    its FFN, an xLSTM layer's block."""
    ffn = "ffn_glu" if cfg.ffn_kind == "glu" else "ffn_gelu"
    if kind.body == "attn":
        return SITE_MAP["attn_mla" if cfg.mla is not None else "attn"] + \
            SITE_MAP["moe" if kind.moe else ffn]
    if kind.body == "rglru":
        return SITE_MAP["rglru"] + SITE_MAP[ffn]
    return SITE_MAP[kind.body]


def _entry_spec(layer: LayerPlan, kind: BlockKind, path: tuple[str, ...],
                block: str):
    """The QuantSpec governing one SITE_MAP entry, and the per-expert vector
    amax site ('expert_in' / 'expert_hidden') when the entry is a routed
    expert stack under the ``experts`` family (its static scales are then
    per expert), else None. On MoE layers the v4 families override the
    block's spec: ``experts`` the routed stacks, ``shared_ffn`` the shared
    expert."""
    if kind.moe and path[0] == "ffn":
        if path[1] == "shared":
            if layer.shared_ffn is not None:
                return layer.shared_ffn, None
        elif layer.experts is not None:
            return layer.experts, ("expert_hidden" if path[1] == "wd"
                                   else "expert_in")
    return layer.spec(block), None


def quantize_weight(w: torch.Tensor,
                    scheme: str = "int8_per_channel") -> QuantizedTensor:
    """Symmetric int8 weight quantization: ``int8_per_channel`` (scale
    (1, N) for a (K, N) weight) or ``int8_per_tensor`` (scale (1, 1))."""
    if scheme == "int8_per_tensor":
        amax = w.abs().max().reshape((1,) * w.ndim)
    elif scheme == "int8_per_channel":
        reduce_axes = ((w.ndim - 2,) if w.ndim == 3
                       else tuple(range(w.ndim - 1)))
        amax = torch.amax(w.abs(), dim=reduce_axes, keepdim=True)
    else:
        raise ValueError(f"unknown weight scheme {scheme!r}")
    scale = compute_scale_symmetric(amax)
    return QuantizedTensor(quantize(w, scale), scale, None)


def _scale_of(amax: float, device) -> torch.Tensor:
    """A calibrated amax -> 0-d float32 scale tensor, computed as the JAX
    package computes it (``compute_scale_symmetric(jnp.float32(amax))``)."""
    return compute_scale_symmetric(
        torch.tensor(amax, dtype=torch.float32, device=device))


def _get_path(d: dict, path: tuple[str, ...]):
    for k in path:
        if not isinstance(d, dict) or k not in d:
            return None
        d = d[k]
    return d


def _set_path(d: dict, path: tuple[str, ...], value) -> None:
    for k in path[:-1]:
        d = d[k]
    d[path[-1]] = value


def _copy_dicts(tree):
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_dicts(v) for v in tree)
    return tree


def _unsigned_scale(amax: float, device) -> torch.Tensor:
    """The uint8 softmax scale: max(amax, 1e-8) / 255, a float32 division
    as the JAX package computes it."""
    return divide(torch.tensor(max(amax, 1e-8), dtype=torch.float32,
                               device=device), float(UINT8_MAX))


def quantize_layer(lp: dict, cfg: ArchConfig, kind: BlockKind,
                   layer: LayerPlan, amax: dict, scheme: T.QuantScheme
                   ) -> dict:
    """A quantized copy of one layer's params under ``layer``; ``amax``
    maps site name -> calibrated amax for THIS layer (a list of per-head
    values at the ``k_cache``/``v_cache`` sites, of per-expert values at
    ``expert_in``/``expert_hidden``)."""
    if not (layer.quant_mha or layer.quant_ffn
            or layer.kv_cache != "float"):
        return lp
    lp = _copy_dicts(lp)                     # containers copied, leaves shared
    for _group, path, site, block in _kind_entries(cfg, kind):
        spec, expert_site = _entry_spec(layer, kind, path, block)
        if not spec.quantized:
            continue
        sub = _get_path(lp, path)
        if sub is None:
            continue
        new = dict(sub)
        new["w"] = quantize_weight(sub["w"], spec.weight)
        dev = sub["w"].device
        if spec.static_acts and expert_site is not None:
            # per-expert static scales from the (E,) amax vector recorded
            # inside the routed GEMMs, shaped to broadcast on (G, E, C, D)
            if expert_site not in amax:
                raise ValueError(
                    f"experts family with act='int8_per_tensor' needs "
                    f"calibrated {expert_site!r} stats for this layer; "
                    f"re-run capture_stats (or use act='int8_per_token')")
            new["xs"] = compute_scale_symmetric(torch.tensor(
                amax[expert_site], dtype=torch.float32,
                device=dev)).reshape(-1, 1, 1)
        elif spec.static_acts and site in amax:
            new["xs"] = _scale_of(amax[site], dev)
        _set_path(lp, path, new)
    if kind.body != "attn":
        # the bmm scales, p_scale, the int8 norm span and the KV-cache
        # scales belong to attention layers
        return lp
    attn = lp["attn"]
    w = attn["wo"]["w"]
    dev = (w.values if isinstance(w, QuantizedTensor) else w).device
    if layer.qkv.quantized and layer.qkv.static_acts:
        for s in BMM_SITES:
            if s not in amax:
                continue
            if s == "p" and (scheme.softmax_mode == "unsigned"
                             or layer.softmax == "uint8"):
                # softmax outputs live in [0, 1]: asymmetric unsigned scale
                # (amax / 255, zero point -128) uses the whole code space;
                # softmax='uint8' forces it per layer
                attn["p_scale"] = _unsigned_scale(amax[s], dev)
            else:
                attn[f"{s}_scale"] = _scale_of(amax[s], dev)
    elif layer.softmax == "uint8" and "p" in amax:
        # a per-token qkv block, or a layer that quantizes only its KV
        # cache: the decode kernel requantizes the probabilities at p_scale
        attn["p_scale"] = _unsigned_scale(amax["p"], dev)
    if layer.norm == "int8":
        # whole-layer int8 span: the attn_out GEMM requantizes its output
        # (the pre-norm residual delta), so the fused add+norm takes int8
        if "attn_delta" not in amax:
            raise ValueError(
                "norm='int8' needs calibrated attn_delta stats for this "
                "layer; re-run capture_stats on this plan")
        attn["wo"] = dict(attn["wo"],
                          out_xs=_scale_of(amax["attn_delta"], dev))
        if (cfg.ffn_kind != "glu" and not kind.moe
                and layer.ffn_out.quantized
                and layer.ffn_out.static_acts and "ffn_hidden" in amax):
            # the span runs on through the FFN: wi requantizes its GELU'd
            # hidden at the scale the FFN's wo consumes it at (its own xs),
            # so the boundary is numerics-neutral through wo. A GLU hidden
            # is the product of two GEMMs and keeps the float boundary
            lp["ffn"]["wi"] = dict(lp["ffn"]["wi"], out_xs=_scale_of(
                amax["ffn_hidden"], dev))
    if layer.kv_cache == "int8_per_head":
        # static KV-cache scales from the per-head amax vectors of the
        # k_cache / v_cache sites (after rope)
        for key, site in (("k", "k_cache"), ("v", "v_cache")):
            if site not in amax:
                raise ValueError(
                    f"kv_cache='int8_per_head' needs calibrated {site} "
                    f"stats for this layer; re-run capture_stats on this "
                    f"plan (or use kv_cache='int8_per_token')")
            attn[f"{key}c_scale"] = compute_scale_symmetric(torch.tensor(
                amax[site], dtype=torch.float32, device=dev))
    return lp


def capture_stats(params: dict, batches: Sequence[dict], cfg: ArchConfig,
                  plan, scheme: T.QuantScheme = T.QuantScheme(), *,
                  calibrator: Optional[str] = None,
                  precision: Optional[PrecisionPlan] = None,
                  hist_sites: tuple[str, ...] = HIST_SITES,
                  clusters: Optional[Sequence] = None, mesh=None,
                  **calib_kw) -> dict[str, dict[str, float]]:
    """Run calibration batches (dicts of model inputs: (B, S) token /
    segment arrays, audio ``frames``, vision ``prefix_embeds``)
    through the float model with observers on and reduce per-(layer, site)
    statistics to amax values: ``{"layer{i}": {site: amax}}``.

    Calibrator selection: ``calibrator=`` for every site; else
    ``precision=``'s per-block choices via :data:`SITE_BLOCK`; else min-max.
    Histogram calibrators consume raw values on ``hist_sites``.

    ``clusters=`` (one (B,) int vector of cluster ids per batch) captures
    per cluster: each batch's rows are split into cluster-pure sub-batches
    and the stats come back as ``{cluster: {"layer{i}": {site: amax}}}``.
    Every observation is a max, so the split is exact: a cluster's amax is
    the amax over its own rows. A :class:`PlanSet` ``precision`` gives each
    cluster its member's calibrator choices.

    ``mesh=`` (a serving mesh; ``params`` the whole float tree, which every
    rank holds before PTQ) runs the calibration data-parallel over every
    rank of the mesh: batch i on rank i mod world. Each rank's observations
    (the per-site amaxes, and the raw values the histogram calibrators
    take) are all-gathered, and every rank reduces all of them in batch
    order: the scalar and vector sites by a max over the ranks, the
    histograms batch by batch. Each batch runs at the shape it runs
    unsharded, so the stats equal the unsharded stats exactly."""
    if clusters is not None:
        return _capture_stats_clustered(
            params, batches, cfg, plan, scheme, clusters,
            calibrator=calibrator, precision=precision,
            hist_sites=hist_sites, mesh=mesh, **calib_kw)
    device = params["final_norm"]["scale"].device

    def site_calibrator(layer_idx: int, site: str) -> str:
        if calibrator is not None:
            return calibrator
        if precision is not None:
            block = SITE_BLOCK.get(site)
            if block is not None and layer_idx < precision.num_layers:
                spec = precision.layers[layer_idx].spec(block)
                if spec.quantized:
                    return spec.calibrator
        return "minmax"

    if calibrator is not None:
        use_hist = calibrator != "minmax"
    else:
        use_hist = precision is not None and any(
            s is not None and s.quantized and s.calibrator != "minmax"
            for lp in precision.layers for s in
            (lp.qkv, lp.attn_out, lp.ffn_in, lp.ffn_out,
             lp.experts, lp.shared_ffn))

    def calibrator_kw(name: str) -> dict:
        accepted = inspect.signature(CALIBRATORS[name].__init__).parameters
        return {k: v for k, v in calib_kw.items() if k in accepted}

    def hist_name(key: str):
        """The histogram calibrator of a raw capture, None where the
        scalar running max covers it."""
        layer, site = key.split("/", 1)
        if site not in hist_sites:
            return None
        name = site_calibrator(int(layer[len("layer"):]), site)
        return None if name == "minmax" else name

    def observe(batch):
        obs: dict = {"__values__": True} if use_hist else {}
        tensors = {k: torch.as_tensor(np.asarray(v), device=device)
                   for k, v in batch.items()}
        T.forward(params, tensors, cfg, plan, scheme, obs=obs)
        raw = obs.pop("__raw__", {}) if use_hist else {}
        obs.pop("__values__", None)
        # per-head (H,) and per-expert (E,) sites as numpy, scalars as float
        amax = {k: (v.cpu().numpy() if v.ndim else float(v))
                for k, v in obs.items() if k.startswith("layer")}
        return amax, {k: v for k, v in raw.items() if hist_name(k)}

    cals: dict[str, Calibrator] = {}
    scalar_amax: dict = {}          # float per scalar site, (H,) / (E,)

    def reduce(amax: dict, raw: dict) -> None:
        for key, v in amax.items():
            if isinstance(v, np.ndarray):
                prev = scalar_amax.get(key)
                scalar_amax[key] = v if prev is None else np.maximum(prev, v)
            else:
                scalar_amax[key] = max(scalar_amax.get(key, 0.0), v)
        for key, v in raw.items():
            name = hist_name(key)
            cals.setdefault(key, make_calibrator(
                name, **calibrator_kw(name))).observe(v)

    with torch.inference_mode():
        if mesh is None:
            for batch in batches:
                reduce(*observe(batch))
        else:
            import torch.distributed as dist
            world, rank = dist.get_world_size(), dist.get_rank()
            mine = []
            for i in range(rank, len(batches), world):
                amax, raw = observe(batches[i])
                mine.append((i, amax, {k: v.cpu().numpy()
                                       for k, v in raw.items()}))
            every = [None] * world
            dist.all_gather_object(every, mine)
            for _, amax, raw in sorted((e for part in every for e in part),
                                       key=lambda e: e[0]):
                reduce(amax, raw)

    out: dict[str, dict[str, float]] = {}
    for key, amax in scalar_amax.items():
        layer, site = key.split("/", 1)
        # vector stats as plain lists, as the JAX package emits them
        out.setdefault(layer, {})[site] = (
            [float(x) for x in amax] if isinstance(amax, np.ndarray)
            else amax)
    for key, cal in cals.items():
        layer, site = key.split("/", 1)
        out.setdefault(layer, {})[site] = float(cal.compute_amax())
    return out


def _capture_stats_clustered(params, batches, cfg, plan, scheme, clusters,
                             *, precision=None, **kw):
    """Partition calibration rows by cluster id and capture per-cluster
    stats (see :func:`capture_stats`)."""
    ids = [np.asarray(c).reshape(-1).astype(np.int64) for c in clusters]
    if len(ids) != len(batches):
        raise ValueError(f"clusters has {len(ids)} entries for "
                         f"{len(batches)} batches")
    groups: dict[int, list] = {}
    for batch, cid in zip(batches, ids):
        sizes = {np.asarray(v).shape[0] for v in batch.values()}
        if sizes != {len(cid)}:
            raise ValueError(f"cluster-id vector of length {len(cid)} does "
                             f"not match batch row counts {sorted(sizes)}")
        for c in sorted({int(x) for x in cid}):
            rows = np.nonzero(cid == c)[0]
            groups.setdefault(c, []).append(
                {k: np.asarray(v)[rows] for k, v in batch.items()})
    out = {}
    for c, bs in sorted(groups.items()):
        member = (precision.plan_for(c)
                  if isinstance(precision, PlanSet) else precision)
        out[c] = capture_stats(params, bs, cfg, plan, scheme,
                               precision=member, **kw)
    return out


def apply_plan(params: dict, cfg: ArchConfig, precision: PrecisionPlan,
               stats: dict[str, dict[str, float]], *,
               scheme: T.QuantScheme = T.QuantScheme(), float_plan=None):
    """float params (packed under ``float_plan``) + calibration stats ->
    (quantized params, the plan's execution plan)."""
    if not isinstance(precision, PrecisionPlan):
        raise TypeError(f"expected a PrecisionPlan, got "
                        f"{type(precision).__name__}")
    if precision.num_layers != cfg.num_layers:
        raise ValueError(f"plan has {precision.num_layers} layers, arch "
                         f"{cfg.num_layers}")
    float_plan = float_plan or T.build_plan(
        cfg, PrecisionPlan.full_float(cfg.num_layers, precision.float_dtype))
    new_plan = T.build_plan(cfg, precision)
    kinds = cfg.layer_kinds()

    def transform(i: int, lp: dict) -> dict:
        return quantize_layer(lp, cfg, kinds[i], precision.layers[i],
                              stats.get(f"layer{i}", {}), scheme)

    return T.repack(params, float_plan, new_plan, transform), new_plan
