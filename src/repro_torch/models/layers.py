"""Quantization-aware building blocks (port of ``repro.models.layers``):
BERT encoders, the rope / GQA / GLU decoders (qwen2, gemma2, granite,
deepseek-coder, paligemma's backbone) with their dense and paged decode
caches, the top-k MoE FFN (mixtral, deepseek-v2) with its sort-based
capacity dispatch, deepseek-v2's multi-head latent attention (MLA) with its
absorbed decode, the audio and vision front-end projections, and the
causal temporal conv and recurrent-state gate of the recurrent blocks
(:mod:`repro_torch.models.rglru`, :mod:`repro_torch.models.xlstm`).

Every GEMM goes through :func:`dense` (projections) or :func:`quant_bmm`
(the attention score/value batched matmuls), so the precision plan applies
uniformly: a layer's parameters hold float weights (tensors) or
:class:`~repro_torch.core.quantize.QuantizedTensor` weights plus static
activation scales, and dispatch is structural (leaf type), not flag-driven.

Conventions
-----------
* params are plain nested dicts of tensors; a "linear" is
  ``{"w": Tensor|QuantizedTensor, ["b": Tensor], ["xs": 0-d Tensor]}``,
  ``xs`` the calibrated per-tensor activation scale (absent => float GEMM,
  or dynamic per-token quantization when ``w`` is quantized);
* activations are float32 throughout (the JAX encoder's compute dtype);
* observer capture: functions record per-site ``amax`` tensors into an
  ``obs`` dict when one is passed (calibration); ``obs=None`` is the
  serving path and adds no ops;
* decode caches are dicts of tensors that the cache writes update in place
  (the JAX package returns rebuilt arrays); the returned dict is a new dict
  over the same tensors, with new ``pos`` bookkeeping;
* tensor parallelism (``mesh=`` a :class:`~repro_torch.launch.mesh.
  ProcessMesh` whose ``model`` axis is over 1): every rank holds its block
  of the params (:func:`repro_torch.distributed.sharding.shard_params`) and
  runs the same code SPMD. Column-parallel GEMMs (q/k/v, the FFN's input
  GEMMs) compute the rank's heads or hidden units from the replicated
  input; attention runs on the rank's heads where the KV heads split
  evenly, else on all heads after an all-gather; a row-parallel GEMM (the
  attention output, the FFN output) sums the ranks' partial products
  before its bias, activation and requantization (:func:`row_dense`: an
  int8 block sums its int32 accumulators, exact, so it equals the
  unsharded block bit for bit; a float block sums float partials). An
  untied table embeds on the rank's d_model columns and all-gathers them;
  a tied one is vocab-parallel (masked local rows, summed: exact) and
  unembeds to vocab-parallel logits, all-gathered. An MoE layer routes the
  JAX package's token groups, one a data shard, its experts split over
  ``data`` (exchanged by all-to-all) and each expert's hidden units over
  ``model`` (:func:`moe_block`); MLA, the recurrent bodies and the
  front-end projections split their heads or channels over ``model``,
  all-gathering a projection whose split falls off head boundaries. These
  collectives sit where the JAX package's ``constrain`` tags are. Each
  goes through :mod:`repro_torch.distributed.autograd`, so the same
  forward trains on a mesh: a replicated activation enters a column-parallel
  GEMM (:func:`tp_dense`) or a narrow to the rank's block (:func:`tp_cols`)
  through ``copy_to``, whose backward sums the ranks' partial gradients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.quantize import (UINT8_MAX, QuantizedTensor,
                                       compute_scale_symmetric, dequantize_acc,
                                       divide, int8_matmul, int_matmul,
                                       quantize, quantize_per_token,
                                       quantize_unsigned)
from repro_torch.distributed import autograd as dist_ag
from repro_torch.kernels.addnorm_quant import row_sum
from repro_torch.kernels.backend import ACTIVATIONS as _ACT
from repro_torch.kernels.backend import QuantActivation, get_backend
from repro_torch.kernels.expert_gemm import quant_expert_gemm_epilogue
from repro_torch.kernels.flash_attention import NEG_INF, softmax_sum
from repro_torch.kernels.quant_linear import quant_linear_epilogue

# ---------------------------------------------------------------------------
# observer plumbing
# ---------------------------------------------------------------------------


def observe(obs: Optional[dict], site: str, x) -> None:
    """Record max|x| for a quantization site (calibration mode only)."""
    if obs is not None and not isinstance(x, QuantActivation):
        obs[site] = x.abs().max().to(torch.float32)


def observe_values(obs: Optional[dict], site: str, x) -> None:
    """Record raw values for histogram calibrators (small models only)."""
    if obs is not None and obs.get("__values__", False) \
            and not isinstance(x, QuantActivation):
        obs.setdefault("__raw__", {})[site] = x


def observe_per_head(obs: Optional[dict], site: str, x) -> None:
    """Record per-head max|x| over (B, S, H, d): the KV-cache calibration
    sites (``k_cache``/``v_cache``), whose static scales are per head."""
    if obs is not None and not isinstance(x, QuantActivation):
        obs[site] = torch.amax(x.abs(), dim=(0, 1, 3)).to(torch.float32)


def observe_per_expert(obs: Optional[dict], site: str, x) -> None:
    """Record per-expert max|x| over a routed (..., E, C, D) capacity buffer:
    the ``expert_in``/``expert_hidden`` sites of the schema-v4 ``experts``
    family, whose static scales are per expert (E,). Dropped tokens scatter
    as zeros, so each expert's amax covers exactly the tokens it kept."""
    if obs is not None and not isinstance(x, QuantActivation):
        e_axis = x.ndim - 3
        axes = tuple(i for i in range(x.ndim) if i != e_axis)
        obs[site] = torch.amax(x.abs(), dim=axes).to(torch.float32)


# ---------------------------------------------------------------------------
# quant-aware GEMMs
# ---------------------------------------------------------------------------


def _act_quantize(x: torch.Tensor,
                  xs: Optional[torch.Tensor]) -> QuantizedTensor:
    """Static per-tensor scale when calibrated, per-token dynamic otherwise."""
    if xs is not None:
        return QuantizedTensor(quantize(x, xs), xs, None)
    return quantize_per_token(x)


def dense(x, p: dict, obs: Optional[dict] = None, site: str = "x",
          backend=None, act: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ w (+ b)); float GEMM for a tensor ``w``, W8A8 with int32
    accumulation for a QuantizedTensor ``w``. ``backend`` may claim the op
    (the fused backend routes int8 blocks through ``quant_linear``) or
    decline. ``x`` may arrive pre-quantized (a QuantActivation from a fused
    kernel); the reference path dequantizes it."""
    observe(obs, site, x)
    observe_values(obs, site, x)
    if backend is not None:
        y = backend.linear(x, p, act=act)
        if y is not None:
            return y
    if isinstance(x, QuantActivation):
        x = x.dequantize()
    w = p["w"]
    if isinstance(w, QuantizedTensor):
        y = int8_matmul(_act_quantize(x, p.get("xs")), w, out_dtype=x.dtype)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    return _finish(y, p.get("b"), act, p.get("out_xs"))


def _finish(y: torch.Tensor, bias, act: Optional[str], out_xs):
    """The reference GEMM's tail: + bias, the activation, and under a
    norm='int8' span the QDQ at the next consumer's scale."""
    if bias is not None:
        y = y + bias.to(y.dtype)
    y = _ACT[act](y) if act is not None else y
    if out_xs is not None:
        # norm='int8' span: the fused kernel requantizes this GEMM's output
        # in its epilogue; the reference path mirrors that as a QDQ at the
        # same calibrated scale, so the backend never changes the numerics
        y = QuantizedTensor(quantize(y, out_xs), out_xs,
                            None).dequantize(y.dtype)
    return y


def _tp(mesh):
    """``mesh`` when its model axis is over 1 (tensor parallelism), else
    None."""
    return (mesh if mesh is not None and mesh.shape.get("model", 1) > 1
            else None)


def tp_whole(t: torch.Tensor, full: int, mesh) -> torch.Tensor:
    """``t`` (..., n) at its whole width ``full``: a column-parallel
    output the model axis split (n < full) is all-gathered."""
    if t.shape[-1] == full:
        return t
    return dist_ag.gather(t, _tp(mesh), "model", -1)


def tp_cols(t: torch.Tensor, n: int, mesh, dim: int = -1) -> torch.Tensor:
    """This rank's block of ``n`` entries along ``dim`` of a whole ``t``
    (the input of a row-parallel GEMM, a whole parameter a rank uses a
    block of); ``t`` itself where it is n wide. Under autograd the narrow
    follows a ``copy_to``, so the ranks' gradients of ``t`` are summed."""
    if t.shape[dim] == n:
        return t
    tp = _tp(mesh)
    return dist_ag.copy_to(t, tp, "model").narrow(dim, tp.coords["model"] * n,
                                                  n)


def tp_in(x, mesh):
    """The replicated ``x`` as column-parallel GEMMs take it: through
    ``copy_to`` on a tensor-parallel mesh. GEMMs that share one input
    share one, so its backward sums their partials in one collective."""
    return dist_ag.copy_to(x, mesh, "model") if _tp(mesh) is not None else x


def tp_dense(x, p: dict, full: int, mesh, x_tp=None, **kw):
    """:func:`dense` of a column-parallel GEMM whose whole output is
    ``full`` wide: where the rules split the weight's columns (the rank's
    are fewer), the replicated ``x`` enters through ``copy_to`` (``x_tp``,
    :func:`tp_in` of ``x``, where it is made already)."""
    w = p["w"]
    if _tp(mesh) is not None and w.shape[-1] != full:
        x = tp_in(x, mesh) if x_tp is None else x_tp
    return dense(x, p, **kw)


def tp_block(H: int, mesh) -> int:
    """The heads (or channels) a tensor-parallel rank computes: its block
    of ``H`` where the model axis divides them, else all of them (a
    projection split off head boundaries is all-gathered, never padded)."""
    tp = _tp(mesh)
    if tp is None or H % tp.size("model"):
        return H
    return H // tp.size("model")


def row_dense(x, p: dict, k_full: int, mesh=None, backend=None,
              act: Optional[str] = None):
    """A row-parallel block GEMM (the attention output, the FFN output):
    ``x`` (..., K/tp) is this rank's columns, ``p["w"]`` its K/tp rows of
    the (``k_full``, N) weight, and the ranks' partial products are summed
    over the mesh's model axis before the bias (gathered: the rules shard
    every bias by its last axis), the activation and the requant. An int8
    block codes ``x`` at its static scale or at the whole row's per-token
    scale (a max over the ranks), and sums the int32 accumulators: the
    fused backend's ``quant_linear`` in its accumulator mode with the
    kernel's epilogue after the sum, or the reference ``int8_matmul``'s
    dequantization, each equal to its unsharded path bit for bit. A float
    block sums float partials. Without a tensor-parallel mesh, or for a
    weight the rules left whole, it is :func:`dense`."""
    w = p["w"]
    N = w.shape[1]
    tp = _tp(mesh)
    if tp is None or w.shape[0] == k_full:
        return dense(x, p, backend=backend, act=act)
    bias = p.get("b")
    if bias is not None and bias.shape[-1] != N:
        bias = dist_ag.gather(bias, tp, "model", -1)
    out_xs = p.get("out_xs")
    if not isinstance(w, QuantizedTensor):
        if isinstance(x, QuantActivation):
            x = x.dequantize()
        y = dist_ag.reduce_from(torch.matmul(x, w.to(x.dtype)), tp, "model")
        return _finish(y, bias, act, out_xs)

    def row_amax(a):
        return tp.all_reduce(a, "model", "max")

    got = (backend.linear_acc(x, p, row_amax=row_amax)
           if backend is not None else None)
    if got is not None:
        acc, x_scale = got
        lead = (x.q.values if isinstance(x, QuantActivation) else x).shape[:-1]
        w_scale = w.scale.to(torch.float32).reshape(-1)
        if w_scale.shape[0] != N:                  # int8_per_tensor weights
            w_scale = w_scale.expand(N)
        y = quant_linear_epilogue(tp.all_reduce(acc, "model"), w_scale,
                                  x_scale, bias=bias, act=act,
                                  out_scale=out_xs).reshape(*lead, N)
        if out_xs is not None:
            return QuantActivation(QuantizedTensor(y, out_xs, None),
                                   x.dtype)
        return y
    if isinstance(x, QuantActivation):
        x = x.dequantize()
    xs = p.get("xs")
    if xs is None:                   # per token, at the whole row's scale
        xs = compute_scale_symmetric(
            row_amax(torch.amax(x.abs(), dim=-1, keepdim=True)))
    acc = tp.all_reduce(int_matmul(quantize(x, xs), w.values), "model")
    return _finish(dequantize_acc(acc, xs, w, x.dtype), bias, act, out_xs)


def mesh_max(mesh):
    """The max over every axis of ``mesh`` (None unmeshed): a dynamic
    per-tensor scale's amax on a rank covers only its rows and heads, and
    this makes it the whole tensor's, as the unmeshed forward (and the JAX
    package's global reduction) has it."""
    if mesh is None or all(n == 1 for n in mesh.shape.values()):
        return None

    def whole(t: torch.Tensor) -> torch.Tensor:
        for axis in mesh.axis_names:
            t = mesh.all_reduce(t, axis, "max")
        return t
    return whole


def quant_bmm(a: torch.Tensor, b: torch.Tensor,
              a_scale: Optional[torch.Tensor],
              b_scale: Optional[torch.Tensor], *,
              transpose_b: bool = False,
              unsigned_a: bool = False, whole_max=None) -> torch.Tensor:
    """Quantized batched matmul for the MHA score/value paths: both float
    operands are quantized at their static scales (dynamically when None),
    multiplied as int8 with exact int32 accumulation, and dequantized.
    Contracts the last dim of ``a`` with the last (``transpose_b``) or
    second-to-last dim of ``b``; leading dims are batch. ``whole_max``
    (:func:`mesh_max`) takes a dynamic per-tensor amax over the mesh."""
    def amax(t):
        return t if whole_max is None else whole_max(t)
    if unsigned_a:
        aq = quantize_unsigned(a, amax(a.max()) if a_scale is None
                               else a_scale * UINT8_MAX)
    elif a_scale is None:
        aq = quantize_per_token(a)
    else:
        aq = QuantizedTensor(quantize(a, a_scale), a_scale, None)
    if b_scale is None:
        b_scale = compute_scale_symmetric(amax(b.abs().max()))
    bq_vals = quantize(b, b_scale)
    bdim = b.ndim - 1 if transpose_b else b.ndim - 2
    rhs = bq_vals.transpose(-1, -2) if transpose_b else bq_vals
    acc = int_matmul(aq.values, rhs)
    if unsigned_a:
        # zero-point correction: sum over the contracted axis of b
        bsum = bq_vals.to(torch.int32).sum(dim=bdim)
        acc = acc - aq.zero_point * bsum[..., None, :]
    return (acc.to(torch.float32) * (aq.scale * b_scale)).to(a.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = divide(row_sum(torch.square(xf)), xf.shape[-1])
    y = xf * torch.reciprocal(torch.sqrt(var + eps)) \
        * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    """Float32 mean, then the mean of squared deviations, then
    1/sqrt(var + eps) — the JAX package's formulation (eps 1e-6, not
    PyTorch's 1e-5), with the summation order and the IEEE divisions of the
    ``addnorm_quant`` kernel, so the fused and reference paths round
    alike."""
    xf = x.to(torch.float32)
    D = xf.shape[-1]
    mu = divide(row_sum(xf), D)
    var = divide(row_sum(torch.square(xf - mu)), D)
    y = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps))
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def norm(x: torch.Tensor, p: dict, kind: str,
         eps: float = 1e-6) -> torch.Tensor:
    return layer_norm(x, p, eps) if kind == "layernorm" \
        else rms_norm(x, p, eps)


def residual_norm(delta, x: torch.Tensor, p: dict, kind: str, *,
                  next_scale=None, backend=None):
    """The residual boundary: ``(x + delta, norm(x + delta))``. A fused
    backend claims it when ``next_scale`` carries the consuming GEMM's
    static activation scale: ``addnorm_quant`` computes both outputs in one
    pass and returns the norm output pre-quantized (a QuantActivation)."""
    if backend is not None and next_scale is not None:
        fused = backend.addnorm(delta, x, p, kind, next_scale)
        if fused is not None:
            return fused
    if isinstance(delta, QuantActivation):
        delta = delta.dequantize()
    x_new = x + delta
    return x_new, norm(x_new, p, kind)


def init_norm(kind: str, dim: int, *, device=None,
              dtype=torch.float32) -> dict:
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the even half of the head dim (float32)."""
    half = head_dim // 2
    exps = divide(torch.arange(0, half, dtype=torch.float32, device=device),
                  float(half))
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               heads_axis: bool = True) -> torch.Tensor:
    """x: (..., S, H, hd) when ``heads_axis`` else (..., S, hd); positions:
    (S,) (uniform across the batch) or (B, S) (per row, as continuous
    batching decodes). Split-half convention."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)       # (hd/2,)
    ang = positions.to(torch.float32)[..., :, None] * inv      # (..., S, hd/2)
    if heads_axis:
        ang = ang[..., :, None, :]                             # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnQuant:
    """Static quant plan for one attention block's batched matmuls.
    ``softmax_mode``: 'symmetric' (the paper's scheme), 'unsigned', or
    'none' (float softmax output). ``plan_scheme`` is the layer's schema-v3
    softmax scheme ('uint8' or None)."""
    enabled: bool = False
    softmax_mode: str = "symmetric"
    plan_scheme: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Attention-visibility rule."""
    causal: bool = True
    window: Optional[int] = None
    prefix_len: int = 0


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (torch.tanh(divide(x.to(torch.float32), cap)) * cap).to(x.dtype)


def band_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
              spec: MaskSpec) -> torch.Tensor:
    """Boolean (..., Sq, Sk) mask, True = attend. Positions are (Sq,)/(Sk,)
    or (B, Sq)/(B, Sk); key positions of -1 (padding) are masked."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    valid = kp >= 0
    if spec.causal:
        m = kp <= qp
        if spec.prefix_len:
            m = m | (kp < spec.prefix_len)
    else:
        m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                       dtype=torch.bool, device=kp.device)
    if spec.window is not None:
        m = m & (kp > qp - spec.window)
    return m & valid


def _softmax(s: torch.Tensor, ordered: bool = False) -> torch.Tensor:
    # jax.nn.softmax's formulation: exp(s - max) / sum. ``ordered`` sums in
    # the quant_flash_attention kernel's order, so that the reference and
    # the fused uint8 path round p, and hence its codes at ties, alike
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    return e / (softmax_sum(e) if ordered
                else torch.sum(e, dim=-1, keepdim=True))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor, spec: MaskSpec,
                   *, scale: float, attn_softcap: Optional[float] = None,
                   quant: AttnQuant = AttnQuant(),
                   scales: Optional[dict] = None,
                   obs: Optional[dict] = None,
                   chunk: Optional[int] = None, mesh=None) -> torch.Tensor:
    """softmax(q k^T * scale) v with GQA and optional int8 score/value
    matmuls (the Fully-Quant MHA path). q: (B, Sq, Hq, d); k, v:
    (B, Sk, Hkv, d); positions (Sq,)/(Sk,) or per row (B, Sq)/(B, Sk).
    ``chunk`` processes queries in blocks of that many rows (a Python loop
    standing in for the JAX package's ``lax.scan``). On a ``mesh`` the
    int8 matmuls' dynamic per-tensor scales are the whole tensor's."""
    whole_max = mesh_max(mesh)
    B, Sq, Hq, D = q.shape
    Dv = v.shape[-1]
    Hkv = k.shape[2]
    groups = Hq // Hkv
    qh = q.transpose(1, 2)                          # (B, Hq, Sq, d)
    kh = k.transpose(1, 2)                          # (B, Hkv, Sk, d)
    vh = v.transpose(1, 2)
    if groups > 1 and quant.enabled:
        # the int8 batched matmuls take matching head counts
        kh = kh.repeat_interleave(groups, dim=1)
        vh = vh.repeat_interleave(groups, dim=1)
    # float GQA folds the query-head groups into an extra axis instead
    grouped = groups > 1 and not quant.enabled
    sc = scales or {}
    if q_pos.ndim == 1:
        q_pos = q_pos[None]
    if k_pos.ndim == 1:
        k_pos = k_pos[None]

    def block(qb: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
        mb = band_mask(qp, k_pos, spec)             # (B|1, bq, Sk)
        qs = qb * scale
        observe(obs, "q", qs)
        observe(obs, "k", kh)
        if quant.enabled:
            s = quant_bmm(qs, kh, sc.get("q"), sc.get("k"), transpose_b=True,
                          whole_max=whole_max)
        elif grouped:
            bq = qs.shape[2]
            qg = qs.reshape(B, Hkv, groups, bq, D)
            s = torch.matmul(qg, kh[:, :, None].transpose(-1, -2))
            s = s.reshape(B, Hq, bq, -1)
        else:
            s = torch.matmul(qs, kh.transpose(-1, -2))
        s = softcap(s, attn_softcap)
        # a Python scalar, not a new device tensor: building one from the
        # host would synchronize the stream once per layer
        s = torch.where(mb[:, None], s.to(torch.float32), NEG_INF)
        p = _softmax(s, ordered=quant.enabled
                     and quant.plan_scheme == "uint8").to(qb.dtype)
        observe(obs, "p", p)
        observe_values(obs, "p", p)
        observe(obs, "v", vh)
        if (not quant.enabled and quant.plan_scheme == "uint8"
                and sc.get("p") is not None):
            p = quantize_unsigned(p, sc["p"] * UINT8_MAX).dequantize(p.dtype)
        if quant.enabled and (quant.softmax_mode != "none"
                              or quant.plan_scheme == "uint8"):
            return quant_bmm(p, vh, sc.get("p"), sc.get("v"),
                             unsigned_a=(quant.softmax_mode == "unsigned"
                                         or quant.plan_scheme == "uint8"),
                             whole_max=whole_max)
        if grouped:
            bq = p.shape[2]
            o = torch.matmul(p.reshape(B, Hkv, groups, bq, -1), vh[:, :, None])
            return o.reshape(B, Hq, bq, Dv)
        return torch.matmul(p, vh)

    if chunk is not None and Sq % chunk != 0:
        c = chunk
        while c > 1 and Sq % c:
            c -= 1
        chunk = c if c > 1 else None
    if chunk is None or Sq <= chunk:
        out = block(qh, q_pos)
    else:
        out = torch.cat([block(qh[:, :, i:i + chunk], q_pos[:, i:i + chunk])
                         for i in range(0, Sq, chunk)], dim=2)
    return out.transpose(1, 2)                      # (B, Sq, Hq, d)


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = False, *, device=None, dtype=torch.float32,
                init_scale: float = 1.0) -> dict:
    std = init_scale / math.sqrt(d_in)
    p = {"w": torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                          device=device) * std}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def init_attention(gen: torch.Generator, cfg, *, device=None,
                   dtype=torch.float32) -> dict:
    kw = dict(device=device, dtype=dtype)
    return {
        "wq": init_linear(gen, cfg.d_model, cfg.q_dim, cfg.qkv_bias, **kw),
        "wk": init_linear(gen, cfg.d_model, cfg.kv_dim, cfg.qkv_bias, **kw),
        "wv": init_linear(gen, cfg.d_model, cfg.kv_dim, cfg.qkv_bias, **kw),
        "wo": init_linear(gen, cfg.q_dim, cfg.d_model, False, **kw),
    }


# ---------------------------------------------------------------------------
# decode caches: the dense ring and the paged pool
# ---------------------------------------------------------------------------


def _cache_write(kv_cache: dict, new: dict, positions: torch.Tensor,
                 active: Optional[torch.Tensor]) -> dict:
    """Write new K/V into a ring-buffer cache ``{"k", "v": (B, W, Hkv, d),
    "k_pos": (B, W), "pos": (B,)}``, in place.

    * uniform positions (``positions`` (S,), prefill or a synchronized
      batch): a contiguous write at slot ``pos[0] % W`` for every row (the
      tail of S when the ring is narrower);
    * per-row positions (``positions`` (B, 1), continuous batching): one
      token per row at that row's own slot; rows with ``active`` False keep
      their old value, so idle slots are never corrupted.

    ``new`` maps cache key -> (B, S, ...). Returns the cache dict with the
    new ``pos``."""
    W = kv_cache["k_pos"].shape[-1]
    B = kv_cache["k_pos"].shape[0]
    out = dict(kv_cache)
    if positions.ndim == 1:                          # uniform path
        S = positions.shape[0]
        write_S = min(S, W)      # ring smaller than prefill: keep the tail
        slot = 0 if write_S < S else int(kv_cache["pos"][0]) % W
        start = min(slot, W - write_S)   # dynamic_update_slice's clamp
        for key, val in new.items():
            kv_cache[key][:, start:start + write_S] = \
                val[:, S - write_S:].to(kv_cache[key].dtype)
        kv_cache["k_pos"][:, start:start + write_S] = \
            positions[S - write_S:].to(torch.int32)
        out["pos"] = kv_cache["pos"] + S
    else:                                            # per-row path (S == 1)
        rows = torch.arange(B, device=positions.device)
        pos_vec = positions[:, 0].to(torch.int64)
        slot = pos_vec % W
        act = (active if active is not None
               else torch.ones((B,), dtype=torch.bool,
                               device=positions.device))
        for key, val in new.items():
            leaf = kv_cache[key]
            val_row = val[:, 0].to(leaf.dtype)
            gate = act.reshape((B,) + (1,) * (val_row.ndim - 1))
            leaf[rows, slot] = torch.where(gate, val_row, leaf[rows, slot])
        kp = kv_cache["k_pos"]
        kp[rows, slot] = torch.where(act, pos_vec.to(torch.int32),
                                     kp[rows, slot])
        out["pos"] = kv_cache["pos"] + act.to(kv_cache["pos"].dtype)
    return out


# The paged layout: the per-slot (B, W, ...) ring becomes a pool of
# fixed-size token pages shared by every slot:
#
#   pages_k / pages_v : (NP, ps, Hkv, hd)   int8 or the cache dtype
#   pages_ks/pages_vs : (NP, ps, Hkv) f32   per-token scales (dynamic only)
#   pages_pos         : (NP, ps) int32      absolute position, -1 = invalid
#   pos               : (B,) int32          per-slot next position
#
# plus the page-table operand (B, pages_per_slot) int32 that the serving
# scheduler's PagePool owns (-1 = unallocated). Token t of slot b lives at
# flat index pages[b, t // ps] * ps + t % ps.


def _page_flat_index(pages: torch.Tensor, positions: torch.Tensor,
                     active: Optional[torch.Tensor],
                     page_size: int) -> torch.Tensor:
    """(B, S) flat token indices into a (NP * ps, ...) page pool; -1 where
    the write must be dropped (inactive row, unallocated page, out of
    range)."""
    pidx = torch.div(positions, page_size, rounding_mode="floor")
    within = positions - pidx * page_size
    pps = pages.shape[1]
    safe = torch.clamp(pidx, 0, pps - 1).to(torch.int64)
    pt = torch.gather(pages.to(torch.int64), 1, safe)
    ok = (pt >= 0) & (pidx >= 0) & (pidx < pps)
    if active is not None:
        ok = ok & active[:, None]
    return torch.where(ok, pt * page_size + within, -1)


def _paged_cache_write(kv_cache: dict, new: dict, positions: torch.Tensor,
                       active: Optional[torch.Tensor], pages: torch.Tensor,
                       static_scales: Optional[dict] = None) -> dict:
    """Scatter new K/V tokens into their slots' pages, in place.

    ``new`` maps short key ("k"/"v") -> (B, S, ...); the cache holds it
    under ``pages_<key>``. Quantization is structural: int8 pages with a
    ``pages_<key>s`` sibling get per-token scales computed here, int8 pages
    without one use the calibrated per-head scale from ``static_scales``,
    float pages store the value. Writes of inactive rows, to unallocated
    pages or out of range are dropped: only the valid indices are written,
    so a -1 never wraps around to the pool's last row."""
    ps = kv_cache["pages_pos"].shape[1]
    npages = kv_cache["pages_pos"].shape[0]
    B = kv_cache["pos"].shape[0]
    pos2 = positions.to(torch.int64)
    if positions.ndim == 1:                              # uniform prefill
        pos2 = torch.broadcast_to(pos2[None, :], (B, positions.shape[0]))
    S = pos2.shape[1]
    flat = _page_flat_index(pages, pos2, active, ps).reshape(-1)  # (B*S,)
    keep = torch.nonzero(flat >= 0)[:, 0]
    idx = flat[keep]
    out = dict(kv_cache)
    for key, val in new.items():
        leaf = kv_cache["pages_" + key]
        skey = "pages_" + key + "s"
        if leaf.dtype == torch.int8:
            if skey in kv_cache:                         # per-token dynamic
                amax = torch.amax(val.to(torch.float32).abs(), dim=-1)
                scl = compute_scale_symmetric(amax)      # (B, S, H)
                rows = quantize(val, scl[..., None])
                spages = kv_cache[skey]
                spages.view((npages * ps,) + spages.shape[2:])[idx] = \
                    scl.reshape((-1,) + spages.shape[2:])[keep]
            else:                                        # per-head static
                s = (static_scales or {}).get(key)
                if s is None:
                    raise ValueError(
                        f"int8_per_head KV cache for {key!r} needs a "
                        f"calibrated static scale ({key}c_scale); "
                        f"re-calibrate with kv_cache='int8_per_head' or "
                        f"serve with kv_cache='int8_per_token'")
                rows = quantize(val, s.reshape((1, 1, -1, 1)))
        else:
            rows = val.to(leaf.dtype)
        leaf.view((npages * ps,) + leaf.shape[2:])[idx] = \
            rows.reshape((-1,) + leaf.shape[2:])[keep]
    kv_cache["pages_pos"].view(-1)[idx] = pos2.reshape(-1)[keep].to(
        torch.int32)
    if positions.ndim == 1:
        out["pos"] = kv_cache["pos"] + S
    else:
        act = (active if active is not None
               else torch.ones((B,), dtype=torch.bool,
                               device=positions.device))
        out["pos"] = kv_cache["pos"] + act.to(kv_cache["pos"].dtype)
    return out


def _paged_cache_read(kv_cache: dict, pages: torch.Tensor, keys, dtype,
                      static_scales: Optional[dict] = None):
    """Gather and dequantize a slot-major view of the paged cache: each key
    comes back (B, pages_per_slot * ps, ...), with k_pos
    (B, pages_per_slot * ps) carrying -1 for unallocated pages and unwritten
    entries."""
    pt = pages.to(torch.int64)
    safe = torch.clamp(pt, min=0)                        # gatherable
    B, pps = pt.shape
    ps = kv_cache["pages_pos"].shape[1]
    kpos = kv_cache["pages_pos"][safe]                   # (B, pps, ps)
    kpos = torch.where(pt[:, :, None] >= 0, kpos, -1)
    outs = []
    for key in keys:
        leaf = kv_cache["pages_" + key]
        g = leaf[safe]                                   # (B, pps, ps, ...)
        if leaf.dtype == torch.int8:
            skey = "pages_" + key + "s"
            if skey in kv_cache:
                g = g.to(torch.float32) * kv_cache[skey][safe][..., None]
            else:
                s = (static_scales or {})[key]
                g = g.to(torch.float32) * s.reshape((1, 1, 1, -1, 1))
        outs.append(g.to(dtype).reshape((B, pps * ps) + leaf.shape[2:]))
    return outs, kpos.reshape(B, pps * ps)


def is_paged(kv_cache: Optional[dict]) -> bool:
    return kv_cache is not None and "pages_pos" in kv_cache


def select_state(new: dict, old: dict, active: Optional[torch.Tensor]
                 ) -> dict:
    """The recurrent-state gate: rows with ``active`` False keep their old
    state (continuous batching over the recurrent archs). Returns a new
    dict of new tensors."""
    if active is None:
        return new

    def sel(n: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        a = active.reshape((active.shape[0],) + (1,) * (n.ndim - 1))
        return torch.where(a, n, o.to(n.dtype))
    return {k: sel(n, old[k]) for k, n in new.items()}


def local_kv_heads(cfg, mesh) -> int:
    """The KV heads a rank holds (its projections, its cache): the model
    axis splits them when it divides them, else every rank holds all of
    them and attention runs on all heads after an all-gather."""
    tp = _tp(mesh)
    H = cfg.num_kv_heads
    if tp is None or H % tp.size("model"):
        return H
    return H // tp.size("model")


def _tp_heads(q, k, v, cfg, mesh):
    """The heads a tensor-parallel rank attends over: its own (q, k, v
    already column-sharded on whole heads, KV heads split evenly), or all
    of them, the sharded projections all-gathered. Returns q, k, v as
    (B, S, heads, d)."""
    B, S = q.shape[:2]
    hd = cfg.head_dim
    if local_kv_heads(cfg, mesh) == cfg.num_kv_heads:
        q, k, v = (tp_whole(t, full, mesh)
                   for t, full in ((q, cfg.q_dim), (k, cfg.kv_dim),
                                   (v, cfg.kv_dim)))
    return tuple(t.reshape(B, S, t.shape[-1] // hd, hd) for t in (q, k, v))


def attention_block(x: torch.Tensor, p: dict, cfg, *, positions: torch.Tensor,
                    spec: MaskSpec, quant: AttnQuant = AttnQuant(),
                    obs: Optional[dict] = None,
                    kv_cache: Optional[dict] = None,
                    active: Optional[torch.Tensor] = None,
                    chunk: Optional[int] = None,
                    pages: Optional[torch.Tensor] = None, backend=None,
                    mesh=None):
    """The GQA attention block: QKV projections (with bias where the config
    has it), rope, the core and the output projection. Returns the output,
    or ``(output, new_cache)`` when a ``kv_cache`` is given.

    ``kv_cache`` (decode) is a dense ring (:func:`_cache_write`) or a paged
    pool (``pages_*`` keys) that takes ``pages``, the scheduler's
    (B, pages_per_slot) page table; ``positions`` may be per row (B, 1).
    A one-token step over a paged cache with float batched matmuls is
    offered to ``backend.decode_attention``, which runs the
    ``decode_attention`` kernel (fused) or its plain version (reference)
    over int8 pages. A step it declines (float pages), and layers whose
    batched matmuls are int8, gather and dequantize the pages and run
    :func:`attention_core`.

    On a tensor-parallel ``mesh`` the q/k/v projections are
    column-parallel, attention runs on the rank's heads (or on all heads,
    :func:`_tp_heads`), the cache holds :func:`local_kv_heads`, and the
    output projection is row-parallel (:func:`row_dense`)."""
    B, S, _ = x.shape
    observe(obs, "attn_in", x)
    observe_values(obs, "attn_in", x)
    xt = tp_in(x, mesh)
    q = tp_dense(x, p["wq"], cfg.q_dim, mesh, xt, backend=backend)
    k = tp_dense(x, p["wk"], cfg.kv_dim, mesh, xt, backend=backend)
    v = tp_dense(x, p["wv"], cfg.kv_dim, mesh, xt, backend=backend)
    if _tp(mesh) is not None:
        q, k, v = _tp_heads(q, k, v, cfg, mesh)
    else:
        q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
        k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.position == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    observe_per_head(obs, "k_cache", k)
    observe_per_head(obs, "v_cache", v)
    new_cache = None
    k_pos = positions
    o = None
    scale = 1.0 / math.sqrt(cfg.head_dim)
    static_sc = {key: p[f"{key}c_scale"] for key in ("k", "v")
                 if f"{key}c_scale" in p}
    if is_paged(kv_cache):
        if pages is None:
            raise ValueError("paged kv_cache requires the page-table "
                             "operand (pages=)")
        new_cache = _paged_cache_write(kv_cache, {"k": k, "v": v},
                                       positions, active, pages, static_sc)
        if S == 1:
            if not quant.enabled:
                p_scale = (p.get("p_scale") if quant.plan_scheme == "uint8"
                           else None)
                o = get_backend(backend).decode_attention(
                    q, new_cache, pages, positions=positions, active=active,
                    scale=scale, softcap=cfg.attn_softcap,
                    static_scales=static_sc, p_scale=p_scale)
            if o is None:
                (k, v), k_pos = _paged_cache_read(
                    new_cache, pages, ("k", "v"), x.dtype, static_sc)
        # prefill (S > 1): attend over in-sequence K/V
    elif kv_cache is not None:
        new_cache = _cache_write(kv_cache, {"k": k, "v": v}, positions,
                                 active)
        if S == 1:
            # decode: attend over the ring
            k = new_cache["k"].to(x.dtype)
            v = new_cache["v"].to(x.dtype)
            k_pos = new_cache["k_pos"]
    if (o is None and kv_cache is None and backend is not None
            and quant.enabled and quant.plan_scheme == "uint8"):
        # the fully-quantized core: int8 QK^T, the uint8 softmax and int8
        # P.V in one kernel, which under a norm='int8' span returns its
        # output requantized at attn_out's scale (a QuantActivation)
        o = backend.attention(q, k, v, p, k_pos=k_pos, spec=spec,
                              scale=scale, softcap=cfg.attn_softcap)
    if o is None:
        sc = {s: p[f"{s}_scale"] for s in ("q", "k", "p", "v")
              if f"{s}_scale" in p} or None
        o = attention_core(q, k, v, positions, k_pos, spec, scale=scale,
                           attn_softcap=cfg.attn_softcap, quant=quant,
                           scales=sc, obs=obs, chunk=chunk, mesh=mesh)
    o = o.reshape(B, S, -1)
    # attention ran on all heads: this rank's columns of wo's input
    o = tp_cols(o, p["wo"]["w"].shape[0], mesh)
    observe(obs, "attn_out", o)
    observe_values(obs, "attn_out", o)
    out = row_dense(o, p["wo"], cfg.q_dim, mesh, backend)
    observe(obs, "attn_delta", out)
    observe_values(obs, "attn_delta", out)
    return out if kv_cache is None else (out, new_cache)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (deepseek-v2), with absorbed decode
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg, *, device=None,
             dtype=torch.float32) -> dict:
    m = cfg.mla
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    kw = dict(device=device, dtype=dtype)
    p = {"wkv_a": init_linear(gen, cfg.d_model,
                              m.kv_lora_rank + m.qk_rope_dim, False, **kw),
         "kv_norm": init_norm("rmsnorm", m.kv_lora_rank, **kw),
         "wkv_b": init_linear(gen, m.kv_lora_rank,
                              cfg.num_heads * (m.qk_nope_dim + m.v_head_dim),
                              False, **kw),
         "wo": init_linear(gen, cfg.num_heads * m.v_head_dim, cfg.d_model,
                           False, **kw)}
    if m.q_lora_rank:
        p["wq_a"] = init_linear(gen, cfg.d_model, m.q_lora_rank, False, **kw)
        p["q_norm"] = init_norm("rmsnorm", m.q_lora_rank, **kw)
        p["wq_b"] = init_linear(gen, m.q_lora_rank, cfg.num_heads * qk_dim,
                                False, **kw)
    else:
        p["wq"] = init_linear(gen, cfg.d_model, cfg.num_heads * qk_dim,
                              False, **kw)
    return p


def mla_block(x: torch.Tensor, p: dict, cfg, *, positions: torch.Tensor,
              spec: MaskSpec, quant: AttnQuant = AttnQuant(),
              obs: Optional[dict] = None, kv_cache: Optional[dict] = None,
              active: Optional[torch.Tensor] = None,
              chunk: Optional[int] = None,
              pages: Optional[torch.Tensor] = None, mesh=None):
    """deepseek-v2's MLA. Prefill expands per-head K and V from the latent
    and runs :func:`attention_core`; a one-token step over a cache runs the
    absorbed form: ``wkv_b`` folds into the query and output sides, and
    attention runs in the latent space against a cache of
    ``kv_lora_rank + qk_rope_dim`` floats a token (``ckv``, ``krope``; the
    paged pool holds them as ``pages_ckv``/``pages_krope``, float, under the
    standard layers' page table). Every GEMM takes the reference path, as
    in the JAX package, whose fused backend leaves the MLA body to it.
    Returns the output, or ``(output, new_cache)`` with a ``kv_cache``.

    On a tensor-parallel ``mesh`` the heads split over ``model``: ``wq_b``
    (or ``wq``) and ``wkv_b`` are column-parallel on their head-major
    outputs, ``wo`` row-parallel (:func:`row_dense`). ``wq_a`` is
    column-parallel, so ``q_lat`` is all-gathered before ``q_norm``, whose
    RMS runs over all ``q_lora_rank`` columns; ``wkv_a`` is whole, so every
    rank computes, and caches, the whole latent. Where the heads do not split
    evenly, the rank all-gathers the query and ``wkv_b`` and attends over
    every head."""
    m = cfg.mla
    B, S, _ = x.shape
    H, nope, rd, vd = cfg.num_heads, m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim
    r = m.kv_lora_rank
    tp = _tp(mesh)
    observe(obs, "attn_in", x)
    if m.q_lora_rank:
        q_lat = tp_whole(tp_dense(x, p["wq_a"], m.q_lora_rank, mesh),
                         m.q_lora_rank, mesh)
        q_lat = rms_norm(q_lat, p["q_norm"])
        observe(obs, "q_lat", q_lat)
        q = tp_dense(q_lat, p["wq_b"], H * (nope + rd), mesh)
    else:
        q = tp_dense(x, p["wq"], H * (nope + rd), mesh)
    wkv_b = p["wkv_b"]["w"]
    wkv_b = (wkv_b.dequantize(x.dtype) if isinstance(wkv_b, QuantizedTensor)
             else wkv_b.to(x.dtype))
    Hl = tp_block(H, mesh)
    q = tp_whole(q, Hl * (nope + rd), mesh)
    wkv_b = tp_whole(wkv_b, Hl * (nope + vd), mesh)
    q = q.reshape(B, S, Hl, nope + rd)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    kv = dense(x, p["wkv_a"])
    ckv = rms_norm(kv[..., :r], p["kv_norm"])
    observe(obs, "c_kv", ckv)
    k_rope = apply_rope(kv[..., r:], positions, cfg.rope_theta,
                        heads_axis=False)                 # (B, S, rd) shared
    scale = 1.0 / math.sqrt(nope + rd)
    wkv_b = wkv_b.reshape(r, Hl, nope + vd)
    wk, wv = wkv_b[..., :nope], wkv_b[..., nope:]       # (r, H, nope|vd)
    new_cache = None
    if is_paged(kv_cache):
        if pages is None:
            raise ValueError("paged kv_cache requires the page-table "
                             "operand (pages=)")
        new_cache = _paged_cache_write(kv_cache, {"ckv": ckv,
                                                  "krope": k_rope},
                                       positions, active, pages)
    elif kv_cache is not None:
        new_cache = _cache_write(kv_cache, {"ckv": ckv, "krope": k_rope},
                                 positions, active)
    if new_cache is not None and S == 1:
        if is_paged(new_cache):
            (ckv_all, krope_all), k_pos = _paged_cache_read(
                new_cache, pages, ("ckv", "krope"), x.dtype)
        else:
            ckv_all = new_cache["ckv"].to(x.dtype)
            krope_all = new_cache["krope"].to(x.dtype)
            k_pos = new_cache["k_pos"]
        q_pos = positions if positions.ndim == 2 else positions[None]
        mask = band_mask(q_pos, k_pos, spec)             # (B|1, S, T)

        def head_product(eq, a, b):
            # each per-head product summed in float64 and rounded once: a
            # batched GEMM's summation order follows the head count (the
            # card rounds 64 heads a rank unlike 128), and this makes the
            # rank's heads equal the unsharded ones bit for bit
            return torch.einsum(eq, a.to(torch.float64),
                                b.to(torch.float64)).to(x.dtype)
        q_abs = head_product("bshn,rhn->bshr", q_nope, wk)
        s = (head_product("bshr,btr->bhst", q_abs, ckv_all)
             + head_product("bshr,btr->bhst", q_rope, krope_all)) * scale
        s = torch.where(mask[:, None], s.to(torch.float32), NEG_INF)
        prob = _softmax(s).to(x.dtype)
        o_lat = head_product("bhst,btr->bshr", prob, ckv_all)
        o = head_product("bshr,rhv->bshv", o_lat, wv)    # (B, S, H, vd)
    else:
        if Hl != H:
            # the latent enters the rank's heads
            ckv = dist_ag.copy_to(ckv, tp, "model")
            k_rope = dist_ag.copy_to(k_rope, tp, "model")
        k_nope = torch.einsum("btr,rhn->bthn", ckv, wk)
        v = torch.einsum("btr,rhv->bthv", ckv, wv)
        k = torch.cat([k_nope, torch.broadcast_to(k_rope[:, :, None, :],
                                                  (B, S, Hl, rd))], dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        sc = {s_: p[f"{s_}_scale"] for s_ in ("q", "k", "p", "v")
              if f"{s_}_scale" in p} or None
        o = attention_core(qf, k, v, positions, positions, spec, scale=scale,
                           quant=quant, scales=sc, obs=obs, chunk=chunk,
                           mesh=mesh)
    o = o.reshape(B, S, Hl * vd)
    # attention ran on every head: this rank's columns of wo's input
    o = tp_cols(o, p["wo"]["w"].shape[0], mesh)
    observe(obs, "attn_out", o)
    observe_values(obs, "attn_out", o)
    out = row_dense(o, p["wo"], H * vd, mesh)
    return out if kv_cache is None else (out, new_cache)


# ---------------------------------------------------------------------------
# FFN: GLU (qwen2 and the llama family), GELU (BERT)
# ---------------------------------------------------------------------------


def init_ffn(gen: torch.Generator, cfg, d_ff: Optional[int] = None, *,
             device=None, dtype=torch.float32) -> dict:
    d_ff = d_ff or cfg.d_ff
    kw = dict(device=device, dtype=dtype)
    if cfg.ffn_kind == "glu":
        return {"wg": init_linear(gen, cfg.d_model, d_ff, False, **kw),
                "wu": init_linear(gen, cfg.d_model, d_ff, False, **kw),
                "wd": init_linear(gen, d_ff, cfg.d_model, False, **kw)}
    return {"wi": init_linear(gen, cfg.d_model, d_ff, True, **kw),
            "wo": init_linear(gen, d_ff, cfg.d_model, True, **kw)}


def ffn_block(x, p: dict, cfg, obs: Optional[dict] = None, prefix: str = "",
              backend=None, mesh=None, d_ff: Optional[int] = None
              ) -> torch.Tensor:
    """The dense FFN of ``d_ff`` hidden units (``cfg.d_ff`` by default);
    on a tensor-parallel ``mesh`` its input GEMMs are column-parallel over
    the hidden units and its output GEMM row-parallel."""
    observe(obs, prefix + "ffn_in", x)
    observe_values(obs, prefix + "ffn_in", x)
    F = d_ff or cfg.d_ff
    if cfg.ffn_kind == "glu":
        xt = tp_in(x, mesh)
        h = (tp_dense(x, p["wg"], F, mesh, xt, backend=backend, act="silu")
             * tp_dense(x, p["wu"], F, mesh, xt, backend=backend))
        observe(obs, prefix + "ffn_hidden", h)
        observe_values(obs, prefix + "ffn_hidden", h)
        return row_dense(h, p["wd"], F, mesh, backend)
    h = tp_dense(x, p["wi"], F, mesh, backend=backend, act="gelu")
    observe(obs, prefix + "ffn_hidden", h)
    observe_values(obs, prefix + "ffn_hidden", h)
    return row_dense(h, p["wo"], F, mesh, backend)


# ---------------------------------------------------------------------------
# MoE: sort-based capacity-bounded dispatch (mixtral)
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg, *, device=None,
             dtype=torch.float32) -> dict:
    """Router (float32, (D, E)) and the GLU expert stacks wg/wu (E, D, F)
    and wd (E, F, D); a shared GLU FFN of F * num_shared when the config
    has one. The stacks are scaled in place: at full width one is 3.2 GB."""
    mo = cfg.moe
    E, D, F = mo.num_experts, cfg.d_model, mo.d_ff_expert
    kw = dict(generator=gen, device=device)
    p = {"router": {"w": torch.randn((D, E), dtype=torch.float32, **kw)
                    .mul_(1.0 / math.sqrt(D))},
         "wg": {"w": torch.randn((E, D, F), dtype=dtype, **kw)
                .mul_(1.0 / math.sqrt(D))},
         "wu": {"w": torch.randn((E, D, F), dtype=dtype, **kw)
                .mul_(1.0 / math.sqrt(D))},
         "wd": {"w": torch.randn((E, F, D), dtype=dtype, **kw)
                .mul_(1.0 / math.sqrt(F))}}
    if mo.num_shared:
        p["shared"] = init_ffn(gen, cfg, d_ff=F * mo.num_shared,
                               device=device, dtype=dtype)
    return p


def _expert_gemm(xe: torch.Tensor, w, xs: Optional[torch.Tensor],
                 obs: Optional[dict], site: str, backend=None
                 ) -> torch.Tensor:
    """Batched per-expert GEMM: xe (G, E, C, D) @ w (E, D, F) ->
    (G, E, C, F). An int8 stack (per-expert-per-channel scales (E, 1, F);
    static activation scales ``xs`` (E, 1, 1) or a scalar, per-token
    without) goes to the backend, which every backend claims: the fused one
    launches ``quant_expert_gemm``, the reference one runs its plain
    version, so the two dequantize in one order and agree exactly. A float
    stack is a plain batched matmul."""
    observe(obs, site, xe)
    y = get_backend(backend).expert_gemm(xe, w, xs)
    if y is not None:
        return y.to(xe.dtype)
    return torch.matmul(xe, w.to(xe.dtype))


def _dispatch_one(xt: torch.Tensor, logits: torch.Tensor, E: int, K: int,
                  C: int):
    """Sort-based capacity dispatch of one token group. xt (T, D); logits
    (T, E). Returns (xe (E, C, D), st, sg, keep, slot) for the combine.

    The top K come from a stable descending sort, so tied logits pick the
    lower expert first as ``lax.top_k`` does (``torch.topk`` promises no
    order on CUDA), and the expert sort is stable like ``jnp.argsort``. An
    expert's (C+1)-th token is dropped: it keeps its gate but no slot."""
    Tl, D = xt.shape
    dev = xt.device
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = _softmax(vals[:, :K])
    flat_expert = idx[:, :K].reshape(-1)
    flat_token = torch.arange(Tl, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_expert, stable=True)
    se, st, sg = flat_expert[order], flat_token[order], gates.reshape(-1)[
        order]
    seg_start = torch.searchsorted(se, torch.arange(E, device=dev))
    pos_in_expert = torch.arange(Tl * K, device=dev) - seg_start[se]
    keep = pos_in_expert < C
    slot = se * C + torch.where(keep, pos_in_expert, 0)
    src = torch.where(keep[:, None], xt[st], 0.0)
    # dropped rows add +0.0 to their expert's slot 0 and every kept slot is
    # unique, so the sum is exact in any order, atomics included
    xe = torch.zeros((E * C, D), dtype=xt.dtype, device=dev).index_add_(
        0, slot, src)
    return xe.reshape(E, C, D), st, sg, keep, slot


def dropped_routings(keep: torch.Tensor, st: torch.Tensor,
                     live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """How many (token, expert) routings a capacity dispatch dropped: the
    ``keep`` and ``st`` of :func:`_dispatch_one`, counted over the tokens
    ``live`` (T,) marks (every token without it), as a 0-d tensor on the
    device (no host sync). In decode the tokens are the slots, and idle
    slots route too, so they can push a live slot's token out."""
    dropped = ~keep
    if live is not None:
        dropped = dropped & live.to(torch.bool)[st]
    return dropped.sum()


def _combine_one(ye: torch.Tensor, st, sg, keep, slot, Tl: int, D: int,
                 dtype) -> torch.Tensor:
    """Scatter the expert outputs back to their tokens, weighted by the
    gates; dropped assignments contribute zero. Each token's K
    contributions are added to zero one at a time in the sorted
    (ascending-expert) order, the order of the JAX package's scatter-add,
    with no atomics, so the sum is deterministic for any K."""
    contrib = torch.where(keep[:, None],
                          ye.reshape(-1, D)[slot] * sg[:, None].to(dtype),
                          0.0)
    K = st.shape[0] // Tl
    per_token = contrib[torch.argsort(st, stable=True)].reshape(Tl, K, D)
    y = torch.zeros((Tl, D), dtype=dtype, device=ye.device)
    for k in range(K):
        y = y + per_token[:, k]
    return y


def moe_groups(T: int, groups: int) -> int:
    """The JAX package's token-group rule: ``groups`` groups of
    T / groups tokens where they divide the T tokens, else one."""
    return groups if groups > 1 and T % groups == 0 else 1


def _experts_held(p: dict) -> int:
    """The experts a rank holds of an expert stack."""
    w = p["wg"]["w"]
    return (w.values if isinstance(w, QuantizedTensor) else w).shape[0]


def _expert_out(h: torch.Tensor, p: dict, F: int, mesh, backend):
    """The expert stack's output GEMM, ``wd``: h (G, E, C, F/tp) against
    the rank's F/tp rows of it. Without tensor parallelism the plain
    :func:`_expert_gemm`; with it, a float stack sums the ranks' float
    partials, and an int8 one their int32 accumulators (the backend's
    ``expert_gemm_acc``: codes at the static scale or at the whole row's
    per-token scale), then dequantizes as the unsharded GEMM does, so it
    equals that GEMM bit for bit."""
    w, xs = p["w"], p.get("xs")
    tp = _tp(mesh)
    rows = (w.values if isinstance(w, QuantizedTensor) else w).shape[1]
    if tp is None or rows == F:
        return _expert_gemm(h, w, xs, None, "ffn_hidden", backend)
    if not isinstance(w, QuantizedTensor):
        return dist_ag.reduce_from(torch.matmul(h, w.to(h.dtype)), tp,
                                   "model")
    acc, x_scale = get_backend(backend).expert_gemm_acc(
        h, w, xs, row_amax=lambda a: tp.all_reduce(a, "model", "max"))
    return quant_expert_gemm_epilogue(tp.all_reduce(acc, "model"), w.scale,
                                      x_scale).to(h.dtype)


def _experts(xe: torch.Tensor, p: dict, F: int, obs, backend, mesh):
    """The GLU of the expert stack a rank holds over routed rows
    (G, E, C, D) -> (G, E, C, D)."""
    w = p["wg"]["w"]
    if _tp(mesh) is not None and w.shape[-1] != F:
        # the rows enter the rank's hidden units of every expert
        xe = dist_ag.copy_to(xe, mesh, "model")
    h = (_ACT["silu"](_expert_gemm(xe, p["wg"]["w"], p["wg"].get("xs"),
                                   obs, "ffn_in_e", backend))
         * _expert_gemm(xe, p["wu"]["w"], p["wu"].get("xs"), None,
                        "ffn_in_e", backend))
    observe(obs, "ffn_hidden", h)
    observe_per_expert(obs, "expert_hidden", h)
    return _expert_out(h, p["wd"], F, mesh, backend)


def moe_block(x: torch.Tensor, p: dict, cfg, obs: Optional[dict] = None,
              backend=None, *, groups: int = 1, mesh=None,
              data_shard: bool = False) -> torch.Tensor:
    """Top-k MoE with capacity-bounded sort-based dispatch: the float32
    router picks each token's top-k experts, tokens route into per-expert
    buffers of capacity C = ceil(capacity_factor * Tl * K / E) per token
    group of Tl tokens, three expert GEMMs run the GLU over (G, E, C, D),
    and the outputs scatter back with the gates. Overflowing tokens are
    dropped (Switch semantics), per group. Every row of ``x`` routes, so
    idle decode slots take capacity as they do in the JAX engine.

    Token groups are the JAX package's: ``groups`` (the data axis of a
    mesh) where it divides the T tokens (:func:`moe_groups`), else one;
    each group is dispatched and combined on its own. On a mesh:

    * ``data_shard``: ``x`` is this rank's block of the batch, which is one
      whole group (the rank's); else every rank holds every row and routes
      every group;
    * experts over ``data`` (the rules give a rank E / dp of them where dp
      divides E): a rank runs its experts over every group's rows. With
      ``data_shard`` the groups' buffers reach the experts' ranks, and the
      outputs come back, by :meth:`ProcessMesh.all_to_all`; else each rank
      slices its experts' rows and the outputs are all-gathered;
    * each expert over ``model``: ``wg``/``wu`` column-parallel over the
      hidden units, ``wd`` row-parallel (:func:`_expert_out`). The router
      stays float32 and whole."""
    mo = cfg.moe
    B, S, D = x.shape
    T_ = B * S
    E, K = mo.num_experts, mo.top_k
    G = 1 if data_shard else moe_groups(T_, groups)
    Tl = T_ // G
    C = max(1, int(math.ceil(mo.capacity_factor * Tl * K / E)))
    observe(obs, "ffn_in", x)
    xg = x.reshape(G, Tl, D)
    routed = [_dispatch_one(xg[g], torch.matmul(xg[g].to(torch.float32),
                                                p["router"]["w"]), E, K, C)
              for g in range(G)]
    xe = torch.stack([r[0] for r in routed])         # (G, E, C, D)
    observe_per_expert(obs, "expert_in", xe)
    El = _experts_held(p)
    F = mo.d_ff_expert
    if El == E:
        ye = _experts(xe, p, F, obs, backend, mesh)
    elif data_shard:
        # (E, C, D) in dp blocks of El experts: block j to rank j; back
        # come the dp groups' rows for this rank's experts
        dp = E // El
        xin = dist_ag.all_to_all(xe[0], mesh, "data").reshape(dp, El, C, D)
        yout = _experts(xin, p, F, obs, backend, mesh)
        ye = dist_ag.all_to_all(yout.reshape(E, C, D), mesh, "data")[None]
    else:
        e0 = mesh.coords["data"] * El
        xe = dist_ag.copy_to(xe, mesh, "data")
        ye = dist_ag.gather(_experts(xe[:, e0:e0 + El].contiguous(), p,
                                     F, obs, backend, mesh), mesh, "data", 1)
    y = torch.cat([_combine_one(ye[g], *routed[g][1:], Tl, D, x.dtype)
                   for g in range(G)])
    if "shared" in p:
        y = y + ffn_block(x, p["shared"], cfg, obs=obs, prefix="shared_",
                          backend=backend, mesh=mesh,
                          d_ff=F * mo.num_shared).reshape(T_, D)
    return y.reshape(B, S, D)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def init_embeddings(gen: torch.Generator, cfg, *, device=None,
                    dtype=torch.float32) -> dict:
    kw = dict(generator=gen, dtype=dtype, device=device)
    p = {"tok": torch.randn((cfg.vocab_size, cfg.d_model), **kw) * 0.02}
    if cfg.position == "learned":
        p["pos"] = torch.randn((cfg.max_position, cfg.d_model), **kw) * 0.02
    if cfg.num_segments:
        p["seg"] = torch.randn((cfg.num_segments, cfg.d_model), **kw) * 0.02
    if cfg.frontend is not None:
        # audio frames / vision patch embeddings -> d_model
        p["frontend_proj"] = init_linear(gen, cfg.frontend_dim, cfg.d_model,
                                         True, device=device, dtype=dtype)
    if cfg.norm_kind == "layernorm" and cfg.family == "bert":
        p["emb_norm"] = init_norm("layernorm", cfg.d_model, device=device,
                                  dtype=dtype)
    return p


def _embed_rows(tokens, p: dict, positions, segments) -> torch.Tensor:
    """The reference gather: token + position + segment rows, float32."""
    x = p["tok"][tokens.long()].to(torch.float32)
    if "pos" in p:
        x = x + p["pos"][positions.long()].to(torch.float32)
    if "seg" in p and segments is not None:
        x = x + p["seg"][segments.long()].to(torch.float32)
    return x


def _tp_embed(tokens, p: dict, cfg, *, positions, segments, backend, tp):
    """The tensor-parallel embedding. A table sharded on d_model (untied)
    gathers the rank's columns, through the backend where it claims them
    (``fused_embed`` on the slice: the sum is elementwise in d_model), and
    all-gathers them. A vocab-parallel (tied) table gathers the rank's
    rows, zeros the others and sums over the ranks (one term is nonzero:
    exact). The scale and the embedding norm run on whole rows."""
    D = cfg.d_model
    tables = {k: p[k] for k in ("tok", "pos", "seg") if k in p}
    scaled = False
    if p["tok"].shape[1] != D:              # every table on d_model columns
        x = (backend.embed(tokens, tables, cfg, positions=positions,
                           segments=segments)
             if backend is not None else None)
        scaled = x is not None              # the backend scales its slice
        if x is None:
            x = _embed_rows(tokens, tables, positions, segments)
        x = dist_ag.gather(x, tp, "model", -1)
    else:
        if any(t.shape[1] != D for t in tables.values()):
            raise NotImplementedError(
                "a vocab-parallel token table beside d_model-sharded "
                "position or segment tables")
        tok = tables.pop("tok")
        Vl = tok.shape[0]
        ids = tokens.long() - tp.coords["model"] * Vl
        ok = (ids >= 0) & (ids < Vl)
        rows = tok[torch.clamp(ids, 0, Vl - 1)].to(torch.float32)
        x = dist_ag.reduce_from(torch.where(ok[..., None], rows, 0.0), tp,
                                "model")
        if "pos" in tables:
            x = x + tables["pos"][positions.long()].to(torch.float32)
        if "seg" in tables and segments is not None:
            x = x + tables["seg"][segments.long()].to(torch.float32)
    if cfg.emb_scale_by_sqrt_dim and not scaled:
        x = x * math.sqrt(D)
    if "emb_norm" in p:
        x = layer_norm(x, p["emb_norm"])
    return x


def embed(tokens: torch.Tensor, p: dict, cfg, *, positions: torch.Tensor,
          segments: Optional[torch.Tensor] = None,
          backend=None, mesh=None) -> torch.Tensor:
    """Token (+segment) (+position) embedding — the paper's Tensor-fusion
    target. A fused backend routes learned-position archs through the
    ``fused_embed`` kernel; otherwise three gathers. On a tensor-parallel
    ``mesh``, :func:`_tp_embed`."""
    tp = _tp(mesh)
    if tp is not None:
        return _tp_embed(tokens, p, cfg, positions=positions,
                         segments=segments, backend=backend, tp=tp)
    if backend is not None:
        y = backend.embed(tokens, p, cfg, positions=positions,
                          segments=segments)
        if y is not None:
            return y
    x = _embed_rows(tokens, p, positions, segments)
    if cfg.emb_scale_by_sqrt_dim:
        x = x * math.sqrt(cfg.d_model)
    if "emb_norm" in p:
        x = layer_norm(x, p["emb_norm"])
    return x


# ---------------------------------------------------------------------------
# causal temporal conv (RG-LRU / xLSTM blocks)
# ---------------------------------------------------------------------------


def init_conv1d(gen: torch.Generator, width: int, channels: int, *,
                device=None, dtype=torch.float32) -> dict:
    return {"w": torch.randn((width, channels), generator=gen, dtype=dtype,
                             device=device) / math.sqrt(width),
            "b": torch.zeros((channels,), dtype=dtype, device=device)}


def causal_conv1d(x: torch.Tensor, p: dict,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time. x: (B, S, C); ``state`` (B, W-1, C)
    carries the left context for decode. The W taps are added in the JAX
    package's order (tap 0 first), then the bias. Returns (y, new_state)."""
    W = p["w"].shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # (B, S+W-1, C)
    S = x.shape[1]
    w = p["w"].to(x.dtype)
    y = xp[:, 0:S, :] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S, :] * w[i]
    y = y + p["b"].to(x.dtype)
    new_state = xp[:, -(W - 1):, :] if W > 1 else pad
    return y, new_state
