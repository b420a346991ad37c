"""Compute backends: per-op dispatch between the reference path and the CUDA
kernels (port of ``repro.kernels.backend``).

The PrecisionPlan decides *what* is quantized; the compute backend decides
*how* each quantized op executes:

* ``reference`` — declines every op but ``decode_attention`` and
  ``expert_gemm``, so model code runs its inline PyTorch implementation
  (``backend=None`` and ``"reference"`` are identical). The one-token decode
  step over int8 KV pages runs the ``decode_attention`` kernel's plain
  version, and an int8 expert stack the ``quant_expert_gemm`` plain version,
  so fused and reference agree exactly on the card.
* ``fused``     — int8 block GEMMs through ``quant_linear`` (dequant + bias
  + activation in the epilogue; per-token activation scales from
  ``dynamic_quant``; requantized to int8 at ``out_xs`` inside a schema-v3
  ``norm='int8'`` span), the attn→ffn residual boundary through
  ``addnorm_quant`` (emitting the int8 tensor the FFN input GEMM consumes,
  and taking an int8 delta inside the span), the bidirectional attention
  core of ``softmax='uint8'`` layers through ``quant_flash_attention``, the
  one-token decode step over int8 KV pages through ``decode_attention``, the
  routed int8 expert GEMMs of an MoE layer through ``quant_expert_gemm``
  (per-token scales for the whole routed buffer from one ``dynamic_quant``
  launch), and the embedding gather through ``fused_embed``. The kernel
  wrappers run their plain versions on CPU tensors, so ``fused`` also runs
  on the CPU, where it exercises the same dispatch. A claim depends on the
  plan and the layer kind, never on a shape: on the card each claimed op
  launches its kernel (the quantized attention core streams K and V past
  a block's shared memory; the attention kernels take any head dim, past
  256 on their wide kernels, and decode attention any GQA group) or
  raises.
* ``auto``      — ``fused`` for CUDA tensors, ``reference`` on the CPU
  (where ``decode_attention`` and ``expert_gemm`` are the same plain
  versions in both).

Every op returns a result or ``None`` ("decline — use the reference path").

On a tensor-parallel mesh every op sees one rank's local tensors (its
block of a weight, its heads, its KV heads) and claims them as it claims
whole ones: the kernels take any width their vector paths take (qwen2's
``wk``/``wv`` shard, N = 64 at tp 2; ``decode_attention`` on a rank's one
KV head and its group of 7 query heads). A row-parallel int8
GEMM (K split over the ranks) runs :meth:`FusedBackend.linear_acc`: the
``quant_linear`` kernel in its accumulator mode, codes at the whole row's
per-token scale (``dynamic_quant``'s scale-in mode), the epilogue after the
ranks' int32 sums; a row-parallel int8 expert stack (``wd`` under
per-expert tensor parallelism) runs :meth:`FusedBackend.expert_gemm_acc`,
``quant_expert_gemm``'s accumulator mode, the same way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Union

import torch

from repro_torch.core.quantize import QuantizedTensor, int_matmul, quantize
from repro_torch.kernels.addnorm_quant import addnorm_quant
from repro_torch.kernels.decode_attention import (decode_attention as
                                                  paged_decode_attention)
from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                  paged_operands)
from repro_torch.kernels.dynamic_quant import dynamic_quant
from repro_torch.kernels.expert_gemm import (expert_codes_plain,
                                             quant_expert_gemm,
                                             quant_expert_gemm_acc,
                                             quant_expert_gemm_plain)
from repro_torch.kernels.flash_attention import quant_flash_attention
from repro_torch.kernels.fused_embed import fused_embed
from repro_torch.kernels.quant_linear import (ACTIVATIONS, quant_linear,
                                              quant_linear_acc)

#: activation functions a fused GEMM epilogue can apply — exactly the
#: kernel's own table
FUSABLE_ACTS = tuple(ACTIVATIONS)


@dataclasses.dataclass
class QuantActivation:
    """A pre-quantized activation handed between fused ops: the int8
    layer-boundary tensor of the paper's Figure 2, plus the float dtype the
    consumer should emit. Produced by the fused ``addnorm``, ``attention``
    and requantizing ``linear`` ops, consumed by the next ``linear`` or
    ``addnorm``."""

    q: QuantizedTensor
    out_dtype: Any

    @property
    def shape(self):
        return self.q.values.shape

    @property
    def dtype(self):
        return self.out_dtype

    def dequantize(self) -> torch.Tensor:
        return self.q.dequantize(self.out_dtype)

    def reshape(self, *shape) -> "QuantActivation":
        """Reshape the int8 payload (every producer here quantizes per
        tensor), so model-code reshapes between GEMMs, such as the
        (B, S, H, hd) -> (B, S, q_dim) head fold before attn_out, work on
        pre-quantized activations unchanged."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return QuantActivation(
            QuantizedTensor(self.q.values.reshape(shape), self.q.scale,
                            self.q.zero_point), self.out_dtype)

    def transpose(self, dim0: int, dim1: int) -> "QuantActivation":
        return QuantActivation(
            QuantizedTensor(self.q.values.transpose(dim0, dim1),
                            self.q.scale, self.q.zero_point), self.out_dtype)


def ffn_input_scale(ffn_p: dict, ffn_kind: str) -> Optional[torch.Tensor]:
    """The static activation scale the layer's ffn_in GEMMs were calibrated
    with — present iff the plan made the block int8 with static acts; the
    requant scale the fused addnorm kernel needs."""
    key = "wg" if ffn_kind == "glu" else "wi"
    sub = ffn_p.get(key)
    if not isinstance(sub, dict) or not isinstance(sub.get("w"),
                                                   QuantizedTensor):
        return None
    return sub.get("xs")


class ComputeBackend:
    """Reference backend: decline every op but ``decode_attention`` so model
    code runs its inline PyTorch implementation. Also the base class of the
    fused backends."""

    name = "reference"

    def linear(self, x, p: dict, *, act: Optional[str] = None):
        """One block GEMM: x (..., K) @ p["w"] (+ bias) (+ activation).
        Return the result, or None to use the caller's reference path."""
        return None

    def linear_acc(self, x, p: dict, *, row_amax=None):
        """The int32 accumulator of a row-parallel int8 GEMM (this rank's
        columns of ``x`` against its rows of ``w``) and the activation
        scale it was coded at: ``(acc (M, N), x_scale)``, or None to use
        the caller's reference path. ``row_amax`` maps this rank's per-row
        amax (M,) to the whole row's (a max over the model axis)."""
        return None

    def addnorm(self, delta, residual, p: dict, kind: str, next_scale,
                eps: float = 1e-6):
        """The residual boundary: (residual + delta, norm(...)) requantized
        for the next GEMM at its static act scale ``next_scale``. Return
        (new_residual, QuantActivation), or None."""
        return None

    def embed(self, tokens, p: dict, cfg, *, positions, segments):
        """Token + position (+ segment) embedding. Return (B, S, D), or
        None to use the reference gather."""
        return None

    def attention(self, q, k, v, p: dict, *, k_pos, spec, scale,
                  softcap=None):
        """Fully-quantized encoder attention core: q (B, Sq, Hq, d), k, v
        (B, Sk, Hkv, d) float, ``k_pos`` the key positions (-1 = padding).
        Return (B, Sq, Hq, d) float or a QuantActivation, or None."""
        return None

    def decode_attention(self, q, kv_cache, pages, *, positions, active,
                         scale, softcap=None, static_scales=None,
                         p_scale=None):
        """One decode step over a paged cache: q (B, 1, Hq, d) against the
        cache's pages through the page table ``pages``, at per-row
        ``positions`` (B, 1), with ``active`` (B,) gating slots. Return
        (B, 1, Hq, d) from :meth:`paged_decode` over int8 pages, or None
        (float pages, a missing per-head scale) so the model gathers the
        pages and runs its attention core."""
        ops = paged_operands(q, kv_cache, pages, positions=positions,
                             active=active, static_scales=static_scales)
        if ops is None:
            return None
        out = self.paged_decode(**ops, scale=float(scale), softcap=softcap,
                                p_scale=p_scale)
        B, _, Hq, d = q.shape
        return out.reshape(B, 1, Hq, d)

    def paged_decode(self, **ops):
        """The decode step over int8 pages: the ``decode_attention``
        kernel's plain version here, its wrapper in the fused backends."""
        return decode_attention_plain(**ops)

    def expert_gemm(self, xe, w, xs=None):
        """Routed MoE expert GEMM: xe (G, E, C, D) against an int8 stack
        ``w`` (E, D, F) with per-expert scales (weights (E, 1, F); static
        acts ``xs`` (E, 1, 1) or a scalar, else per token). Returns float32
        (G, E, C, F) from :meth:`quant_experts`, or None for a float stack
        (the model's batched matmul)."""
        if not isinstance(w, QuantizedTensor):
            return None
        return self.quant_experts(xe, w.values, w.scale, xs)

    def quant_experts(self, xe, w_q, w_scale, xs):
        """The int8 expert GEMM: the ``quant_expert_gemm`` kernel's plain
        version here, its wrapper in the fused backends."""
        return quant_expert_gemm_plain(xe, w_q, w_scale, xs)

    def expert_gemm_acc(self, xe, w, xs=None, *, row_amax=None):
        """The int32 accumulator of a row-parallel int8 expert stack (this
        rank's columns of ``xe`` (G, E, C, D/tp) against its rows of ``w``)
        and the activation scales it was coded at, broadcastable to
        (G, E, C, 1): ``(acc (G, E, C, F), x_scale)``, or None for a float
        stack. ``row_amax`` maps this rank's per-row amax (G, E, C) to the
        whole row's (a max over the model axis). Every backend claims an
        int8 stack: the plain version here."""
        if not isinstance(w, QuantizedTensor):
            return None
        E = w.values.shape[0]
        amax = (None if xs is not None else
                row_amax(torch.amax(xe.abs(), dim=-1).to(torch.float32)))
        codes, x_scale = expert_codes_plain(xe, E, xs, amax)
        return int_matmul(codes, w.values), x_scale

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class FusedBackend(ComputeBackend):
    """CUDA-kernel backend: int8 blocks hit the kernels, float blocks keep
    the reference path (per-op decline)."""

    name = "fused"

    @staticmethod
    def _claims(w, act=None) -> bool:
        # an int8 2-D block with an activation the epilogue applies
        return (isinstance(w, QuantizedTensor) and w.values.ndim == 2
                and act in FUSABLE_ACTS)

    def linear(self, x, p: dict, *, act: Optional[str] = None):
        w = p.get("w")
        if not self._claims(w, act):
            return None          # float block: reference path
        K, N = w.values.shape
        lead = x.shape[:-1]
        if isinstance(x, QuantActivation):
            # already int8 — the producing kernel quantized it at the
            # static scale this GEMM was calibrated on
            x_q = x.q.values.reshape(-1, K)
            x_scale = x.q.scale
        else:
            x2 = x.reshape(-1, K)
            xs = p.get("xs")
            if xs is not None:                     # static per-tensor scale
                x_q, x_scale = quantize(x2, xs), xs
            else:                                  # per-token dynamic scales
                x_q, x_scale = dynamic_quant(x2.contiguous())
        w_scale = w.scale.to(torch.float32).reshape(-1)
        if w_scale.shape[0] != N:                  # int8_per_tensor weights
            w_scale = w_scale.expand(N)
        # ``out_xs`` (attached by apply_plan under a norm='int8' span) is
        # the next consumer's calibrated activation scale: the epilogue
        # requantizes, and the result stays int8 between the GEMMs
        out_xs = p.get("out_xs")
        y = quant_linear(x_q.contiguous(), w.values, w_scale.contiguous(),
                         x_scale, bias=p.get("b"), act=act,
                         out_scale=out_xs).reshape(*lead, N)
        if out_xs is not None:
            return QuantActivation(QuantizedTensor(y, out_xs, None),
                                   x.dtype)
        return y

    def linear_acc(self, x, p: dict, *, row_amax=None):
        w = p.get("w")
        if not self._claims(w):
            return None
        K = w.values.shape[0]
        if isinstance(x, QuantActivation):
            x_q, x_scale = x.q.values.reshape(-1, K), x.q.scale
        else:
            x2 = x.reshape(-1, K)
            xs = p.get("xs")
            if xs is not None:                     # static per-tensor scale
                x_q, x_scale = quantize(x2, xs), xs
            else:                                  # the whole row's scale
                amax = row_amax(torch.amax(x2.abs(), dim=-1)
                                .to(torch.float32))
                x_q, x_scale = dynamic_quant(x2.contiguous(), row_amax=amax)
        return quant_linear_acc(x_q.contiguous(), w.values), x_scale

    def addnorm(self, delta, residual, p: dict, kind: str, next_scale,
                eps: float = 1e-6):
        if next_scale is None or residual.ndim != 3:
            return None
        B, S, D = residual.shape
        if isinstance(delta, QuantActivation):
            # the producing GEMM requantized its output (norm='int8' span):
            # the kernel dequantizes the int8 payload by x_in_scale
            d2, d_scale = delta.q.values.reshape(-1, D), delta.q.scale
        else:
            d2, d_scale = delta.reshape(-1, D), None
        h2, q2 = addnorm_quant(
            d2.contiguous(), residual.reshape(-1, D),
            torch.zeros((D,), dtype=torch.float32, device=residual.device),
            p["scale"], p.get("bias"), next_scale, x_in_scale=d_scale,
            kind=kind, eps=eps)
        qa = QuantActivation(
            QuantizedTensor(q2.reshape(B, S, D), next_scale, None),
            residual.dtype)
        return h2.reshape(B, S, D), qa

    def embed(self, tokens, p: dict, cfg, *, positions, segments):
        # learned-position archs only (the paper's BERT family)
        if "pos" not in p or cfg.frontend is not None:
            return None
        B, S = tokens.shape
        pos = torch.broadcast_to(positions, (B, S))
        seg_table = seg = None
        if "seg" in p and segments is not None:
            seg_table, seg = p["seg"], segments.reshape(-1)
        x = fused_embed(tokens.reshape(-1), p["tok"], p["pos"], seg_table,
                        seg, positions=pos.reshape(-1))
        x = x.reshape(B, S, -1)
        # the scale / emb-norm epilogue of repro_torch.models.layers.embed
        if cfg.emb_scale_by_sqrt_dim:
            x = x * math.sqrt(cfg.d_model)
        if "emb_norm" in p:
            from repro_torch.models.layers import layer_norm
            x = layer_norm(x, p["emb_norm"])
        return x

    def attention(self, q, k, v, p: dict, *, k_pos, spec, scale,
                  softcap=None):
        # Claims the bidirectional core when the plan calibrated all four
        # scheme scales (softmax='uint8' with a static int8 qkv block). The
        # kernel holds the whole key axis and masks on validity only, so
        # causal and windowed specs keep the reference path.
        if (spec.causal or spec.window is not None
                or any(f"{s}_scale" not in p for s in ("q", "k", "p", "v"))):
            return None
        Hq, Hkv = q.shape[2], k.shape[2]
        if Hq % Hkv:
            return None
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        # the score scaling rides the q quantization, as in the reference
        # quant_bmm, which quantizes q * rsqrt(d)
        qq = quantize(qh * scale, p["q_scale"]).contiguous()
        kq = quantize(kh, p["k_scale"]).contiguous()
        vq = quantize(vh, p["v_scale"]).contiguous()
        # requantize at the attn_out GEMM's calibrated activation scale, so
        # the span's first hop is int8
        wo = p.get("wo", {})
        o_scale = (wo.get("xs") if isinstance(wo.get("w"), QuantizedTensor)
                   else None)
        out = quant_flash_attention(
            qq, kq, vq, k_pos, q_scale=p["q_scale"], k_scale=p["k_scale"],
            p_scale=p["p_scale"], v_scale=p["v_scale"], o_scale=o_scale,
            softcap=softcap).transpose(1, 2)        # (B, Sq, Hq, d)
        if o_scale is not None:
            return QuantActivation(QuantizedTensor(out, o_scale, None),
                                   q.dtype)
        return out

    def paged_decode(self, **ops):
        # int8 pages only (float pages decline in paged_operands): the
        # kernel's gain is reading the int8 pool with the dequantization
        # fused into both dots; on the CPU the wrapper runs the plain version
        return paged_decode_attention(**ops)

    def quant_experts(self, xe, w_q, w_scale, xs):
        # one launch for every expert of the stack; the wrapper quantizes
        # the whole routed buffer first (per-token: one dynamic_quant
        # launch), and on the CPU runs the plain version
        return quant_expert_gemm(xe.contiguous(), w_q, w_scale, xs)

    def expert_gemm_acc(self, xe, w, xs=None, *, row_amax=None):
        # the kernel's accumulator mode over the codes of the whole routed
        # buffer: static codes as the wrapper takes them, per-token ones in
        # one dynamic_quant launch at the whole rows' scales
        if not isinstance(w, QuantizedTensor):
            return None
        if xe.device.type == "cpu":
            return super().expert_gemm_acc(xe, w, xs, row_amax=row_amax)
        E, D = w.values.shape[0], xe.shape[-1]
        x4 = xe.reshape((-1,) + tuple(xe.shape[-3:]))
        if xs is not None:
            x_scale = torch.broadcast_to(
                torch.as_tensor(xs, dtype=torch.float32,
                                device=xe.device).reshape(-1), (E,))
            x_scale = x_scale.reshape(1, E, 1, 1)
            codes = quantize(x4, x_scale)
        else:
            amax = row_amax(torch.amax(x4.abs(), dim=-1)
                            .to(torch.float32))
            codes, x_scale = dynamic_quant(x4.reshape(-1, D).contiguous(),
                                           row_amax=amax.reshape(-1))
            codes = codes.reshape(x4.shape)
            x_scale = x_scale.reshape(x4.shape[:-1] + (1,))
        return (quant_expert_gemm_acc(codes.contiguous(), w.values,
                                      per_token=xs is None), x_scale)


def _on_cuda(t) -> bool:
    if isinstance(t, QuantActivation):
        t = t.q.values
    return t.device.type == "cuda"


class AutoBackend(FusedBackend):
    """``fused`` for CUDA tensors, ``reference`` for CPU tensors: the CPU
    only has the kernels' plain versions, which are a correctness tool, not
    a serving path."""

    name = "auto"

    def linear(self, x, p: dict, *, act: Optional[str] = None):
        return super().linear(x, p, act=act) if _on_cuda(x) else None

    def linear_acc(self, x, p: dict, *, row_amax=None):
        return (super().linear_acc(x, p, row_amax=row_amax)
                if _on_cuda(x) else None)

    def addnorm(self, delta, residual, p: dict, kind: str, next_scale,
                eps: float = 1e-6):
        if not _on_cuda(residual):
            return None
        return super().addnorm(delta, residual, p, kind, next_scale, eps)

    def embed(self, tokens, p: dict, cfg, *, positions, segments):
        if not _on_cuda(tokens):
            return None
        return super().embed(tokens, p, cfg, positions=positions,
                             segments=segments)

    def attention(self, q, k, v, p: dict, *, k_pos, spec, scale,
                  softcap=None):
        if not _on_cuda(q):
            return None
        return super().attention(q, k, v, p, k_pos=k_pos, spec=spec,
                                 scale=scale, softcap=softcap)


BACKENDS: dict[str, type] = {
    "reference": ComputeBackend,
    "fused": FusedBackend,
    "auto": AutoBackend,
}


def register_backend(name: str, cls: type) -> type:
    """Register a :class:`ComputeBackend` subclass under ``name``, so that
    :func:`get_backend` (and every ``backend=`` argument that takes a name)
    resolves it. Returns ``cls``."""
    BACKENDS[name] = cls
    return cls


def get_backend(backend: Union[str, ComputeBackend, None]) -> ComputeBackend:
    """Resolve a backend name (or pass an instance through). ``None`` means
    reference."""
    if backend is None:
        return ComputeBackend()
    if isinstance(backend, ComputeBackend):
        return backend
    try:
        cls = BACKENDS[backend]
    except (KeyError, TypeError):
        raise KeyError(f"unknown compute backend {backend!r}; have "
                       f"{sorted(BACKENDS)}") from None
    return cls()
