"""Compute backends: per-op dispatch between the reference path and the CUDA
kernels (port of ``repro.kernels.backend``).

The PrecisionPlan decides *what* is quantized; the compute backend decides
*how* each quantized op executes:

* ``reference`` — declines every op, so model code runs its inline PyTorch
  implementation (``backend=None`` and ``"reference"`` are identical).
* ``fused``     — int8 block GEMMs through ``quant_linear`` (dequant + bias
  + activation in the epilogue; per-token activation scales from
  ``dynamic_quant``), the attn→ffn residual boundary through
  ``addnorm_quant`` (emitting the int8 tensor the FFN input GEMM consumes)
  and the embedding gather through ``fused_embed``. The kernel wrappers run
  their plain versions on CPU tensors, so ``fused`` also runs on the CPU,
  where it exercises the same dispatch.
* ``auto``      — ``fused`` for CUDA tensors, ``reference`` on the CPU.

Every op returns a result or ``None`` ("decline — use the reference path").
``attention``, ``decode_attention`` and ``expert_gemm`` decline in every
backend until the slices that port their kernels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Union

import torch

from repro_torch.core.quantize import QuantizedTensor, quantize
from repro_torch.kernels.addnorm_quant import addnorm_quant
from repro_torch.kernels.dynamic_quant import dynamic_quant
from repro_torch.kernels.fused_embed import fused_embed
from repro_torch.kernels.quant_linear import ACTIVATIONS, quant_linear

#: activation functions a fused GEMM epilogue can apply — exactly the
#: kernel's own table
FUSABLE_ACTS = tuple(ACTIVATIONS)


@dataclasses.dataclass
class QuantActivation:
    """A pre-quantized activation handed between fused ops: the int8
    layer-boundary tensor of the paper's Figure 2, plus the float dtype the
    consumer should emit. Produced by the fused ``addnorm`` op, consumed by
    the next block's ``linear``."""

    q: QuantizedTensor
    out_dtype: Any

    @property
    def shape(self):
        return self.q.values.shape

    def dequantize(self) -> torch.Tensor:
        return self.q.dequantize(self.out_dtype)


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
    """Reference backend: decline every op so model code runs its inline
    PyTorch implementation. Also the base class of the fused backends."""

    name = "reference"

    def linear(self, x, p: dict, *, act: Optional[str] = None):
        """One block GEMM: x (..., K) @ p["w"] (+ bias) (+ activation).
        Return the result, or None to use the caller's reference path."""
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
        """Fully-quantized encoder attention core (``quant_flash_attention``,
        not ported yet): declines."""
        return None

    def decode_attention(self, q, kv_cache, pages, *, positions, active,
                         scale, softcap=None, static_scales=None,
                         p_scale=None):
        """Paged decode attention (``decode_attention``, not ported yet):
        declines."""
        return None

    def expert_gemm(self, xe, w, xs=None):
        """Routed MoE expert GEMM (``quant_expert_gemm``, not ported yet):
        declines."""
        return None

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class FusedBackend(ComputeBackend):
    """CUDA-kernel backend: int8 blocks hit the kernels, float blocks keep
    the reference path (per-op decline)."""

    name = "fused"

    def linear(self, x, p: dict, *, act: Optional[str] = None):
        w = p.get("w")
        if (not isinstance(w, QuantizedTensor) or w.values.ndim != 2
                or act not in FUSABLE_ACTS):
            return None          # float block: reference path
        K, N = w.values.shape
        lead = x.shape[:-1]
        if isinstance(x, QuantActivation):
            # already int8 — the fused addnorm quantized it at the static
            # scale this GEMM was calibrated on
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
        y = quant_linear(x_q.contiguous(), w.values, w_scale.contiguous(),
                         x_scale, bias=p.get("b"), act=act)
        return y.reshape(*lead, N)

    def addnorm(self, delta, residual, p: dict, kind: str, next_scale,
                eps: float = 1e-6):
        if next_scale is None or residual.ndim != 3:
            return None
        B, S, D = residual.shape
        h2, q2 = addnorm_quant(
            delta.reshape(-1, D), residual.reshape(-1, D),
            torch.zeros((D,), dtype=torch.float32, device=residual.device),
            p["scale"], p.get("bias"), next_scale, kind=kind, eps=eps)
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


BACKENDS: dict[str, type] = {
    "reference": ComputeBackend,
    "fused": FusedBackend,
    "auto": AutoBackend,
}


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
