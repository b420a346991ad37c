"""The public kernel API (port of ``repro.kernels.ops``): one function for
each of the JAX module's eight entry points, under its names and keyword
arguments, each calling the port's wrapper of that kernel.

A wrapper launches its hand-written CUDA kernel for CUDA tensors and runs
its plain PyTorch version for CPU tensors (``repro_torch.kernels``), so the
same call serves the card and the CPU tests; there is no interpret switch.
Activation, weight and softmax scales stay tensor operands, as in JAX, so a
recalibrated scale is data.

Left out of the signatures: the TPU tile sizes ``bm``, ``bn`` and ``bk`` of
the GEMMs and row ops, and ``bq`` of :func:`quant_flash_attention`. On the
TPU they cut the arrays into VMEM blocks and change no result; each CUDA
kernel fixes its own tile for the card. :func:`flash_attention` keeps ``bq``
and ``bk``: they decide which key blocks the online softmax skips, which is
part of its result. :func:`fused_embed` has no ``scale``: the port's kernel
adds the rows unscaled, and the models scale after the gather.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import addnorm_quant as _anq
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import dynamic_quant as _dq
from repro_torch.kernels import expert_gemm as _eg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_embed as _fe
from repro_torch.kernels import quant_linear as _ql

Scale = Union[float, torch.Tensor]


def quant_linear(x_q, w_q, w_scale, x_scale: Scale, *, bias=None,
                 act: Optional[str] = None,
                 out_scale: Optional[Scale] = None,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused W8A8 GEMM; ``x_scale`` is a scalar (static per-tensor) or an
    (M,) / (M, 1) per-token operand, ``w_scale`` (N,) or one value for
    every column. ``out_scale`` requantizes the output to int8; otherwise
    it is cast to ``out_dtype``."""
    N = w_q.shape[1]
    ws = torch.as_tensor(w_scale, dtype=torch.float32,
                         device=w_q.device).reshape(-1)
    y = _ql.quant_linear(x_q, w_q, ws.expand(N).contiguous(), x_scale,
                         bias=bias, act=act, out_scale=out_scale)
    return y if out_scale is not None else y.to(out_dtype)


def addnorm_quant(x, residual, bias, gamma, beta, x_scale: Scale, *,
                  x_in_scale: Optional[Scale] = None,
                  kind: str = "layernorm", eps: float = 1e-6):
    """Fused residual add + norm + requantize: (h float32, codes int8).
    ``x`` may be int8, dequantized in the kernel by ``x_in_scale``."""
    return _anq.addnorm_quant(x, residual, bias, gamma, beta, x_scale,
                              x_in_scale=x_in_scale, kind=kind, eps=eps)


def fused_embed(tokens, tok_table, pos_table, seg_table=None, segments=None,
                *, positions=None, out_dtype=torch.float32) -> torch.Tensor:
    """Fused token + position + segment gather; ``positions`` (N,)
    overrides the default row-major ``arange(N) mod P`` position stream."""
    return _fe.fused_embed(tokens, tok_table, pos_table, seg_table, segments,
                           positions=positions).to(out_dtype)


def dynamic_quant(x):
    """Per-row int8 codes and their (M, 1) float32 scales (amax / 127)."""
    return _dq.dynamic_quant(x)


def quant_expert_gemm(xe, w_q, w_scale, xs=None, *,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Batched per-expert W8A8 GEMM: a routed buffer ``xe (..., E, C, D)``
    against an int8 stack ``w_q (E, D, F)`` -> ``(..., E, C, F)``. Scales
    are operands: ``w_scale`` broadcastable to (E, 1, F), ``xs`` to
    (E, 1, 1), or None for per-token scales."""
    return _eg.quant_expert_gemm(xe, w_q, w_scale, xs).to(out_dtype)


def flash_attention(q, k, v, *, causal: bool = False,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """Float flash attention. ``causal`` defaults off (the paper's
    encoder-only workloads are bidirectional); decoder paths pass
    ``causal=True`` explicitly."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale, bq=bq, bk=bk)


def quant_flash_attention(q, k, v, k_pos, *, q_scale: Scale, k_scale: Scale,
                          p_scale: Scale, v_scale: Scale,
                          o_scale: Optional[Scale] = None,
                          softcap: Optional[float] = None,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Fully-int8 encoder attention with the unsigned-uint8 softmax
    epilogue; ``o_scale`` switches the output to int8."""
    out = _fa.quant_flash_attention(q, k, v, k_pos, q_scale=q_scale,
                                    k_scale=k_scale, p_scale=p_scale,
                                    v_scale=v_scale, o_scale=o_scale,
                                    softcap=softcap)
    return out if o_scale is not None else out.to(out_dtype)


def decode_attention(q, k_pages, v_pages, page_table, lengths, *, k_scale,
                     v_scale, per_head: bool, scale: Optional[float] = None,
                     softcap: Optional[float] = None,
                     p_scale: Optional[Scale] = None) -> torch.Tensor:
    """Paged int8-KV decode attention, one query token per slot;
    ``p_scale`` selects the two-pass uint8 softmax."""
    return _da.decode_attention(q, k_pages, v_pages, page_table, lengths,
                                k_scale=k_scale, v_scale=v_scale,
                                per_head=per_head, scale=scale,
                                softcap=softcap, p_scale=p_scale)
