"""Fully-int8 encoder attention with the uint8 softmax epilogue (port of
``repro.kernels.flash_attention.quant_flash_attention``; the float
``flash_attention`` of the same JAX module is not ported yet).

:func:`quant_flash_attention` launches the CUDA kernel in
``csrc/quant_flash_attention.cu`` for CUDA tensors and runs
:func:`quant_flash_attention_plain`, the same contract in plain PyTorch,
for CPU tensors. Per (batch, query head):

    s = int32(q @ k^T) * (q_scale * k_scale)      (+ softcap), -inf where k_pos < 0
    p = exp(s - max) / sum                         exact float32 softmax
    c = clip(rint(p / p_scale) - 128)              uint8 codes, zero point -128
    o = (int32(c @ v) + 128 * sum(v)) * (p_scale * v_scale)

written as float32, or requantized to int8 at ``o_scale``. The softmax
denominator is summed in the kernel's order (:func:`softmax_sum`), which
sets the last bit of ``p`` and so the codes at ties.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.core.quantize import INT8_MAX, INT8_MIN, divide, int_matmul
from repro_torch.kernels import build
from repro_torch.kernels.addnorm_quant import row_sum

# the mask value of the JAX kernel: finite, so a row whose keys are all
# padding gets a uniform softmax instead of NaN
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# shared memory a block may use on the H100 after opting in
_MAX_SMEM = 232448

#: kernel launches since the last :func:`repro_torch.kernels.reset_launches`
launches = 0

Scale = Union[float, torch.Tensor]


def softmax_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the key axis in the kernel's order: one warp per query row,
    lane l adding keys l, l + 32, ... in turn, then a butterfly."""
    return row_sum(e, threads=32)


def _scalar(v: Scale, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def quant_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, k_pos: torch.Tensor, *,
                                q_scale: Scale, k_scale: Scale,
                                p_scale: Scale, v_scale: Scale,
                                o_scale: Optional[Scale] = None,
                                softcap: Optional[float] = None
                                ) -> torch.Tensor:
    """The plain-PyTorch contract of :func:`quant_flash_attention`."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    qs, ks, ps, vs = (_scalar(x, q) for x in (q_scale, k_scale, p_scale,
                                                v_scale))
    s = int_matmul(q, k.transpose(-1, -2)).to(torch.float32) * (qs * ks)
    if softcap is not None:
        s = torch.tanh(divide(s, softcap)) * softcap
    valid = k_pos.reshape(-1, 1, 1, Sk).to(torch.int32) >= 0
    s = torch.where(valid, s, NEG_INF)
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = e / softmax_sum(e)
    codes = torch.clamp(torch.round(p / ps) + INT8_MIN, INT8_MIN, INT8_MAX)
    vsum = v.to(torch.int32).sum(dim=2, keepdim=True)
    acc = int_matmul(codes.to(torch.int8), v) - INT8_MIN * vsum
    o = acc.to(torch.float32) * (ps * vs)
    if o_scale is not None:
        o = torch.round(o / _scalar(o_scale, q))
        return torch.clamp(o, INT8_MIN, INT8_MAX).to(torch.int8)
    return o


def quant_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_pos: torch.Tensor, *, q_scale: Scale,
                          k_scale: Scale, p_scale: Scale, v_scale: Scale,
                          o_scale: Optional[Scale] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d) int8, quantized from ``q * rsqrt(d)`` at
    ``q_scale``; k, v: (B, Hkv, Sk, d) int8 with Hq % Hkv == 0; k_pos:
    (B, Sk) or (Sk,) int32 key positions, -1 = padding. The scales are
    scalar operands. Returns (B, Hq, Sq, d) float32, or int8 when
    ``o_scale`` is given."""
    global launches
    kw = dict(q_scale=q_scale, k_scale=k_scale, p_scale=p_scale,
              v_scale=v_scale, o_scale=o_scale, softcap=softcap)
    if q.device.type == "cpu":
        return quant_flash_attention_plain(q, k, v, k_pos, **kw)
    name = "quant_flash_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be (B, H, S, d) with k "
                         f"and v alike")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not attend over "
                         f"k {tuple(k.shape)} (batch, dim, Hq % Hkv)")
    if D % 4:
        raise ValueError(f"{name}: head dim {D} is not a multiple of 4")
    dev = q.device
    for arg, t in (("q", q), ("k", k), ("v", v)):
        build.operand(name, arg, t, torch.int8, dev)
    if k_pos.numel() not in (Sk, B * Sk):
        raise ValueError(f"{name}: k_pos has {k_pos.numel()} values for "
                         f"B={B}, Sk={Sk}")
    if k_pos.device != dev:
        raise ValueError(f"{name}: k_pos is on {k_pos.device}, the kernel "
                         f"runs on {dev}")
    kp = torch.broadcast_to(k_pos.reshape(-1, Sk).to(torch.int32),
                            (B, Sk)).contiguous()
    smem = build.function("samp_quant_flash_attention_smem",
                          (build.I, build.I), ctypes.c_longlong)(Sk, D)
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: Sk={Sk}, d={D} needs {smem} bytes of "
                         f"shared memory, over the {_MAX_SMEM} a block has")
    scales = [build.scalar(name, n, x, dev) for n, x in (
        ("q_scale", q_scale), ("k_scale", k_scale), ("p_scale", p_scale),
        ("v_scale", v_scale))]
    requant = o_scale is not None
    os_ = build.scalar(name, "o_scale", o_scale, dev) if requant else None
    out = torch.empty((B, Hq, Sq, D),
                      dtype=torch.int8 if requant else torch.float32,
                      device=dev)
    P, I = build.P, build.I
    fn = build.function("samp_quant_flash_attention",
                        (P,) * 11 + (I,) * 7 + (build.F, P))
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kp.data_ptr(),
                *(s.data_ptr() for s in scales),
                os_.data_ptr() if requant else None,
                None if requant else out.data_ptr(),
                out.data_ptr() if requant else None,
                B, Hq, Hkv, Sq, Sk, D, int(softcap is not None),
                float(softcap) if softcap is not None else 0.0,
                build.stream(dev))
    build.check(rc, name)
    launches += 1
    return out
