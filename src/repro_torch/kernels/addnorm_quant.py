"""Fused AddResidual + AddBias + Norm + Quantize (port of
``repro.kernels.addnorm_quant``).

:func:`addnorm_quant` launches the CUDA kernel in ``csrc/addnorm_quant.cu``
for CUDA tensors and runs :func:`addnorm_quant_plain`, the same contract in
plain PyTorch, for CPU tensors. One pass over the rows computes

    h = x * x_in_scale + residual + bias      (f32, the residual carry)
    y = norm(h) * gamma (+ beta)              (layernorm or rmsnorm, eps 1e-6)
    q = clip(round(y / x_scale))              (int8, feeds the next GEMM)

and returns ``(h, q)``. ``x`` may be int8 (a requantized GEMM output), then
``x_in_scale`` dequantizes it. Both scales are scalar operands.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.quantize import divide
from repro_torch.kernels import build

#: kernel launches since the last :func:`repro_torch.kernels.reset_launches`
launches = 0

# the threads of row_sum's order, 8 warps of 32
_THREADS, _WARP = 256, 32
# csrc/addnorm_quant.cu's block plan: 64 threads a row, each holding up to
# 32 float4s of h (wider rows stream); from 264 rows, 2 rows a block
ROW_THREADS, MAX_VEC, MANY_ROWS, ROWS_PER_BLOCK = 64, 32, 2 * 132, 2


def plan(M: int, D: int) -> tuple[int, int, int]:
    """The CUDA kernel's block plan for M rows of D values, as its
    ``samp_addnorm_quant_plan`` gives it: (float4s of h a thread holds in
    registers, a power of two, or 0 where the row streams; threads a row;
    rows a block). Row lane l holds the float4s at elements 256 k + 4 l."""
    nvec = -(-D // 4)
    need = -(-nvec // ROW_THREADS)
    vpt = 1
    while vpt < need:
        vpt *= 2
    return (vpt if vpt <= MAX_VEC else 0, ROW_THREADS,
            ROWS_PER_BLOCK if M >= MANY_ROWS else 1)


def row_sum(x: torch.Tensor, threads: int = _THREADS) -> torch.Tensor:
    """Sum over the last axis in the CUDA kernel's order, (..., D) ->
    (..., 1): thread t adds x[t], x[t + threads], ... in turn; each warp
    adds its 32 partials in a butterfly (pairs 16 apart, then 8, 4, 2, 1);
    the warp sums are added in turn. Float32 addition is not associative,
    so the norm statistics of the fused and the reference paths round alike
    only when both sum in one order; every norm of the port sums this way
    (256 threads, which the addnorm kernel's 64 threads a row model, 4
    each), and so does the softmax of the uint8 attention path
    (``threads=32``, one warp per query row)."""
    lead, D = x.shape[:-1], x.shape[-1]
    J = -(-D // threads)
    if J * threads != D:
        x = torch.nn.functional.pad(x, (0, J * threads - D))
    x = x.reshape(*lead, J, threads)
    acc = x[..., 0, :]
    for j in range(1, J):
        acc = acc + x[..., j, :]
    acc = acc.reshape(*lead, threads // _WARP, _WARP)
    half = _WARP // 2
    while half:
        acc = acc[..., :half] + acc[..., half:2 * half]
        half //= 2
    out = acc[..., 0, :]
    for w in range(1, threads // _WARP):
        out = out + acc[..., w, :]
    return out


def addnorm_quant_plain(x: torch.Tensor, residual: torch.Tensor,
                        bias: torch.Tensor, gamma: torch.Tensor,
                        beta: Optional[torch.Tensor],
                        x_scale: Union[float, torch.Tensor], *,
                        x_in_scale: Union[float, torch.Tensor, None] = None,
                        kind: str = "layernorm", eps: float = 1e-6):
    """The plain-PyTorch contract of :func:`addnorm_quant`; the statistics
    are float32 (the mean as sum / D, then the mean of squared deviations),
    as in the JAX kernel, summed in the CUDA kernel's order (:func:`row_sum`),
    and 1/sqrt is taken as the CUDA kernel takes it."""
    if x.dtype == torch.int8 and x_in_scale is None:
        raise ValueError("int8 delta input needs x_in_scale (its dequant "
                         "scale)")
    dev = residual.device
    D = residual.shape[-1]
    xs_in = torch.as_tensor(1.0 if x_in_scale is None else x_in_scale,
                            dtype=torch.float32, device=dev)
    h = (x.to(torch.float32) * xs_in + residual.to(torch.float32)) \
        + bias.to(torch.float32)
    if kind == "layernorm":
        mu = divide(row_sum(h), D)
        var = divide(row_sum(torch.square(h - mu)), D)
        y = (h - mu) * torch.reciprocal(torch.sqrt(var + eps)) \
            * gamma.to(torch.float32)
        if beta is not None:
            y = y + beta.to(torch.float32)
    else:
        var = divide(row_sum(torch.square(h)), D)
        y = h * torch.reciprocal(torch.sqrt(var + eps)) \
            * gamma.to(torch.float32)
    s = torch.as_tensor(x_scale, dtype=torch.float32, device=dev)
    q = torch.clamp(torch.round(y / s), -128, 127).to(torch.int8)
    return h, q


def addnorm_quant(x: torch.Tensor, residual: torch.Tensor, bias: torch.Tensor,
                  gamma: torch.Tensor, beta: Optional[torch.Tensor],
                  x_scale: Union[float, torch.Tensor], *,
                  x_in_scale: Union[float, torch.Tensor, None] = None,
                  kind: str = "layernorm", eps: float = 1e-6):
    """x, residual: (M, D); bias/gamma/beta: (D,); x_scale (and
    x_in_scale, required for int8 x): scalars. Returns (h (M, D) float32,
    q (M, D) int8). ``kind``: 'layernorm' | 'rmsnorm'."""
    global launches
    if residual.device.type == "cpu":
        return addnorm_quant_plain(x, residual, bias, gamma, beta, x_scale,
                                   x_in_scale=x_in_scale, kind=kind, eps=eps)
    name = "addnorm_quant"
    if residual.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {residual.device}")
    if kind not in ("layernorm", "rmsnorm"):
        raise ValueError(f"{name}: unknown norm kind {kind!r}")
    if x.shape != residual.shape or residual.ndim != 2:
        raise ValueError(f"{name}: x {tuple(x.shape)} and residual "
                         f"{tuple(residual.shape)} must both be (M, D)")
    dev = residual.device
    M, D = residual.shape
    x_int8 = x.dtype == torch.int8
    if x_int8 and x_in_scale is None:
        raise ValueError("int8 delta input needs x_in_scale (its dequant "
                         "scale)")
    build.operand(name, "x", x, torch.int8 if x_int8 else torch.float32, dev)
    build.operand(name, "residual", residual, torch.float32, dev)
    for vec_name, vec in (("bias", bias), ("gamma", gamma), ("beta", beta)):
        if vec is None:
            continue
        build.operand(name, vec_name, vec, torch.float32, dev)
        if vec.numel() != D:
            raise ValueError(f"{name}: {vec_name} has {vec.numel()} values "
                             f"for D={D}")
    s = build.scalar(name, "x_scale", x_scale, dev)
    s_in = (build.scalar(name, "x_in_scale", x_in_scale, dev)
            if x_in_scale is not None else None)
    h = torch.empty((M, D), dtype=torch.float32, device=dev)
    q = torch.empty((M, D), dtype=torch.int8, device=dev)
    P, I = build.P, build.I
    fn = build.function("samp_addnorm_quant",
                        (P, I, P, P, P, P, P, P, P, P, I, I, I, build.F, P))
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), int(x_int8), residual.data_ptr(),
                bias.data_ptr(), gamma.data_ptr(),
                beta.data_ptr() if beta is not None else None,
                s.data_ptr(), s_in.data_ptr() if s_in is not None else None,
                h.data_ptr(), q.data_ptr(), M, D, int(kind == "rmsnorm"),
                float(eps), build.stream(dev))
    build.check(rc, name)
    launches += 1
    return h, q
