"""Routed MoE expert GEMM (port of ``repro.kernels.ops.quant_expert_gemm``).

:func:`quant_expert_gemm` launches the CUDA kernel in
``csrc/quant_expert_gemm.cu`` for CUDA tensors, one launch for every expert
of the stack, and runs :func:`quant_expert_gemm_plain`, the same contract
in plain PyTorch, for CPU tensors:

    codes = quantize(xe) over the whole routed buffer, in one op
    y[..., e, c, :] = int32(codes[..., e, c, :] @ w_q[e]) * (x_scale * w_scale[e])

``xe`` is the routed capacity buffer (G, E, C, D) (or (E, C, D)), ``w_q``
the int8 stack (E, D, F) with per-expert-per-channel scales broadcastable
to (E, 1, F), and ``xs`` the static activation scale, a scalar or one per
expert ((E, 1, 1)); without it every row of the buffer gets its own scale.
The buffer is quantized whole before it is sliced per expert: quantizing
expert slices apart lets a compiler round them differently, and the router
turns a flipped code into a different top-k (``ops.py:100-106`` in the JAX
package). The output is float32 (G, E, C, F).

:func:`quant_expert_gemm_acc` is its accumulator mode: the int32 sums of
given codes, no epilogue. Per-expert tensor parallelism splits a
row-parallel stack's D (``wd``'s hidden units) over its ranks, sums the
ranks' accumulators and then runs :func:`quant_expert_gemm_epilogue`, so
the sharded stack equals the whole one bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantize import (compute_scale_symmetric, int_matmul,
                                       quantize, quantize_per_token)
from repro_torch.kernels import build
from repro_torch.kernels.dynamic_quant import dynamic_quant
from repro_torch.kernels.quant_linear import (quant_linear_splits,
                                              quant_linear_workspace)

#: kernel launches since the last :func:`repro_torch.kernels.reset_launches`
launches = 0
#: of those, the launches with per-token activation scales
per_token_launches = 0
#: of those, the launches of the accumulator mode
acc_launches = 0


def _weight_scales(w_scale: torch.Tensor, E: int, F: int) -> torch.Tensor:
    """Weight scales broadcast to (E, F) float32."""
    ws = torch.as_tensor(w_scale, dtype=torch.float32)
    ws = ws.reshape((1, 1, -1) if ws.ndim < 3 else ws.shape)
    return torch.broadcast_to(ws, (E, 1, F)).reshape(E, F)


def _expert_scales(xs, E: int, device) -> torch.Tensor:
    """A static activation scale (a scalar, (E,) or (E, 1, 1)) as (E,)."""
    xs = torch.as_tensor(xs, dtype=torch.float32, device=device)
    if xs.numel() not in (1, E):
        raise ValueError(f"quant_expert_gemm: xs has {xs.numel()} values "
                         f"for E={E} experts")
    return torch.broadcast_to(xs.reshape(-1), (E,))


def expert_codes_plain(xe: torch.Tensor, E: int,
                       xs: Optional[torch.Tensor] = None, row_amax=None):
    """The int8 codes of a routed buffer (..., E, C, D) and the activation
    scales they were taken at, broadcastable to (G, E, C, 1): the static
    ``xs`` (a scalar, (E,) or (E, 1, 1)), else one scale a row, from the
    row's amax or from ``row_amax`` (..., E, C), the whole row's where
    ``xe`` holds one rank's columns of it."""
    x4 = xe.reshape((-1,) + tuple(xe.shape[-3:]))          # (G, E, C, D)
    if xs is not None:
        xs_e = _expert_scales(xs, E, xe.device).reshape(1, E, 1, 1)
        return quantize(x4, xs_e), xs_e
    if row_amax is None:
        q = quantize_per_token(x4)
        return q.values, q.scale                             # (G, E, C, 1)
    scale = compute_scale_symmetric(row_amax.reshape(x4.shape[:-1] + (1,)))
    return quantize(x4, scale), scale


def quant_expert_gemm_epilogue(acc: torch.Tensor, w_scale: torch.Tensor,
                               x_scale: torch.Tensor) -> torch.Tensor:
    """The kernel's epilogue on an int32 accumulator (G, E, C, F), in its
    order: acc * (x_scale * w_scale[e]); ``x_scale`` broadcastable to
    (G, E, C, 1)."""
    E, F = acc.shape[-3], acc.shape[-1]
    ws = _weight_scales(w_scale, E, F).to(acc.device).reshape(1, E, 1, F)
    return acc.to(torch.float32) * (x_scale.to(torch.float32) * ws)


def quant_expert_gemm_plain(xe: torch.Tensor, w_q: torch.Tensor,
                            w_scale: torch.Tensor,
                            xs: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The plain-PyTorch contract of :func:`quant_expert_gemm`, in the
    kernel's order of the dequantization: acc * (x_scale * w_scale)."""
    E = w_q.shape[0]
    codes, xs_e = expert_codes_plain(xe, E, xs)
    y = quant_expert_gemm_epilogue(int_matmul(codes, w_q), w_scale, xs_e)
    return y.reshape(xe.shape[:-3] + tuple(y.shape[-3:]))


def quant_expert_gemm_acc(codes: torch.Tensor, w_q: torch.Tensor, *,
                          per_token: bool = False) -> torch.Tensor:
    """The accumulator mode of :func:`quant_expert_gemm`: int8 codes
    (G, E, C, D) against w_q (E, D, F) int8 as int32 (G, E, C, F), with no
    epilogue (:func:`~repro_torch.core.quantize.int_matmul` on the CPU).
    One launch for every expert of the stack, counted with the kernel's
    other launches (``per_token``: the codes were taken at per-token
    scales, which only the counters read)."""
    global launches, per_token_launches, acc_launches
    if codes.device.type == "cpu":
        return int_matmul(codes, w_q)
    if codes.device.type != "cuda":
        raise ValueError(f"quant_expert_gemm: no kernel for device "
                         f"{codes.device}")
    name = "quant_expert_gemm"
    if codes.ndim != 4 or w_q.ndim != 3:
        raise ValueError(f"{name}: codes {tuple(codes.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not form (G, E, C, D) @ "
                         f"(E, D, F)")
    G, E, C, D = codes.shape
    F = w_q.shape[2]
    if tuple(w_q.shape[:2]) != (E, D):
        raise ValueError(f"{name}: codes {tuple(codes.shape)} do not route "
                         f"into the stack {tuple(w_q.shape)}")
    dev = codes.device
    build.operand(name, "codes", codes, torch.int8, dev)
    build.operand(name, "w_q", w_q, torch.int8, dev)
    acc = torch.empty((G, E, C, F), dtype=torch.int32, device=dev)
    splits = quant_linear_splits(G * C, F, D, E)
    work = (torch.zeros(quant_linear_workspace(G * C, F, D, E),
                        dtype=torch.int32, device=dev) if splits > 1 else None)
    P, I = build.P, build.I
    fn = build.function("samp_quant_expert_gemm_acc",
                        (P, P, P, P, I, I, I, I, I, I, P))
    with torch.cuda.device(dev):
        rc = fn(codes.data_ptr(), w_q.data_ptr(), acc.data_ptr(),
                work.data_ptr() if work is not None else None,
                G, E, C, D, F, splits, build.stream(dev))
    build.check(rc, name)
    launches += 1
    per_token_launches += per_token
    acc_launches += 1
    return acc


def quant_expert_gemm(xe: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor,
                      xs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xe (G, E, C, D) or (E, C, D) float32 against w_q (E, D, F) int8 with
    w_scale broadcastable to (E, 1, F); xs a scalar, (E,) or (E, 1, 1)
    static scale, or None for per-token scales (the ``dynamic_quant``
    kernel over all G * E * C rows at once). Returns float32
    (..., E, C, F)."""
    global launches, per_token_launches
    if xe.device.type == "cpu":
        return quant_expert_gemm_plain(xe, w_q, w_scale, xs)
    if xe.device.type != "cuda":
        raise ValueError(f"quant_expert_gemm: no kernel for device "
                         f"{xe.device}")
    name = "quant_expert_gemm"
    if xe.ndim not in (3, 4) or w_q.ndim != 3:
        raise ValueError(f"{name}: xe {tuple(xe.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not form (G, E, C, D) @ "
                         f"(E, D, F)")
    E, D, F = w_q.shape
    if tuple(xe.shape[-3:-2]) != (E,) or xe.shape[-1] != D:
        raise ValueError(f"{name}: xe {tuple(xe.shape)} does not route "
                         f"into the stack {tuple(w_q.shape)}")
    dev = xe.device
    build.operand(name, "xe", xe, torch.float32, dev)
    build.operand(name, "w_q", w_q, torch.int8, dev)
    if not isinstance(w_scale, torch.Tensor) or w_scale.device != dev:
        raise ValueError(f"{name}: w_scale must be a tensor on {dev}")
    ws = _weight_scales(w_scale, E, F).contiguous()
    lead = xe.shape[:-3]
    C = xe.shape[-2]
    G = xe.numel() // (E * C * D) if xe.numel() else 0
    if xs is not None:
        if isinstance(xs, torch.Tensor) and xs.device != dev:
            raise ValueError(f"{name}: xs is on {xs.device}, the kernel "
                             f"runs on {dev}")
        x_scale = _expert_scales(xs, E, dev).contiguous()
        codes = quantize(xe, x_scale.reshape(E, 1, 1))
    else:
        codes, x_scale = dynamic_quant(xe.reshape(-1, D))
    out = torch.empty(lead + (E, C, F), dtype=torch.float32, device=dev)
    splits = quant_linear_splits(G * C, F, D, E)
    work = (torch.zeros(quant_linear_workspace(G * C, F, D, E),
                        dtype=torch.int32, device=dev) if splits > 1 else None)
    P, I = build.P, build.I
    fn = build.function("samp_quant_expert_gemm",
                        (P, P, P, P, I, P, P, I, I, I, I, I, I, P))
    with torch.cuda.device(dev):
        rc = fn(codes.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
                x_scale.data_ptr(), int(xs is None), out.data_ptr(),
                work.data_ptr() if work is not None else None,
                G, E, C, D, F, splits, build.stream(dev))
    build.check(rc, name)
    launches += 1
    per_token_launches += xs is None
    return out
