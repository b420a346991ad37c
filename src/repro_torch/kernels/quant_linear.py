"""Fused W8A8 GEMM epilogue — the paper's "big kernel" (port of
``repro.kernels.quant_linear``).

:func:`quant_linear` launches the CUDA kernel in ``csrc/quant_linear.cu``
for CUDA tensors and runs :func:`quant_linear_plain`, the same contract in
plain PyTorch, for CPU tensors:

    y = act(int32(x_q @ w_q) * (x_scale * w_scale) + bias)

written as float32, or requantized to int8 at ``out_scale``. The activation
scale is an operand: a scalar (static per-tensor, the paper's calibrated
scheme) or one value per row (per-token scales from ``dynamic_quant``).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.quantize import int_matmul
from repro_torch.kernels import build

# float32 constants of the tanh-approximate GELU, as jax.nn.gelu computes it
_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2.0 / np.pi)))
_GELU_CUBIC = float(np.float32(0.044715))


def _gelu_tanh(y: torch.Tensor) -> torch.Tensor:
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                  * (y + _GELU_CUBIC * (y * y * y))))
    return y * cdf


def _silu(y: torch.Tensor) -> torch.Tensor:
    return y * (1.0 / (1.0 + torch.exp(-y)))


# The one activation table shared by the kernel wrapper, the plain version
# and the reference dense path (repro_torch.models.layers): fused-vs-
# reference parity needs a single definition. The CUDA epilogue implements
# the same functions under the codes of _ACT_CODE.
ACTIVATIONS = {
    None: lambda y: y,
    "silu": _silu,
    "gelu": _gelu_tanh,
    "relu": lambda y: torch.clamp(y, min=0.0),
}
_ACT_CODE = {None: 0, "silu": 1, "gelu": 2, "relu": 3}

#: kernel launches since the last :func:`repro_torch.kernels.reset_launches`
launches = 0

# csrc/int8_mma.cuh: rows up to which the split-K kernel streams w, its
# K stage and the SMs it fills
SMALL_M, _STAGE_K, _SMS = 32, 64, 132


def quant_linear_splits(M: int, N: int, K: int, E: int = 1) -> int:
    """Blocks over K the kernel takes for E stacked (M, K) @ (K, N)
    products (E experts of ``quant_expert_gemm``, 1 for ``quant_linear``):
    ``split_plan`` of ``csrc/int8_mma.cuh``. Only for M <= 32, where about
    two blocks an SM stream w; 1 above."""
    ktiles = -(-K // _STAGE_K)
    if M > SMALL_M or M <= 0 or N <= 0 or E <= 0 or ktiles <= 1:
        return 1
    want = -(-2 * _SMS // (-(-N // 64) * E))
    if want <= 1:
        return 1
    per = max(1, ktiles // want)
    return -(-ktiles // per)


def quant_linear_workspace(M: int, N: int, K: int, E: int = 1) -> int:
    """int32 values of the zeroed workspace a split product needs: for
    each of the E products its M x N partial sums, then one counter a
    64-column tile (0 when the kernel does not split)."""
    if quant_linear_splits(M, N, K, E) == 1:
        return 0
    return E * (M * N + -(-N // 64))


def _row_scales(x_scale, M: int, device) -> torch.Tensor:
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=device)
    return xs.reshape(1, 1) if xs.ndim == 0 else xs.reshape(M, 1)


def quant_linear_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor,
                       x_scale: Union[float, torch.Tensor], *,
                       bias: Optional[torch.Tensor] = None,
                       act: Optional[str] = None,
                       out_scale: Union[float, torch.Tensor, None] = None
                       ) -> torch.Tensor:
    """The plain-PyTorch contract of :func:`quant_linear`."""
    return quant_linear_epilogue(int_matmul(x_q, w_q), w_scale, x_scale,
                                 bias=bias, act=act, out_scale=out_scale)


def quant_linear_epilogue(acc: torch.Tensor, w_scale: torch.Tensor,
                          x_scale: Union[float, torch.Tensor], *,
                          bias: Optional[torch.Tensor] = None,
                          act: Optional[str] = None,
                          out_scale: Union[float, torch.Tensor, None] = None
                          ) -> torch.Tensor:
    """The kernel's epilogue on an int32 accumulator (M, N), in its order:
    acc * (x_scale * w_scale), + bias, the activation, the int8 requant at
    ``out_scale``. A tensor-parallel mesh runs it after summing the ranks'
    :func:`quant_linear_acc` accumulators."""
    M = acc.shape[0]
    xs = _row_scales(x_scale, M, acc.device)
    y = acc.to(torch.float32) * (xs * w_scale.to(torch.float32).reshape(1, -1))
    if bias is not None:
        y = y + bias.to(torch.float32).reshape(1, -1)
    y = ACTIVATIONS[act](y)
    if out_scale is not None:
        os_ = torch.as_tensor(out_scale, dtype=torch.float32,
                              device=acc.device)
        return torch.clamp(torch.round(y / os_), -128, 127).to(torch.int8)
    return y


def quant_linear_acc(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The accumulator mode of :func:`quant_linear`: x_q (M, K) int8 @ w_q
    (K, N) int8 as int32 (M, N), with no epilogue (the plain version's
    :func:`~repro_torch.core.quantize.int_matmul` on the CPU). Every
    integer sum is exact, so the ranks' partial accumulators of a K-split
    GEMM sum to the whole one's."""
    global launches
    if x_q.device.type == "cpu":
        return int_matmul(x_q, w_q)
    if x_q.device.type != "cuda":
        raise ValueError(f"quant_linear: no kernel for device {x_q.device}")
    name = "quant_linear"
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)} do not form (M,K) @ (K,N)")
    dev = x_q.device
    M, K = x_q.shape
    N = w_q.shape[1]
    build.operand(name, "x_q", x_q, torch.int8, dev)
    build.operand(name, "w_q", w_q, torch.int8, dev)
    acc = torch.empty((M, N), dtype=torch.int32, device=dev)
    splits = quant_linear_splits(M, N, K)
    work = (torch.zeros(quant_linear_workspace(M, N, K), dtype=torch.int32,
                        device=dev) if splits > 1 else None)
    P, I = build.P, build.I
    fn = build.function("samp_quant_linear_acc", (P, P, P, P, I, I, I, I, P))
    with torch.cuda.device(dev):
        rc = fn(x_q.data_ptr(), w_q.data_ptr(), acc.data_ptr(),
                work.data_ptr() if work is not None else None,
                M, N, K, splits, build.stream(dev))
    build.check(rc, name)
    launches += 1
    return acc


def quant_linear(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 x_scale: Union[float, torch.Tensor], *,
                 bias: Optional[torch.Tensor] = None,
                 act: Optional[str] = None,
                 out_scale: Union[float, torch.Tensor, None] = None
                 ) -> torch.Tensor:
    """x_q (M, K) int8 @ w_q (K, N) int8 with w_scale (N,) float32 and
    x_scale a scalar or (M,) / (M, 1) per-token scales; bias (N,); act one
    of :data:`ACTIVATIONS`. Returns (M, N) float32, or int8 when
    ``out_scale`` is given."""
    global launches
    if x_q.device.type == "cpu":
        return quant_linear_plain(x_q, w_q, w_scale, x_scale, bias=bias,
                                  act=act, out_scale=out_scale)
    if x_q.device.type != "cuda":
        raise ValueError(f"quant_linear: no kernel for device {x_q.device}")
    name = "quant_linear"
    if act not in _ACT_CODE:
        raise ValueError(f"{name}: unknown activation {act!r}")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(x_q.shape)} @ "
                         f"{tuple(w_q.shape)} do not form (M,K) @ (K,N)")
    dev = x_q.device
    M, K = x_q.shape
    N = w_q.shape[1]
    build.operand(name, "x_q", x_q, torch.int8, dev)
    build.operand(name, "w_q", w_q, torch.int8, dev)
    build.operand(name, "w_scale", w_scale, torch.float32, dev)
    if w_scale.numel() != N:
        raise ValueError(f"{name}: w_scale has {w_scale.numel()} values for "
                         f"N={N}")
    if isinstance(x_scale, torch.Tensor) and x_scale.ndim > 0:
        xs = build.operand(name, "x_scale", x_scale, torch.float32, dev)
        if xs.numel() != M:
            raise ValueError(f"{name}: x_scale has {xs.numel()} values for "
                             f"M={M}")
        xs_stride = 1
    else:
        xs, xs_stride = build.scalar(name, "x_scale", x_scale, dev), 0
    if bias is not None:
        build.operand(name, "bias", bias, torch.float32, dev)
        if bias.numel() != N:
            raise ValueError(f"{name}: bias has {bias.numel()} values for "
                             f"N={N}")
    requant = out_scale is not None
    os_ = build.scalar(name, "out_scale", out_scale, dev) if requant else None
    out = torch.empty((M, N), dtype=torch.int8 if requant else torch.float32,
                      device=dev)
    splits = quant_linear_splits(M, N, K)
    work = (torch.zeros(quant_linear_workspace(M, N, K), dtype=torch.int32,
                        device=dev) if splits > 1 else None)
    P, I = build.P, build.I
    fn = build.function("samp_quant_linear",
                        (P, P, P, P, I, P, P, P, P, P, I, I, I, I, I, P))
    with torch.cuda.device(dev):
        rc = fn(x_q.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                xs.data_ptr(), xs_stride,
                bias.data_ptr() if bias is not None else None,
                os_.data_ptr() if requant else None,
                None if requant else out.data_ptr(),
                out.data_ptr() if requant else None,
                work.data_ptr() if work is not None else None,
                M, N, K, _ACT_CODE[act], splits, build.stream(dev))
    build.check(rc, name)
    launches += 1
    return out
