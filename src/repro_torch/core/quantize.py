"""Symmetric INT8 quantization primitives (port of ``repro.core.quantize``).

    q = clip(round(x / scale), -128, 127)        (paper Appendix B)
    x_hat = q * scale

Rounding is half to even (``torch.round``, as ``jnp.round``), and a value is
divided by its scale, never multiplied by the reciprocal: both choices move
int8 codes at rounding ties, so they follow the JAX package exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

INT8_MIN = -128
INT8_MAX = 127
UINT8_MAX = 255
# Smallest representable scale; guards div-by-zero on all-zero tensors.
EPS = 1e-8
# the largest |code| of each integer dtype int_matmul takes
_CODE_MAX = {torch.int8: 128, torch.uint8: UINT8_MAX}


@dataclasses.dataclass
class QuantizedTensor:
    """An int8 tensor plus the metadata needed to dequantize it.

    ``scale`` broadcasts against ``values`` (shape () for per-tensor,
    (..., 1) / (1, n) for per-axis). ``zero_point`` is None for symmetric
    quantization and an int32 0-d tensor for the unsigned variant.
    """

    values: torch.Tensor
    scale: torch.Tensor
    zero_point: Optional[torch.Tensor] = None

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        v = self.values.to(torch.int32)
        if self.zero_point is not None:
            v = v - self.zero_point
        return v.to(dtype) * self.scale.to(dtype)

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype


def divide(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device. PyTorch's CUDA kernel
    turns a division by a Python scalar into a multiply by its reciprocal,
    which can move the quotient by one ulp and an int8 code at a rounding
    tie; dividing by a device tensor keeps the true division the JAX
    package and the CUDA kernels compute."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _f32(t: Union[float, torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32)
    return torch.tensor(t, dtype=torch.float32, device=like.device)


def compute_scale_symmetric(amax: torch.Tensor) -> torch.Tensor:
    """scale such that +amax maps to +127 (symmetric signed int8)."""
    return divide(torch.clamp(amax.to(torch.float32), min=EPS),
                  float(INT8_MAX))


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization, round half to even."""
    q = torch.round(x.to(torch.float32) / _f32(scale, x))
    return torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * _f32(scale, q).to(dtype)


def quantize_per_tensor(x: torch.Tensor,
                        amax: Optional[torch.Tensor] = None
                        ) -> QuantizedTensor:
    """Per-tensor symmetric quantization; ``amax`` None = max|x|."""
    if amax is None:
        amax = x.abs().max()
    scale = compute_scale_symmetric(_f32(amax, x))
    return QuantizedTensor(quantize(x, scale), scale, None)


def quantize_per_channel(x: torch.Tensor, axis: int = -1,
                         amax: Optional[torch.Tensor] = None
                         ) -> QuantizedTensor:
    """Per-channel symmetric quantization along ``axis``."""
    axis = axis % x.ndim
    if amax is None:
        reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
        amax = torch.amax(x.abs(), dim=reduce_axes, keepdim=True)
    scale = compute_scale_symmetric(_f32(amax, x))
    return QuantizedTensor(quantize(x, scale), scale, None)


def quantize_per_token(x: torch.Tensor) -> QuantizedTensor:
    """Per-row dynamic quantization: one scale per row of the last axis."""
    amax = torch.amax(x.abs(), dim=-1, keepdim=True)
    scale = compute_scale_symmetric(amax)
    return QuantizedTensor(quantize(x, scale), scale, None)


def quantize_unsigned(x: torch.Tensor,
                      amax: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Asymmetric unsigned-range quantization for [0, amax] tensors (softmax
    outputs): [0, amax] -> [-128, 127] with zero point -128."""
    if amax is None:
        amax = x.max()
    scale = divide(torch.clamp(_f32(amax, x), min=EPS), float(UINT8_MAX))
    q = torch.round(x.to(torch.float32) / scale) + INT8_MIN
    q = torch.clamp(q, INT8_MIN, INT8_MAX).to(torch.int8)
    return QuantizedTensor(q, scale, torch.tensor(INT8_MIN, dtype=torch.int32,
                                                  device=x.device))


def exact_float_k(a_dtype: torch.dtype, b_dtype: torch.dtype) -> int:
    """Terms of a dot product of integer codes that a float32 sum holds
    exactly in any order: floor(2**24 / (max|a| * max|b|)), so every
    partial sum is an integer of at most 2**24 (1024 for int8 x int8, 514
    for uint8 x int8)."""
    for dt in (a_dtype, b_dtype):
        if dt not in _CODE_MAX:
            raise TypeError(f"int_matmul takes int8 or uint8 codes, got {dt}")
    return 2 ** 24 // (_CODE_MAX[a_dtype] * _CODE_MAX[b_dtype])


def float_chunk_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of integer codes through float32 matmuls over
    K-chunks of :func:`exact_float_k` terms, each chunk's integer result
    summed in int32: the route :func:`int_matmul` takes on CUDA, where
    PyTorch has no integer matmul (TF32 is off on the serving path). Runs
    on any device."""
    step = exact_float_k(a.dtype, b.dtype)
    K = a.shape[-1]
    acc = None
    for k0 in range(0, K, step):
        part = torch.matmul(a[..., k0:k0 + step].to(torch.float32),
                            b[..., k0:k0 + step, :].to(torch.float32))
        part = part.to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 (or uint8) codes: (..., M, K) @
    (..., K, N), an int32 matmul on the CPU and
    :func:`float_chunk_matmul` on CUDA."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return float_chunk_matmul(a, b)


def int8_matmul(x_q: QuantizedTensor, w_q: QuantizedTensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """W8A8 matmul with int32 accumulation and dequantization.
    x_q: (..., K) per-tensor or per-token scales; w_q: (K, N) with
    per-channel scales shaped (1, N) or per-tensor."""
    acc = int_matmul(x_q.values, w_q.values)
    if x_q.zero_point is not None:
        # (q_x - z_x) @ q_w: weights are symmetric
        acc = acc - x_q.zero_point * w_q.values.to(torch.int32).sum(dim=0)
    return dequantize_acc(acc, x_q.scale, w_q, out_dtype)


def dequantize_acc(acc: torch.Tensor, x_scale: torch.Tensor,
                   w_q: QuantizedTensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An int32 accumulator of :func:`int8_matmul` dequantized as it does:
    acc * (x_scale * w_scale), the weight's scale over the last axis."""
    scale = x_scale * w_q.scale.reshape((1,) * (acc.ndim - 1) + (-1,))
    return (acc.to(torch.float32) * scale).to(out_dtype)
