"""Per-token dynamic int8 quantization (port of
``repro.kernels.dynamic_quant``).

:func:`dynamic_quant` launches the CUDA kernel in ``csrc/dynamic_quant.cu``
for a CUDA tensor and runs :func:`dynamic_quant_plain`, the same contract in
plain PyTorch, for a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import divide
from repro_torch.kernels import build

EPS = 1e-8

#: kernel launches since the last :func:`repro_torch.kernels.reset_launches`
launches = 0


def dynamic_quant_plain(x: torch.Tensor, row_amax=None):
    """x: (M, D) float -> (q (M, D) int8, scale (M, 1) float32).
    ``row_amax`` (M,) takes the place of the rows' own amax."""
    xf = x.to(torch.float32)
    amax = (torch.amax(xf.abs(), dim=-1, keepdim=True) if row_amax is None
            else row_amax.to(torch.float32).reshape(-1, 1))
    scale = divide(torch.clamp(amax, min=EPS), 127.0)
    q = torch.clamp(torch.round(xf / scale), -128, 127).to(torch.int8)
    return q, scale


def dynamic_quant(x: torch.Tensor, row_amax=None):
    """x: (M, D) float32 -> (q (M, D) int8, scale (M, 1) float32).

    ``row_amax`` (M,) float32, the scale-in mode: each row's amax over the
    whole row where ``x`` holds one rank's columns of it (the input of a
    row-parallel GEMM on a tensor-parallel mesh), so the codes and scales
    are the unsharded row's."""
    global launches
    if x.device.type == "cpu":
        return dynamic_quant_plain(x, row_amax)
    if x.device.type != "cuda":
        raise ValueError(f"dynamic_quant: no kernel for device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"dynamic_quant: x must be (M, D), got "
                         f"{tuple(x.shape)}")
    dev = x.device
    build.operand("dynamic_quant", "x", x, torch.float32, dev)
    M, D = x.shape
    if row_amax is not None:
        row_amax = build.operand("dynamic_quant", "row_amax", row_amax,
                                 torch.float32, dev)
        if row_amax.numel() != M:
            raise ValueError(f"dynamic_quant: row_amax has "
                             f"{row_amax.numel()} values for M={M}")
    q = torch.empty((M, D), dtype=torch.int8, device=dev)
    scale = torch.empty((M, 1), dtype=torch.float32, device=dev)
    fn = build.function("samp_dynamic_quant",
                        (build.P, build.P, build.P, build.P, build.I,
                         build.I, build.P))
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                None if row_amax is None else row_amax.data_ptr(), M, D,
                build.stream(dev))
    build.check(rc, "dynamic_quant")
    launches += 1
    return q, scale
