"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``. Asking for CUDA on a machine
without it is an error, never a silent move to the CPU: callers that want
the plain PyTorch versions pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels")
    return dev


def full_float32() -> None:
    """The JAX reference computes float32 matmuls in full float32. PyTorch
    may run them in TF32 on the card (cuDNN does by default), which keeps
    about three decimal digits and would also break the exact int8 products
    of :func:`repro_torch.core.quantize.int_matmul`; so serving turns TF32
    off and pins the float32 matmul precision to "highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
