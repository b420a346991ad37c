"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Each kernel module holds the wrapper (which launches the CUDA kernel for a
CUDA tensor and runs the plain version for a CPU tensor, and raises for
anything else), the plain version (``*_plain``) and a ``launches`` counter
that only the kernel launch increments (``expert_gemm`` also counts its
launches with per-token scales, ``per_token_launches``).
:func:`launch_counts` and :func:`reset_launches` read and zero the counters,
so a run can show that a path went through the kernels.
"""
from __future__ import annotations

from repro_torch.kernels import (addnorm_quant, decode_attention,
                                 dynamic_quant, expert_gemm, flash_attention,
                                 fused_embed, quant_linear)

KERNEL_MODULES = {
    "quant_linear": quant_linear,
    "addnorm_quant": addnorm_quant,
    "dynamic_quant": dynamic_quant,
    "fused_embed": fused_embed,
    "quant_flash_attention": flash_attention,
    "decode_attention": decode_attention,
    "quant_expert_gemm": expert_gemm,
}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launches() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
    expert_gemm.per_token_launches = 0
