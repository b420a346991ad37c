"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Each kernel module holds the wrapper (which launches the CUDA kernel for a
CUDA tensor and runs the plain version for a CPU tensor, and raises for
anything else), the plain version (``*_plain``) and a launch counter that
only the kernel launch increments (``flash_attention`` holds two kernels and
two counters, ``launches`` for the quantized one and ``float_launches`` for
the float one; ``expert_gemm`` also counts its launches with per-token
scales, ``per_token_launches``, and of its accumulator mode,
``acc_launches``). :func:`launch_counts` and
:func:`reset_launches` read and zero the counters, so a run can show that a
path went through the kernels. :mod:`repro_torch.kernels.ops` is the public
entry point to each.
"""
from __future__ import annotations

from repro_torch.kernels import (addnorm_quant, decode_attention,
                                 dynamic_quant, expert_gemm, flash_attention,
                                 fused_embed, quant_linear)

#: kernel name -> (module, name of its launch counter)
KERNEL_COUNTERS = {
    "quant_linear": (quant_linear, "launches"),
    "addnorm_quant": (addnorm_quant, "launches"),
    "dynamic_quant": (dynamic_quant, "launches"),
    "fused_embed": (fused_embed, "launches"),
    "quant_flash_attention": (flash_attention, "launches"),
    "decode_attention": (decode_attention, "launches"),
    "quant_expert_gemm": (expert_gemm, "launches"),
    "flash_attention": (flash_attention, "float_launches"),
}


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNEL_COUNTERS.items()}


def reset_launches() -> None:
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)
    expert_gemm.per_token_launches = 0
    expert_gemm.acc_launches = 0


from repro_torch.kernels import ops  # noqa: E402  (imports the modules above)
