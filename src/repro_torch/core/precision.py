"""Per-layer mixed-precision policy lattice — the paper's §3.2 (port of
``repro.core.precision``).

SAMP divides each Transformer layer's GEMMs into the MHA group and the FFN
group, yielding three per-layer modes (paper Figure 2):

* ``FLOAT``           — no quantization
* ``QUANT_FFN_ONLY``  — FFN GEMMs int8, MHA stays float (paper's preferred)
* ``FULLY_QUANT``     — MHA and FFN GEMMs both int8

An :class:`EncoderPolicy` assigns one mode per layer. The paper's search
space is "quantize the first k layers in mode m" (prefix policies); the
beyond-paper extension allows arbitrary subsets.
"""
from __future__ import annotations

import dataclasses
import enum
import re
from typing import Sequence


class LayerMode(enum.Enum):
    FLOAT = "float"
    QUANT_FFN_ONLY = "quant_ffn_only"
    FULLY_QUANT = "fully_quant"

    @property
    def quant_ffn(self) -> bool:
        return self is not LayerMode.FLOAT

    @property
    def quant_mha(self) -> bool:
        return self is LayerMode.FULLY_QUANT


@dataclasses.dataclass(frozen=True)
class EncoderPolicy:
    """Precision mode for each of the N layers, plus the float dtype used by
    unquantized GEMMs."""

    modes: tuple[LayerMode, ...]
    float_dtype: str = "bfloat16"

    @property
    def num_layers(self) -> int:
        return len(self.modes)

    @property
    def num_quant_ffn(self) -> int:
        return sum(m.quant_ffn for m in self.modes)

    @property
    def num_quant_mha(self) -> int:
        return sum(m.quant_mha for m in self.modes)

    def describe(self) -> str:
        return (f"MHA {self.num_quant_mha}/{self.num_layers} "
                f"FFN {self.num_quant_ffn}/{self.num_layers} "
                f"[{self.float_dtype}]")

    @staticmethod
    def full_float(num_layers: int,
                   float_dtype: str = "bfloat16") -> "EncoderPolicy":
        return EncoderPolicy((LayerMode.FLOAT,) * num_layers, float_dtype)

    @staticmethod
    def prefix(num_layers: int, k: int, mode: LayerMode,
               float_dtype: str = "bfloat16") -> "EncoderPolicy":
        """Quantize the first k layers in ``mode`` (the paper's grid)."""
        if not 0 <= k <= num_layers:
            raise ValueError(f"k={k} out of range for {num_layers} layers")
        modes = (mode,) * k + (LayerMode.FLOAT,) * (num_layers - k)
        return EncoderPolicy(modes, float_dtype)

    @staticmethod
    def subset(num_layers: int, layers: Sequence[int], mode: LayerMode,
               float_dtype: str = "bfloat16") -> "EncoderPolicy":
        """Quantize an arbitrary subset (beyond-paper extension)."""
        layer_set = set(layers)
        bad = layer_set - set(range(num_layers))
        if bad:
            raise ValueError(f"layer indices {sorted(bad)} out of range")
        modes = tuple(mode if i in layer_set else LayerMode.FLOAT
                      for i in range(num_layers))
        return EncoderPolicy(modes, float_dtype)

    def group_boundaries(self) -> list[tuple[int, int, LayerMode]]:
        """Contiguous runs of identical modes: [(start, stop, mode), ...]."""
        runs: list[tuple[int, int, LayerMode]] = []
        start = 0
        for i in range(1, self.num_layers + 1):
            if i == self.num_layers or self.modes[i] != self.modes[start]:
                runs.append((start, i, self.modes[start]))
                start = i
        return runs


def make_policy(cfg, name: str,
                float_dtype: str = "bfloat16") -> EncoderPolicy:
    """Named policies: 'float' (the float baseline), 'ffn' (all layers
    QUANT_FFN_ONLY), 'full' (all FULLY_QUANT), 'ffnK'/'fullK' (first K)."""
    m = re.fullmatch(r"(float|ffn|full)(\d+)?", name)
    if not m:
        raise ValueError(f"bad policy name {name!r}")
    kind, k = m.group(1), m.group(2)
    n = cfg.num_layers
    if kind == "float":
        return EncoderPolicy.full_float(n, float_dtype)
    mode = (LayerMode.QUANT_FFN_ONLY if kind == "ffn"
            else LayerMode.FULLY_QUANT)
    return EncoderPolicy.prefix(n, int(k) if k else n, mode, float_dtype)


def paper_grid(num_layers: int, float_dtype: str = "bfloat16",
               stride: int = 1) -> list[tuple[str, int, EncoderPolicy]]:
    """The paper's full candidate grid: (mode_name, k, policy) for both modes
    and every k in 0..N in steps of ``stride``. k=0 in either mode is the
    all-float baseline, so the grid carries it exactly once."""
    grid: list[tuple[str, int, EncoderPolicy]] = [
        ("float", 0, EncoderPolicy.full_float(num_layers, float_dtype))]
    seen = {grid[0][2].modes}
    for mode, name in ((LayerMode.FULLY_QUANT, "fully_quant"),
                       (LayerMode.QUANT_FFN_ONLY, "quant_ffn_only")):
        for k in range(0, num_layers + 1, stride):
            policy = EncoderPolicy.prefix(num_layers, k, mode, float_dtype)
            if policy.modes in seen:
                continue
            seen.add(policy.modes)
            grid.append((name, k, policy))
    return grid
