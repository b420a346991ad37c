"""Per-layer mixed-precision policy lattice — the paper's §3.2 (port of
``repro.core.precision``).

SAMP divides each Transformer layer's GEMMs into the MHA group and the FFN
group, yielding three per-layer modes (paper Figure 2):

* ``FLOAT``           — no quantization
* ``QUANT_FFN_ONLY``  — FFN GEMMs int8, MHA stays float (paper's preferred)
* ``FULLY_QUANT``     — MHA and FFN GEMMs both int8
"""
from __future__ import annotations

import dataclasses
import enum


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

    @staticmethod
    def full_float(num_layers: int,
                   float_dtype: str = "bfloat16") -> "EncoderPolicy":
        return EncoderPolicy((LayerMode.FLOAT,) * num_layers, float_dtype)

    def group_boundaries(self) -> list[tuple[int, int, LayerMode]]:
        """Contiguous runs of identical modes: [(start, stop, mode), ...]."""
        runs: list[tuple[int, int, LayerMode]] = []
        start = 0
        for i in range(1, self.num_layers + 1):
            if i == self.num_layers or self.modes[i] != self.modes[start]:
                runs.append((start, i, self.modes[start]))
                start = i
        return runs
