"""Plan variants of the SAMP search (port of ``repro.core.samp``, so far
only :func:`int8_dataflow_variant`; the search strategies arrive with the
autotune slice)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.plan import PrecisionPlan


def int8_dataflow_variant(precision: PrecisionPlan
                          ) -> Optional[PrecisionPlan]:
    """The whole-layer int8-dataflow variant of a candidate (schema v3):
    ``softmax='uint8'`` on every layer whose attention bmms run int8, and
    ``norm='int8'`` wherever the attn_out/ffn_in blocks carry static int8
    activations — the maximal span the plan's GEMM choices support.
    Returns None when no layer is eligible (the variant would duplicate
    the base candidate)."""
    layers, changed = [], False
    for lp in precision.layers:
        sm = "uint8" if lp.qkv.quantized else None
        nm = ("int8" if all(lp.spec(b).quantized and lp.spec(b).static_acts
                            for b in ("attn_out", "ffn_in")) else None)
        nlp = lp.with_dataflow(softmax=sm, norm=nm)
        changed = changed or nlp != lp
        layers.append(nlp)
    if not changed:
        return None
    return dataclasses.replace(precision, layers=tuple(layers))
