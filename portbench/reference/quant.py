"""Plain symmetric quantization for the references, at 8 bits or fewer.

    q = clip(round(x / scale), -(qmax + 1), qmax),  scale = amax / qmax

with round half to even and a true division by the scale. ``bits`` is 8 for
the reference and 4 for its control, the next precision below. Integer
products run in float64, which holds every sum of int8 products these
widths make exactly. The plan's JSON is read here too, as plain dicts.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

EPS = 1e-8


def qmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def umax(bits: int) -> int:
    return 2 ** bits - 1


def scale_of(amax, bits: int, unsigned: bool = False) -> torch.Tensor:
    """amax -> a float32 scale, divided as a float32 division."""
    a = torch.clamp(torch.as_tensor(amax, dtype=torch.float32), min=EPS)
    # a divisor on the same device: a true division, never a multiply by
    # the reciprocal of a host scalar
    return a / torch.tensor(float(umax(bits) if unsigned else qmax(bits)),
                            dtype=torch.float32, device=a.device)


def codes(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Signed codes, as float64 (exact small integers)."""
    m = qmax(bits)
    q = torch.round(x.float() / scale.to(x.device))
    return torch.clamp(q, -m - 1, m).double()


def ucodes(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned codes in [0, 2**bits - 1] (softmax probabilities)."""
    q = torch.round(x.float() / scale.to(x.device))
    return torch.clamp(q, 0, umax(bits)).double()


def weight(w: torch.Tensor, scheme: str, bits: int):
    """(codes, scale) of a (K, N) weight: one scale a column
    (``int8_per_channel``) or one for the whole (``int8_per_tensor``)."""
    if scheme == "int8_per_channel":
        amax = w.abs().amax(dim=0, keepdim=True)
    elif scheme == "int8_per_tensor":
        amax = w.abs().amax().reshape(1, 1)
    else:
        raise ValueError(f"unknown weight scheme {scheme!r}")
    s = scale_of(amax.float().cpu(), bits).to(w.device)
    return codes(w, s, bits), s


def per_token(x: torch.Tensor, bits: int):
    """Dynamic per-row codes and scales over the last axis."""
    s = scale_of(x.abs().amax(dim=-1, keepdim=True), bits)
    return codes(x, s, bits), s


def int_gemm(xc: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """Exact product of integer codes (float64 in, float64 out)."""
    return torch.matmul(xc, wc)


def qdq(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    return (codes(x, scale, bits) * scale.double()).float()


BLOCKS = ("qkv", "attn_out", "ffn_in", "ffn_out")
FLOAT = {"weight": "float", "act": "float", "calibrator": "minmax"}


def load_plan(path) -> list[dict]:
    """The plan's layers as dicts with every block present (float where
    the file leaves one out) and the dataflow fields defaulted."""
    d = json.loads(Path(path).read_text())
    out = []
    for lp in d["layers"]:
        layer = {b: dict(lp.get(b, FLOAT)) for b in BLOCKS}
        for fam in ("experts", "router", "shared_ffn"):
            if fam in lp:
                layer[fam] = dict(lp[fam])
        layer["softmax"] = lp.get("softmax", "float")
        layer["norm"] = lp.get("norm", "float")
        layer["kv_cache"] = lp.get("kv_cache", "float")
        out.append(layer)
    return out


def quantized(spec: dict) -> bool:
    return spec["weight"] != "float"


def static(spec: dict) -> bool:
    return spec["act"] == "int8_per_tensor"
