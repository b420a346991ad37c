"""Plain PyTorch reference of the BERT encoder under a mixed-precision plan.

It takes the float weights and the calibration batches that the benchmark
made, and from them alone works out what the served model should answer:
the activation statistics of the float model (:func:`calibrate`), the
quantized weights and static scales the plan asks for (:func:`prepare`),
and the ``cls`` logits of one request (:func:`logits`). It imports nothing
of the program under test.

The model is the program's BERT: learned positions and segments, an
embedding layer norm, pre-LN layers (x + attn(LN(x)), then x + ffn(LN(x))),
a tanh-GELU FFN, a final layer norm and a CLS-pool classifier, layer-norm
eps 1e-6. Under the plan each GEMM block is float, int8 with a static
per-tensor activation scale, or int8 with per-token scales; a layer whose
qkv block is int8 runs the attention's two batched matmuls in int8, with
the softmax probabilities as unsigned codes (``softmax='uint8'``), and a
layer with ``norm='int8'`` hands the attention output and the FFN hidden
across in int8 (a quantize and dequantize at the consumer's scale).

``bits`` below 8 computes every integer quantity with that many bits (the
control); ``tf32`` lets float32 matmuls run in TF32.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import calibrators as C
from portbench.reference import quant as Q

EPS_NORM = 1e-6
HIST_SITES = ("attn_in", "attn_out", "attn_delta", "ffn_in", "ffn_hidden",
              "p")
# the plan block whose calibrator a site takes
SITE_BLOCK = {"attn_in": "qkv", "q": "qkv", "k": "qkv", "p": "qkv",
              "v": "qkv", "attn_out": "attn_out", "attn_delta": "attn_out",
              "ffn_in": "ffn_in", "ffn_hidden": "ffn_out"}


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 matmuls in full float32, or in TF32 for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def layer_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + EPS_NORM) * p["scale"] + p["bias"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def embed(params: dict, tokens: torch.Tensor,
          segments: torch.Tensor) -> torch.Tensor:
    e = params["embed"]
    S = tokens.shape[-1]
    x = (e["tok"][tokens.long()] + e["pos"][:S]
         + e["seg"][segments.long()])
    return layer_norm(x, e["emb_norm"])


def _float_dense(x, lin):
    y = torch.matmul(x, lin["w"])
    return y + lin["b"] if "b" in lin else y


# ---------------------------------------------------------------------------
# calibration: the float model with observers
# ---------------------------------------------------------------------------


def calibrate(params: dict, cfg: dict, plan: list[dict],
              batches: list[dict]) -> dict:
    """{layer index: {site: amax}} from the float model over ``batches``
    (dicts of (B, S) ``tokens`` and ``segments``), each site reduced by
    the calibrator its block names (min-max where the block is float)."""
    H, d = cfg["num_heads"], cfg["head_dim"]
    scalar: dict = {}
    hists: dict = {}

    def calibrator(i, site):
        spec = plan[i][SITE_BLOCK[site]]
        return spec["calibrator"] if Q.quantized(spec) else "minmax"

    def obs(i, site, x):
        name = calibrator(i, site)
        if site in HIST_SITES and name != "minmax":
            hists.setdefault((i, site), C.make_calibrator(name)).observe(x)
        else:
            a = float(x.abs().max())
            scalar[(i, site)] = max(scalar.get((i, site), 0.0), a)

    with torch.inference_mode(), matmul_precision(False):
        for b in batches:
            x = embed(params, b["tokens"], b["segments"])
            B, S, _ = x.shape
            for i, lp in enumerate(params["layers"]):
                h = layer_norm(x, lp["norm1"])
                obs(i, "attn_in", h)
                a = lp["attn"]
                q, k, v = (_float_dense(h, a[n]).reshape(B, S, H, d)
                           .transpose(1, 2) for n in ("wq", "wk", "wv"))
                qs = q * (1.0 / math.sqrt(d))
                obs(i, "q", qs)
                obs(i, "k", k)
                p = torch.softmax(torch.matmul(qs, k.transpose(-1, -2)), -1)
                obs(i, "p", p)
                obs(i, "v", v)
                o = torch.matmul(p, v).transpose(1, 2).reshape(B, S, H * d)
                obs(i, "attn_out", o)
                delta = _float_dense(o, a["wo"])
                obs(i, "attn_delta", delta)
                x = x + delta
                h2 = layer_norm(x, lp["norm2"])
                obs(i, "ffn_in", h2)
                hid = gelu(_float_dense(h2, lp["ffn"]["wi"]))
                obs(i, "ffn_hidden", hid)
                x = x + _float_dense(hid, lp["ffn"]["wo"])
    out: dict = {}
    for (i, site), a in scalar.items():
        out.setdefault(i, {})[site] = a
    for (i, site), cal in hists.items():
        out.setdefault(i, {})[site] = float(cal.compute_amax())
    return out


# ---------------------------------------------------------------------------
# the quantized model
# ---------------------------------------------------------------------------


def _linear(lin: dict, spec: dict, xs_amax, bits: int,
            out_amax=None) -> dict:
    """A served linear: float, or int8 codes with their scales."""
    out = {"b": lin.get("b")}
    if not Q.quantized(spec):
        out["w"] = lin["w"]
        return out
    wc, ws = Q.weight(lin["w"], spec["weight"], bits)
    out.update(wc=wc.to(torch.int8), ws=ws, bits=bits)
    if Q.static(spec):
        out["xs"] = Q.scale_of(xs_amax, bits).to(lin["w"].device)
    elif spec["act"] != "int8_per_token":
        raise ValueError(f"unknown activation scheme {spec['act']!r}")
    if out_amax is not None:
        out["out_xs"] = Q.scale_of(out_amax, bits).to(lin["w"].device)
    return out


def prepare(params: dict, cfg: dict, plan: list[dict], amax: dict, *,
            bits: int = 8) -> dict:
    """The plan applied to the float weights at ``amax``'s scales."""
    layers = []
    for i, lp in enumerate(params["layers"]):
        spec, a = plan[i], amax.get(i, {})
        span = spec["norm"] == "int8"
        if span and not (Q.static(spec["attn_out"])
                         and Q.static(spec["ffn_in"])):
            raise ValueError(f"layer {i}: norm='int8' needs static int8 "
                             f"attn_out and ffn_in")
        attn = {n: _linear(lp["attn"][n], spec["qkv"], a.get("attn_in"),
                           bits) for n in ("wq", "wk", "wv")}
        attn["wo"] = _linear(lp["attn"]["wo"], spec["attn_out"],
                             a.get("attn_out"), bits,
                             a["attn_delta"] if span else None)
        qbmm = None
        if Q.quantized(spec["qkv"]):
            if not Q.static(spec["qkv"]) or spec["softmax"] != "uint8":
                raise NotImplementedError(
                    "int8 attention matmuls are modelled with static scales "
                    "and the uint8 softmax only")
            dev = lp["attn"]["wq"]["w"].device
            qbmm = {s: Q.scale_of(a[s], bits).to(dev) for s in "qkv"}
            qbmm["p"] = Q.scale_of(a["p"], bits, unsigned=True).to(dev)
        wi_out = (a["ffn_hidden"] if span and Q.static(spec["ffn_out"])
                  else None)
        ffn = {"wi": _linear(lp["ffn"]["wi"], spec["ffn_in"], a.get("ffn_in"),
                             bits, wi_out),
               "wo": _linear(lp["ffn"]["wo"], spec["ffn_out"],
                             a.get("ffn_hidden"), bits)}
        layers.append({"norm1": lp["norm1"], "norm2": lp["norm2"],
                       "attn": attn, "qbmm": qbmm, "ffn": ffn})
    return {"embed": params["embed"], "layers": layers,
            "final_norm": params["final_norm"], "head": params["head"],
            "bits": bits, "cfg": cfg}


def dense(x: torch.Tensor, lin: dict, act=None) -> torch.Tensor:
    if "wc" in lin:
        bits = lin["bits"]
        if "xs" in lin:
            xc, xs = Q.codes(x, lin["xs"], bits), lin["xs"]
        else:
            xc, xs = Q.per_token(x, bits)
        acc = Q.int_gemm(xc, lin["wc"].double()).float()
        y = acc * (xs * lin["ws"])
    else:
        y = torch.matmul(x, lin["w"])
    if lin.get("b") is not None:
        y = y + lin["b"]
    if act is not None:
        y = act(y)
    if "out_xs" in lin:
        y = Q.qdq(y, lin["out_xs"], lin["bits"])
    return y


def _attention(q, k, v, qbmm, bits: int, d: int, mask=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (heads, S, d), in int8 with unsigned
    softmax codes where ``qbmm`` holds the static scales; ``mask`` (S, S)
    True where a query sees a key."""
    qs = q * (1.0 / math.sqrt(d))
    if qbmm is None:
        s = torch.matmul(qs, k.transpose(-1, -2))
    else:
        s = Q.int_gemm(Q.codes(qs, qbmm["q"], bits),
                       Q.codes(k, qbmm["k"], bits).transpose(-1, -2)).float()
        s = s * (qbmm["q"] * qbmm["k"])
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, -1)
    if qbmm is None:
        return torch.matmul(p, v)
    o = Q.int_gemm(Q.ucodes(p, qbmm["p"], bits),
                   Q.codes(v, qbmm["v"], bits)).float()
    return o * (qbmm["p"] * qbmm["v"])


def hidden(model: dict, tokens: torch.Tensor,
           segments: torch.Tensor) -> torch.Tensor:
    """Final-norm hidden states of one request, (S, d_model)."""
    cfg = model["cfg"]
    H, d = cfg["num_heads"], cfg["head_dim"]
    x = embed(model, tokens, segments)
    S = x.shape[0]
    for lp in model["layers"]:
        h = layer_norm(x, lp["norm1"])
        q, k, v = (dense(h, lp["attn"][n]).reshape(S, H, d).transpose(0, 1)
                   for n in ("wq", "wk", "wv"))
        o = _attention(q, k, v, lp["qbmm"], model["bits"], d)
        x = x + dense(o.transpose(0, 1).reshape(S, H * d), lp["attn"]["wo"])
        h2 = layer_norm(x, lp["norm2"])
        x = x + dense(dense(h2, lp["ffn"]["wi"], gelu), lp["ffn"]["wo"])
    return layer_norm(x, model["final_norm"])


def logits(model: dict, tokens, segments, *, tf32: bool = False
           ) -> torch.Tensor:
    """The ``cls`` logits of one request (tokens and segments (S,))."""
    dev = model["final_norm"]["scale"].device
    t = torch.as_tensor(np.asarray(tokens), device=dev)
    s = torch.as_tensor(np.asarray(segments), device=dev)
    with torch.inference_mode(), matmul_precision(tf32):
        h = hidden(model, t, s)
        pooled = torch.tanh(_float_dense(h[0], model["head"]["pool"]))
        return _float_dense(pooled, model["head"]["out"])
