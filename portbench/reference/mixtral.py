"""Plain PyTorch reference of a Mixtral decoder under a mixed-precision plan.

From the float weights and calibration batches that the benchmark made,
it works out the activation statistics of the float model
(:func:`calibrate`), the plan's int8 weights and static scales
(:func:`prepare`), and the logits at every position of one sequence in a
single causal pass (:func:`logits`): what a served request's tokens are
judged against. It imports nothing of the program under test.

The model is the program's Mixtral: token embeddings, pre-norm layers with
RMSNorm (eps 1e-6, the program's), rotary positions (split halves, theta
from the configuration), grouped-query attention under a sliding window
(which no sequence here reaches), and a top-k mixture of GLU (SiLU)
experts whose float32 router picks each token's k experts by a stable
descending sort and weighs them by a softmax over the k logits; every
routing is kept (the configuration is dropless, as Mixtral is published).
Then a final RMSNorm and an untied head. Under the plan a block is float,
int8 at a static per-tensor scale (per expert for the expert stacks), or
int8 at per-token scales; an int8 qkv block runs the attention's two
matmuls in int8 with unsigned softmax codes; ``norm='int8'`` hands the
attention output across at the attention delta's scale.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import quant as Q
from portbench.reference.bert import matmul_precision

EPS_NORM = 1e-6


def rms_norm(x: torch.Tensor, p: dict) -> torch.Tensor:
    var = torch.square(x).mean(dim=-1, keepdim=True)
    return x / torch.sqrt(var + EPS_NORM) * p["scale"]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, d) at positions 0..S-1, split-half convention."""
    S, _, d = x.shape
    half = d // 2
    inv = 1.0 / torch.pow(theta, torch.arange(half, dtype=torch.float32,
                                              device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _route(h: torch.Tensor, router_w: torch.Tensor, k: int):
    """(experts (T, k), gates (T, k)) by a stable descending sort."""
    logits = torch.matmul(h, router_w)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return idx[:, :k], torch.softmax(vals[:, :k], dim=-1)


def _mask(S: int, window: int, device) -> torch.Tensor:
    q = torch.arange(S, device=device)[:, None]
    kk = torch.arange(S, device=device)[None]
    return (kk <= q) & (kk > q - window)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def calibrate(params: dict, cfg: dict, plan: list[dict],
              batches: list[dict]) -> dict:
    """{layer: {site: amax}} of the float model (min-max, the plan's only
    calibrator here); ``expert_in`` and ``expert_hidden`` are per expert,
    over the tokens routed to each."""
    if any(Q.quantized(s) and s["calibrator"] != "minmax"
           for lp in plan for s in (lp[b] for b in Q.BLOCKS)):
        raise NotImplementedError("histogram calibrators on a decoder")
    H, Hkv, d = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    E, K = cfg["moe"]["num_experts"], cfg["moe"]["top_k"]
    out: dict = {}

    def obs(i, site, a):
        a = a.float()
        cur = out.setdefault(i, {}).get(site)
        out[i][site] = a if cur is None else torch.maximum(cur, a)

    with torch.inference_mode(), matmul_precision(False):
        for b in batches:
            for row in b["tokens"]:
                x = params["embed"]["tok"][row.long()]
                S = x.shape[0]
                mask = _mask(S, cfg["sliding_window"], x.device)
                for i, lp in enumerate(params["layers"]):
                    h = rms_norm(x, lp["norm1"])
                    obs(i, "attn_in", h.abs().max())
                    a = lp["attn"]
                    q = rope((h @ a["wq"]["w"]).reshape(S, H, d),
                             cfg["rope_theta"]).transpose(0, 1)
                    k = rope((h @ a["wk"]["w"]).reshape(S, Hkv, d),
                             cfg["rope_theta"]).transpose(0, 1)
                    v = (h @ a["wv"]["w"]).reshape(S, Hkv, d).transpose(0, 1)
                    qs = q * (1.0 / math.sqrt(d))
                    obs(i, "q", qs.abs().max())
                    obs(i, "k", k.abs().max())
                    obs(i, "v", v.abs().max())
                    g = H // Hkv
                    kr, vr = (t.repeat_interleave(g, dim=0) for t in (k, v))
                    s = torch.matmul(qs, kr.transpose(-1, -2))
                    p = torch.softmax(s.masked_fill(~mask, -math.inf), -1)
                    obs(i, "p", p.max())
                    o = torch.matmul(p, vr).transpose(0, 1).reshape(S, H * d)
                    obs(i, "attn_out", o.abs().max())
                    delta = o @ a["wo"]["w"]
                    obs(i, "attn_delta", delta.abs().max())
                    x = x + delta
                    h2 = rms_norm(x, lp["norm2"])
                    f = lp["ffn"]
                    experts, gates = _route(h2, f["router"]["w"], K)
                    y = torch.zeros_like(x)
                    ein = torch.zeros(E, device=x.device)
                    ehid = torch.zeros(E, device=x.device)
                    for e in range(E):
                        tok, slot = torch.nonzero(experts == e, as_tuple=True)
                        if len(tok) == 0:
                            continue
                        xe = h2[tok]
                        hid = (F.silu(xe @ f["wg"]["w"][e])
                               * (xe @ f["wu"]["w"][e]))
                        ein[e] = xe.abs().max()
                        ehid[e] = hid.abs().max()
                        y.index_add_(0, tok, (hid @ f["wd"]["w"][e])
                                     * gates[tok, slot, None])
                    obs(i, "expert_in", ein)
                    obs(i, "expert_hidden", ehid)
                    x = x + y
    return {i: {s: (v.cpu().numpy() if v.ndim else float(v))
                for s, v in sites.items()} for i, sites in out.items()}


# ---------------------------------------------------------------------------
# the quantized model
# ---------------------------------------------------------------------------


def _stack(w: torch.Tensor, spec: dict, amax, bits: int) -> dict:
    """An expert stack (E, D, F): float, or codes with per-expert
    per-column scales (E, 1, F) and static per-expert scales (E, 1, 1)
    where the activations are static."""
    if not Q.quantized(spec):
        return {"w": w}
    s = Q.scale_of(w.abs().amax(dim=1, keepdim=True).float().cpu(),
                   bits).to(w.device)
    out = {"wc": Q.codes(w, s, bits).to(torch.int8), "ws": s, "bits": bits}
    if Q.static(spec):
        out["xs"] = Q.scale_of(np.asarray(amax, np.float32),
                               bits).to(w.device).reshape(-1, 1, 1)
    elif spec["act"] != "int8_per_token":
        raise ValueError(f"unknown activation scheme {spec['act']!r}")
    return out


def prepare(params: dict, cfg: dict, plan: list[dict], amax: dict, *,
            bits: int = 8) -> dict:
    from portbench.reference.bert import _linear
    layers = []
    for i, lp in enumerate(params["layers"]):
        spec, a = plan[i], amax.get(i, {})
        span = spec["norm"] == "int8"
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
        ex = spec.get("experts", spec["ffn_in"])
        f = lp["ffn"]
        ffn = {"router": f["router"]["w"],
               "wg": _stack(f["wg"]["w"], ex, a.get("expert_in"), bits),
               "wu": _stack(f["wu"]["w"], ex, a.get("expert_in"), bits),
               "wd": _stack(f["wd"]["w"], ex, a.get("expert_hidden"), bits)}
        layers.append({"norm1": lp["norm1"], "norm2": lp["norm2"],
                       "attn": attn, "qbmm": qbmm, "ffn": ffn})
    return {"embed": params["embed"], "layers": layers,
            "final_norm": params["final_norm"], "lm_head": params["lm_head"],
            "bits": bits, "cfg": cfg}


def _expert(x: torch.Tensor, st: dict, e: int) -> torch.Tensor:
    if "wc" not in st:
        return x @ st["w"][e]
    bits = st["bits"]
    if "xs" in st:
        xs = st["xs"][e, 0, 0]
        xc = Q.codes(x, xs, bits)
    else:
        xc, xs = Q.per_token(x, bits)
    acc = Q.int_gemm(xc, st["wc"][e].double()).float()
    return acc * (xs * st["ws"][e])


def hidden(model: dict, tokens: torch.Tensor) -> torch.Tensor:
    from portbench.reference.bert import _attention, dense
    cfg = model["cfg"]
    H, Hkv, d = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    E, K = cfg["moe"]["num_experts"], cfg["moe"]["top_k"]
    x = model["embed"]["tok"][tokens.long()]
    S = x.shape[0]
    mask = _mask(S, cfg["sliding_window"], x.device)
    for lp in model["layers"]:
        h = rms_norm(x, lp["norm1"])
        a = lp["attn"]
        q = rope(dense(h, a["wq"]).reshape(S, H, d), cfg["rope_theta"])
        k = rope(dense(h, a["wk"]).reshape(S, Hkv, d), cfg["rope_theta"])
        v = dense(h, a["wv"]).reshape(S, Hkv, d)
        g = H // Hkv
        q, k, v = (t.transpose(0, 1) for t in (q, k, v))
        k, v = k.repeat_interleave(g, dim=0), v.repeat_interleave(g, dim=0)
        o = _attention(q, k, v, lp["qbmm"], model["bits"], d, mask=mask)
        x = x + dense(o.transpose(0, 1).reshape(S, H * d), a["wo"])
        h2 = rms_norm(x, lp["norm2"])
        f = lp["ffn"]
        experts, gates = _route(h2, f["router"], K)
        y = torch.zeros_like(x)
        for e in range(E):
            tok, slot = torch.nonzero(experts == e, as_tuple=True)
            if len(tok) == 0:
                continue
            xe = h2[tok]
            hid = F.silu(_expert(xe, f["wg"], e)) * _expert(xe, f["wu"], e)
            y.index_add_(0, tok, _expert(hid, f["wd"], e)
                         * gates[tok, slot, None])
        x = x + y
    return rms_norm(x, model["final_norm"])


def logits(model: dict, tokens, *, tf32: bool = False) -> torch.Tensor:
    """Logits (S, V) at every position of one sequence (tokens (S,))."""
    dev = model["final_norm"]["scale"].device
    t = torch.as_tensor(np.asarray(tokens), device=dev)
    with torch.inference_mode(), matmul_precision(tf32):
        return torch.matmul(hidden(model, t), model["lm_head"]["w"])
