"""The yardstick's arithmetic: the card's peaks and the operations and bytes
a call or a request needs, from shapes alone.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity, at the
700 W limit). A roofline share is the least time the card could take for
the work (the larger of operations over the peak of their precision and
bytes over HBM bandwidth, each input byte read once and each output byte
written once) over the time the kernels took. A model FLOP utilisation is
the least time of the real tokens' model operations, each at its own
precision's peak, over the wall time they were served in.
"""
from __future__ import annotations

import math

from portbench.reference import quant as Q

PEAK = {
    "int8": 1978.9e12,      # dense int8 tensor-core TOP/s
    "bf16": 989.4e12,
    "tf32": 494.7e12,
    "f32": 66.9e12,         # float32 outside the tensor cores (TF32 off)
}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    return max(ops / PEAK[precision], nbytes / HBM_BYTES_PER_S)


def gemm_bound_s(M: int, K: int, N: int, *, out_bytes: int = 4,
                 per_token: bool = False, bias: bool = False) -> float:
    """One int8 GEMM call: x (M, K) and w (K, N) int8 codes, the weight's
    per-column scales (and the rows' scales when per token, a bias) as
    float32, the output float32 (4) or requantized int8 (1)."""
    nbytes = (M * K + K * N + 4 * N + (4 * M if per_token else 0)
              + (4 * N if bias else 0) + out_bytes * M * N)
    return bound_s(2.0 * M * K * N, nbytes, "int8")


def _prec(spec: dict) -> str:
    return "int8" if Q.quantized(spec) else "f32"


def encoder_gemms(cfg: dict, plan: list[dict]) -> list[tuple]:
    """The int8 block GEMMs of one encoder forward, as (K, N, out_bytes,
    per_token, bias) per call, in layer order: ``quant_linear``'s calls."""
    D, F = cfg["d_model"], cfg["d_ff"]
    qd = cfg["num_heads"] * cfg["head_dim"]
    out = []
    for lp in plan:
        span = lp["norm"] == "int8"
        rows = [("qkv", D, qd, 4, False)] * 3 + [
            ("attn_out", qd, D, 1 if span else 4, False),
            ("ffn_in", D, F, 1 if span and Q.static(lp["ffn_out"]) else 4,
             True),
            ("ffn_out", F, D, 4, True)]
        for block, K, N, ob, bias in rows:
            if Q.quantized(lp[block]):
                out.append((K, N, ob, not Q.static(lp[block]), bias))
    return out


def quant_linear_bound_s(cfg: dict, plan: list[dict], M: int) -> float:
    """Least time of every ``quant_linear`` call of a forward over M rows
    (the padded batch: the rows the calls are given)."""
    return sum(gemm_bound_s(M, K, N, out_bytes=ob, per_token=pt, bias=b)
               for K, N, ob, pt, b in encoder_gemms(cfg, plan))


def encoder_request_bound_s(cfg: dict, plan: list[dict], n: int,
                            n_out: int) -> float:
    """Least time of the model operations one request of n real tokens
    needs: every GEMM of every layer and the attention's two matmuls over
    its own n keys, each at its block's precision, and the head."""
    D, F = cfg["d_model"], cfg["d_ff"]
    qd = cfg["num_heads"] * cfg["head_dim"]
    t = 0.0
    for lp in plan:
        t += 2.0 * n * D * qd * 3 / PEAK[_prec(lp["qkv"])]
        t += 2.0 * 2 * n * n * qd / PEAK[_prec(lp["qkv"])]
        t += 2.0 * n * qd * D / PEAK[_prec(lp["attn_out"])]
        t += 2.0 * n * D * F / PEAK[_prec(lp["ffn_in"])]
        t += 2.0 * n * F * D / PEAK[_prec(lp["ffn_out"])]
    return t + 2.0 * (D * D + D * n_out) / PEAK["f32"]


def expert_gemm_bound_s(E: int, C: int, K: int, N: int) -> float:
    """One ``quant_expert_gemm`` call over an (E, C, K) routed buffer of
    int8 codes against (E, K, N) int8 weights with (E, N) float32 scales,
    float32 out."""
    nbytes = E * C * K + E * K * N + 4 * E * N + 4 * E * C * N
    return bound_s(2.0 * E * C * K * N, nbytes, "int8")


def moe_expert_calls(cfg: dict, plan: list[dict], tokens: int) -> list:
    """The int8 expert GEMM calls of one step over ``tokens`` rows (every
    slot routes), as (E, C, K, N): three a layer whose stack is int8."""
    mo = cfg["moe"]
    E, Fe, D = mo["num_experts"], mo["d_ff_expert"], cfg["d_model"]
    C = max(1, math.ceil(mo["capacity_factor"] * tokens * mo["top_k"] / E))
    out = []
    for lp in plan:
        if Q.quantized(lp.get("experts", lp["ffn_in"])):
            out += [(E, C, D, Fe), (E, C, D, Fe), (E, C, Fe, D)]
    return out


def decoder_token_bound_s(cfg: dict, plan: list[dict], n: int) -> float:
    """Least time of the model operations one token at position n - 1 (n
    keys) needs: its projections, attention over n keys, the router, its
    top-k experts' GLU and the head, each at its block's precision."""
    D, V = cfg["d_model"], cfg["vocab_size"]
    qd = cfg["num_heads"] * cfg["head_dim"]
    kvd = cfg["num_kv_heads"] * cfg["head_dim"]
    mo = cfg["moe"]
    t = 0.0
    for lp in plan:
        t += 2.0 * D * (qd + 2 * kvd) / PEAK[_prec(lp["qkv"])]
        t += 4.0 * n * qd / PEAK[_prec(lp["qkv"])]
        t += 2.0 * qd * D / PEAK[_prec(lp["attn_out"])]
        t += 2.0 * D * mo["num_experts"] / PEAK["f32"]
        t += (mo["top_k"] * 3 * 2.0 * D * mo["d_ff_expert"]
              / PEAK[_prec(lp.get("experts", lp["ffn_in"]))])
    return t + 2.0 * D * V / PEAK["f32"]
