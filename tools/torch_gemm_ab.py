#!/usr/bin/env python3
"""Time the PyTorch port's kernels, ``quant_linear``, ``quant_expert_gemm``,
``decode_attention``, the float ``flash_attention``,
``quant_flash_attention``, ``dynamic_quant``, ``addnorm_quant`` or
``fused_embed`` (``--kernel``), at
the shapes of ``chip_smoke.py``'s paths, for the port found under
``--src``, so that two checkouts are compared on one card within one call:

    python3 tools/torch_gemm_ab.py --src <checkout>/src --label parent
    python3 tools/torch_gemm_ab.py --src src --label change

Run it for each checkout in turns (parent, change, change, parent): two
calls may land on cards that differ. Each shape is timed as in
``chip_smoke.py`` (CUDA events, median of 25, L2 flushed: ``ms``, which
holds the wrapper's host time where the kernel is shorter) and by
``torch.profiler`` (``device_ms``: the device time of the kernel itself, a
mean over 10 calls, L2 flushed) on seeded operands; for ``quant_linear``
also ``library_ms`` and ``library_device_ms``, ``torch._int_mm`` plus the
epilogue as ``chip_smoke.py`` times it (its device time: every kernel it
runs), and ``int_mm_column_major_device_ms``, ``torch._int_mm`` alone on a
column-major copy of w. One JSON line per shape, then the sums over
one decode tick of
qwen2-0.5b (the decode paths), of the MoE path's attention GEMMs, and over
one forward of the main path's BERT at (8, 128), weighted by the launches
each plan makes; for the expert GEMM, over one tick of the MoE path
(capacity 3) and over the same nine GEMMs of a (4, 128) forward (capacity
160), with static per-expert scales; for ``decode_attention``, the decode
paths' call (8 slots, 2 KV heads, a group of 7, head dim 64, pages of 16,
lengths 8-96: per-token scale pages, and per-head scales with the uint8
softmax, 12 calls a tick) and one call at 4096 cached tokens a slot, with
``call_device_ms`` also counting the wrapper's other kernels (the zeroed
counters); for ``flash_attention``, each case of
``chip_smoke.FLASH_CASES`` (the qwen2 and mixtral 32k prefills and a BERT
bucket) on seeded inputs, 5 runs each; for ``quant_flash_attention``, the
span path's BERT buckets (1, 8) to (8, 128) with and without ``o_scale``, 8 x
12 x 512 x 64, and 2048 keys (past a resident block's shared memory), with
``tiled_device_ms`` at every shape but 2048 keys also from the long-key
kernel forced (it streams the key tiles three times), summed over a span
forward at (8, 128) (6 calls, all with ``o_scale``); for
``dynamic_quant``, the encoder's 1024 rows of 768 and 3072, qwen2
decode's 8 rows of 896 and 4864, and the MoE routed buffers' 24 rows of
6144 and 16384, summed over a main-path forward (3 + 3), a
decode tick (12 + 6) and a MoE tick (2 + 1); for ``addnorm_quant``, the
span path's 1024 rows of 768 with an int8 delta (6 a forward), the main
path's with float x (6 a forward), both LayerNorm, and a qwen2 decode
tick's 8 rows of 896 under RMSNorm (12 a tick); for ``fused_embed``,
BERT-base's 1024 rows of 768 at the (8, 128) bucket with segments (1 a
forward).
Needs one NVIDIA GPU; builds the checkout's kernels on first use.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (path, M, K, N, activation, per-token scales, launches per tick / forward)
SHAPES = [
    ("decode_path", 8, 896, 896, None, False, 24),
    ("decode_path", 8, 896, 128, None, False, 24),
    ("decode_path", 8, 896, 4864, "silu", False, 12),
    ("decode_path", 8, 896, 4864, None, False, 12),
    ("decode_path", 8, 4864, 896, None, False, 12),
    ("decode_path", 8, 896, 4864, "silu", True, 6),
    ("decode_path", 8, 896, 4864, None, True, 6),
    ("decode_path", 8, 4864, 896, None, True, 6),
    ("moe_decode_path", 8, 6144, 6144, None, False, 2),
    ("moe_decode_path", 8, 6144, 1024, None, False, 2),
    ("main_path", 1024, 768, 768, None, False, 24),
    ("main_path", 1024, 768, 3072, "gelu", False, 6),
    ("main_path", 1024, 3072, 768, None, False, 6),
    ("main_path", 1024, 768, 3072, "gelu", True, 3),
    ("main_path", 1024, 3072, 768, None, True, 3),
]

# (path, G, E, C, D, F, launches per tick / forward): mixtral-8x22b's stacks
EXPERT_SHAPES = [
    ("moe_decode_path", 1, 8, 3, 6144, 16384, 6),
    ("moe_decode_path", 1, 8, 3, 16384, 6144, 3),
    ("moe_forward", 1, 8, 160, 6144, 16384, 6),
    ("moe_forward", 1, 8, 160, 16384, 6144, 3),
]


def int_mm_ms(timer, x, w, ws, xs, act) -> tuple[float, float, float]:
    """(events ms, device ms) of ``torch._int_mm`` (x padded to 32 rows at
    M <= 16, as it needs) plus the epilogue in PyTorch ops: the library
    call ``chip_smoke.py`` sets beside the kernel; and the device ms of
    ``torch._int_mm`` alone on a column-major copy of w (made outside the
    timing), the layout its int8 GEMM wants and the port does not keep."""
    import torch
    import torch.nn.functional as Fn
    M, K = x.shape
    x_lib = x if M > 16 else torch.cat(
        [x, torch.zeros((32 - M, K), dtype=torch.int8, device=x.device)])

    def lib():
        y = torch._int_mm(x_lib, w)[:M].to(torch.float32) * (xs * ws)
        if act == "gelu":
            return Fn.gelu(y, approximate="tanh")
        return Fn.silu(y) if act == "silu" else y
    w_cols = w.t().contiguous().t()
    return (timer.ms(lib), timer.device_ms(lib),
            timer.device_ms(lambda: torch._int_mm(x_lib, w_cols)))


def time_expert_gemm(timer, dev, label, sums):
    import torch
    from repro_torch.kernels import expert_gemm as EG
    for path, G, E, C, D, F, n in EXPERT_SHAPES:
        g = torch.Generator(device=dev).manual_seed(C * D + F)
        xe = torch.randn((G, E, C, D), generator=g, device=dev)
        w = torch.randint(-128, 128, (E, D, F), generator=g, device=dev,
                          dtype=torch.int8)
        ws = torch.rand((E, 1, F), generator=g, device=dev) * 1e-3 + 1e-5
        xs = xe.abs().amax(dim=(0, 2, 3)).reshape(E, 1, 1) / 127.0
        call = lambda: EG.quant_expert_gemm(xe, w, ws, xs)  # noqa: E731
        ms = timer.ms(call)
        dev_ms = timer.device_ms(call, "quant_expert_gemm")
        sums[path] = sums.get(path, 0.0) + n * ms
        sums[path + ":device"] = sums.get(path + ":device", 0.0) + n * dev_ms
        print(json.dumps({"label": label, "path": path, "G": G, "E": E,
                          "C": C, "D": D, "F": F, "ms": ms,
                          "device_ms": dev_ms}), flush=True)


# (path, mode, lengths, pages per slot, calls per tick)
DECODE_SHAPES = [
    ("decode_path", "per_token", [8, 21, 33, 46, 58, 71, 83, 96], 8, 12),
    ("decode_head_path", "p_scale", [8, 21, 33, 46, 58, 71, 83, 96], 8, 12),
    ("long_context", "per_token", [4096] * 8, 256, 1),
]


def time_decode(timer, dev, label, sums):
    from chip_smoke import decode_operands
    from repro_torch.kernels import decode_attention as DA
    for path, mode, lengths, pps, n in DECODE_SHAPES:
        args = decode_operands(dev, lengths, pps, mode)
        call = lambda: DA.decode_attention(**args)  # noqa: E731
        ms = timer.ms(call)
        dev_ms = timer.device_ms(call, "decode_attention")
        call_dev = timer.device_ms(call)
        for key, v in ((path, ms), (path + ":device", dev_ms),
                       (path + ":call_device", call_dev)):
            sums[key] = sums.get(key, 0.0) + n * v
        print(json.dumps({"label": label, "path": path, "mode": mode,
                          "lengths": lengths, "pages_per_slot": pps,
                          "ms": ms, "device_ms": dev_ms,
                          "call_device_ms": call_dev}), flush=True)


def time_flash(dev, label, sums):
    import torch
    from chip_smoke import FLASH_CASES, Timer
    from repro_torch.kernels import ops
    timer = Timer(dev, reps=5, warmup=1)
    for name, (B, Hq, Hkv, S, d), kw, dt, _ in FLASH_CASES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(S + Hq + d)
        q = torch.randn((B, Hq, S, d), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((B, Hkv, S, d), generator=g, device=dev)
                .to(dtype) for _ in range(2))
        ms = timer.ms(lambda: ops.flash_attention(q, k, v, **kw))
        sums[name] = ms
        print(json.dumps({"label": label, "case": name, "B": B, "Hq": Hq,
                          "Hkv": Hkv, "S": S, "head_dim": d, "dtype": dt,
                          "mask": kw, "ms": ms,
                          "device_ms": timer.device_ms(
                              lambda: ops.flash_attention(q, k, v, **kw),
                              "flash_attention", reps=3)}), flush=True)
        del q, k, v
        torch.cuda.empty_cache()


# (case, B, H, S, o_scale, launches per span forward at (8, 128))
QFA_SHAPES = [
    ("bucket_1x8", 1, 12, 8, False, 0), ("bucket_1x8", 1, 12, 8, True, 0),
    ("bucket_4x16", 4, 12, 16, False, 0), ("bucket_4x16", 4, 12, 16, True, 0),
    ("bucket_4x32", 4, 12, 32, False, 0), ("bucket_4x32", 4, 12, 32, True, 0),
    ("bucket_4x64", 4, 12, 64, False, 0), ("bucket_4x64", 4, 12, 64, True, 0),
    ("span_path", 8, 12, 128, False, 0), ("span_path", 8, 12, 128, True, 6),
    ("bert_512", 8, 12, 512, False, 0), ("bert_512", 8, 12, 512, True, 0),
    ("keys_2048", 1, 12, 2048, True, 0),
]


def time_quant_attention(timer, dev, label, sums):
    """The quantized attention at BERT-base's shapes (12 heads of 64),
    seeded codes and key lengths as ``chip_smoke.py`` makes them."""
    import torch
    from chip_smoke import _codes
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    for case, B, H, S, requant, n in QFA_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(B * S)
        q, k, v = (_codes((B, H, S, 64), gen, dev) for _ in range(3))
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        idx = torch.arange(S, device=dev, dtype=torch.int32)
        k_pos = torch.where(idx[None] < lens[:, None], idx[None],
                            -1).to(torch.int32)
        kw = dict(q_scale=torch.tensor(0.35 / 64, device=dev),
                  k_scale=torch.tensor(0.013, device=dev),
                  p_scale=torch.tensor(0.6 / 255, device=dev),
                  v_scale=torch.tensor(0.02, device=dev))
        if requant:
            kw["o_scale"] = torch.tensor(0.01, device=dev)
        call = lambda: FA.quant_flash_attention(q, k, v, k_pos, **kw)  # noqa
        ms, dev_ms = timer.ms(call), timer.device_ms(call)
        rec = {"label": label, "case": case, "B": B, "H": H, "Sq": S,
               "Sk": S, "head_dim": 64, "o_scale": requant,
               "tiled": FA.quant_flash_attention_tiled(S, 64), "ms": ms,
               "device_ms": dev_ms}
        if not rec["tiled"]:
            # the same call with the key tiles streamed (the C entry point
            # of both checkouts takes the flag)
            fn = build.function("samp_quant_flash_attention",
                                (build.P,) * 11 + (build.I,) * 7
                                + (build.F, build.I, build.P))
            out = torch.empty(q.shape, device=dev, dtype=torch.int8
                              if requant else torch.float32)
            sc = [kw[f"{x}_scale"] for x in "qkpv"]
            os_ = kw.get("o_scale")

            def tiled():
                build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               k_pos.data_ptr(), *(t.data_ptr() for t in sc),
                               os_.data_ptr() if requant else None,
                               None if requant else out.data_ptr(),
                               out.data_ptr() if requant else None, B, H, H,
                               S, S, 64, 0, 0.0, 1, build.stream(dev)),
                            "samp_quant_flash_attention")
            rec["tiled_device_ms"] = timer.device_ms(tiled)
        for key, val in ((case, ms), (case + ":device", dev_ms),
                         (case + ":tiled_device",
                          rec.get("tiled_device_ms", dev_ms))):
            sums[key] = sums.get(key, 0.0) + val
        if n:
            for key, val in (("span_forward", ms),
                             ("span_forward:device", dev_ms),
                             ("span_forward:tiled_device",
                              rec["tiled_device_ms"])):
                sums[key] = sums.get(key, 0.0) + n * val
        print(json.dumps(rec), flush=True)


# (path, M, D, launches per forward / tick)
DQ_SHAPES = [("main_forward", 1024, 768, 3), ("main_forward", 1024, 3072, 3),
             ("decode_tick", 8, 896, 12), ("decode_tick", 8, 4864, 6),
             ("moe_tick", 24, 6144, 2), ("moe_tick", 24, 16384, 1)]


def time_dynamic_quant(timer, dev, label, sums):
    import torch
    from repro_torch.kernels import dynamic_quant as DQ
    for path, M, D, n in DQ_SHAPES:
        g = torch.Generator(device=dev).manual_seed(M * D)
        x = torch.randn((M, D), generator=g, device=dev) * 3
        call = lambda: DQ.dynamic_quant(x)  # noqa: E731
        ms, dev_ms = timer.ms(call), timer.device_ms(call, "dynamic_quant")
        for key, val in ((path, ms), (path + ":device", dev_ms)):
            sums[key] = sums.get(key, 0.0) + n * val
        print(json.dumps({"label": label, "path": path, "M": M, "D": D,
                          "ms": ms, "device_ms": dev_ms}), flush=True)


# (path, M, D, int8 delta, norm, launches per forward / tick)
AQ_SHAPES = [("span_forward", 1024, 768, True, "layernorm", 6),
             ("main_forward", 1024, 768, False, "layernorm", 6),
             ("decode_tick", 8, 896, False, "rmsnorm", 12)]


def time_addnorm(timer, dev, label, sums):
    import torch
    from repro_torch.kernels import addnorm_quant as AQ
    for path, M, D, int8_in, kind, n in AQ_SHAPES:
        g = torch.Generator(device=dev).manual_seed(M * D)
        if int8_in:
            x = torch.randint(-128, 128, (M, D), generator=g, device=dev,
                              dtype=torch.int8)
            x_in = torch.tensor(0.02, device=dev)
        else:
            x, x_in = torch.randn((M, D), generator=g, device=dev), None
        res = torch.randn((M, D), generator=g, device=dev) * 2.0
        bias = torch.zeros(D, device=dev)
        gamma = 1.0 + 0.1 * torch.randn(D, generator=g, device=dev)
        beta = (None if kind == "rmsnorm"
                else 0.1 * torch.randn(D, generator=g, device=dev))
        s = torch.tensor(0.025, device=dev)
        call = lambda: AQ.addnorm_quant(x, res, bias, gamma, beta, s,  # noqa
                                        x_in_scale=x_in, kind=kind)
        ms, dev_ms = timer.ms(call), timer.device_ms(call, "addnorm_quant")
        for key, val in ((path, ms), (path + ":device", dev_ms)):
            sums[key] = sums.get(key, 0.0) + n * val
        print(json.dumps({"label": label, "path": path, "M": M, "D": D,
                          "int8_delta": int8_in, "norm": kind, "ms": ms,
                          "device_ms": dev_ms}), flush=True)


def time_embed(timer, dev, label, sums):
    """BERT-base's tables (21128, 512 and 2 rows of 768) at the (8, 128)
    bucket: seeded token and segment ids, positions 0..127 a sequence."""
    import torch
    from repro_torch.kernels import fused_embed as FE
    B, S, D = 8, 128, 768
    g = torch.Generator(device=dev).manual_seed(B * S)
    tok, pos, seg = (torch.randn((n, D), generator=g, device=dev)
                     for n in (21128, 512, 2))
    ids = torch.randint(0, 21128, (B * S,), generator=g, device=dev,
                        dtype=torch.int32)
    segs = torch.randint(0, 2, (B * S,), generator=g, device=dev,
                         dtype=torch.int32)
    positions = torch.arange(B * S, device=dev, dtype=torch.int32) % S
    call = lambda: FE.fused_embed(ids, tok, pos, seg, segs,  # noqa: E731
                                  positions=positions)
    ms, dev_ms = timer.ms(call), timer.device_ms(call, "fused_embed")
    sums["main_forward"] = ms
    sums["main_forward:device"] = dev_ms
    print(json.dumps({"label": label, "path": "main_forward", "N": B * S,
                      "D": D, "segments": True, "ms": ms,
                      "device_ms": dev_ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the checkout to time")
    ap.add_argument("--label", required=True)
    ap.add_argument("--kernel", default="quant_linear",
                    choices=("quant_linear", "quant_expert_gemm",
                             "decode_attention", "flash_attention",
                             "quant_flash_attention", "dynamic_quant",
                             "addnorm_quant", "fused_embed"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_gemm_ab: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import Timer
    from repro_torch.kernels import quant_linear as QL

    dev = torch.device("cuda", 0)
    timer = Timer(dev)
    sums: dict = {}
    for path, M, K, N, act, token, n in (
            SHAPES if args.kernel == "quant_linear" else ()):
        g = torch.Generator(device=dev).manual_seed(M * K + N)
        x = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                          dtype=torch.int8)
        ws = torch.rand(N, generator=g, device=dev) * 1e-3 + 1e-5
        xs = (torch.rand((M, 1), generator=g, device=dev) * 0.02 + 1e-3
              if token else torch.tensor(0.013, device=dev))
        call = lambda: QL.quant_linear(x, w, ws, xs, act=act)  # noqa: E731
        ms = timer.ms(call)
        dev_ms = timer.device_ms(call, "quant_linear")
        lib_ms, lib_dev, packed_dev = int_mm_ms(timer, x, w, ws, xs, act)
        for key, v in ((path, ms), (path + ":device", dev_ms),
                       (path + ":library", lib_ms),
                       (path + ":library_device", lib_dev),
                       (path + ":int_mm_column_major_device", packed_dev)):
            sums[key] = sums.get(key, 0.0) + n * v
        print(json.dumps({"label": args.label, "path": path, "M": M, "K": K,
                          "N": N, "act": act, "per_token": token,
                          "ms": ms, "device_ms": dev_ms,
                          "library_ms": lib_ms,
                          "library_device_ms": lib_dev,
                          "int_mm_column_major_device_ms": packed_dev}),
              flush=True)
    if args.kernel == "quant_expert_gemm":
        time_expert_gemm(timer, dev, args.label, sums)
    if args.kernel == "decode_attention":
        time_decode(timer, dev, args.label, sums)
    if args.kernel == "flash_attention":
        time_flash(dev, args.label, sums)
    if args.kernel == "quant_flash_attention":
        time_quant_attention(timer, dev, args.label, sums)
    if args.kernel == "dynamic_quant":
        time_dynamic_quant(timer, dev, args.label, sums)
    if args.kernel == "addnorm_quant":
        time_addnorm(timer, dev, args.label, sums)
    if args.kernel == "fused_embed":
        time_embed(timer, dev, args.label, sums)
    print(json.dumps({"label": args.label, "sums_ms": sums,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
