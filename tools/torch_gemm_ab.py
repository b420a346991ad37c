#!/usr/bin/env python3
"""Time the PyTorch port's GEMM kernels, ``quant_linear`` or
``quant_expert_gemm`` (``--kernel``), at the shapes of ``chip_smoke.py``'s
served paths, for the port found under ``--src``, so that two checkouts are
compared on one card within one call:

    python3 tools/torch_gemm_ab.py --src <checkout>/src --label parent
    python3 tools/torch_gemm_ab.py --src src --label change

Run it for each checkout in turns (parent, change, change, parent): two
calls may land on cards that differ. Each shape is timed as in
``chip_smoke.py`` (CUDA events, median of 25, L2 flushed) on seeded int8
operands; one JSON line per shape, then the sums over one decode tick of
qwen2-0.5b (the decode paths), of the MoE path's attention GEMMs, and over
one forward of the main path's BERT at (8, 128), weighted by the launches
each plan makes; for the expert GEMM, over one tick of the MoE path
(capacity 3) and over the same nine GEMMs of a (4, 128) forward (capacity
160), with static per-expert scales.
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
        ms = timer.ms(lambda: EG.quant_expert_gemm(xe, w, ws, xs))
        sums[path] = sums.get(path, 0.0) + n * ms
        print(json.dumps({"label": label, "path": path, "G": G, "E": E,
                          "C": C, "D": D, "F": F, "ms": ms}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the checkout to time")
    ap.add_argument("--label", required=True)
    ap.add_argument("--kernel", default="quant_linear",
                    choices=("quant_linear", "quant_expert_gemm"))
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
        ms = timer.ms(lambda: QL.quant_linear(x, w, ws, xs, act=act))
        sums[path] = sums.get(path, 0.0) + n * ms
        print(json.dumps({"label": args.label, "path": path, "M": M, "K": K,
                          "N": N, "act": act, "per_token": token,
                          "ms": ms}), flush=True)
    if args.kernel == "quant_expert_gemm":
        time_expert_gemm(timer, dev, args.label, sums)
    print(json.dumps({"label": args.label, "sums_ms": sums,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
