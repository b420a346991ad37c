#!/usr/bin/env python3
"""Time the port's row kernels, ``addnorm_quant``, ``fused_embed`` and
``dynamic_quant``, at the served shapes in three states of the 50 MB L2
cache, for the port found under ``--src``:

* ``write``: after 64 MB of zeros written, as ``chip_smoke.py``'s Timer
  flushes, which leaves the L2 full of dirty lines that the kernel's own
  misses must write back;
* ``read``: after 64 MB read, which leaves the L2 clean and cold;
* ``none``: warm, the same call repeated.

    python3 tools/torch_row_l2.py --src src --label change

One JSON line: the median device us (``torch.profiler``) of 30 calls in
each state, for a span forward's ``addnorm_quant`` (1024 rows of 768, int8
delta), a main-path one (float x), a qwen2 decode tick's (8 rows of 896,
RMSNorm), BERT-base's ``fused_embed`` at (8, 128), and ``dynamic_quant``
at 1024 x 768 and 8 x 896. Run checkouts in turns in one call to compare
them. Needs one NVIDIA GPU; builds the checkout's kernels on first use.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the checkout to time")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_row_l2: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import addnorm_quant as AQ
    from repro_torch.kernels import dynamic_quant as DQ
    from repro_torch.kernels import fused_embed as FE

    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    words = flush.view(torch.int32).view(-1, 1024)
    sink = torch.empty(words.shape[0], dtype=torch.int32, device=dev)

    def device_us(fn, kernel, state, reps=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if state == "write":
                    flush.zero_()
                elif state == "read":
                    torch.sum(words, dim=1, dtype=torch.int32, out=sink)
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        return statistics.median(us) if us else float("nan")

    g = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for tag, M, D, int8_in, kind in (("span", 1024, 768, True, "layernorm"),
                                     ("main", 1024, 768, False, "layernorm"),
                                     ("decode", 8, 896, False, "rmsnorm")):
        x = (torch.randint(-128, 128, (M, D), generator=g, device=dev,
                           dtype=torch.int8) if int8_in
             else torch.randn((M, D), generator=g, device=dev))
        kw = dict(x_in_scale=torch.tensor(0.02, device=dev) if int8_in
                  else None, kind=kind)
        v = torch.randn(D, generator=g, device=dev)
        op = (x, torch.randn((M, D), generator=g, device=dev), v * 0.1,
              1 + 0.1 * v, None if kind == "rmsnorm" else v * 0.05,
              torch.tensor(0.025, device=dev))
        cases["addnorm_quant:" + tag] = (
            lambda op=op, kw=kw: AQ.addnorm_quant(*op, **kw),
            "addnorm_quant_kernel")
    tok, pos, seg = (torch.randn((n, 768), generator=g, device=dev)
                     for n in (21128, 512, 2))
    ids, segs = (torch.randint(0, n, (1024,), generator=g, device=dev,
                               dtype=torch.int32) for n in (21128, 2))
    positions = torch.arange(1024, device=dev, dtype=torch.int32) % 128
    cases["fused_embed"] = (
        lambda: FE.fused_embed(ids, tok, pos, seg, segs, positions=positions),
        "fused_embed_kernel")
    for M, D in ((1024, 768), (8, 896)):
        y = torch.randn((M, D), generator=g, device=dev)
        cases[f"dynamic_quant:{M}x{D}"] = (lambda y=y: DQ.dynamic_quant(y),
                                           "dynamic_quant_kernel")
    out = {"label": args.label, "device": torch.cuda.get_device_name(0)}
    for name, (fn, kernel) in cases.items():
        for state in ("write", "read", "none"):
            out[f"{name}:{state}"] = device_us(fn, kernel, state)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
