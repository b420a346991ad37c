#!/usr/bin/env python3
"""Sweep the learning rate of ``SAMP.finetune`` on full-width BERT-base
(float32, ``tnews``, 128 positions, batches of 32, seed 0) on one card:
for each rate, the median step ms (the Trainer's host clock after the loss
is read), the loss every 10 steps and the float dev accuracy on 4 batches
of 32. The reference backend evaluates, so no kernel is built.

    python3 tools/torch_finetune_lr.py --steps 100 --lr 3e-5 1e-4 3e-4 1e-3

One JSON line a rate, each with the card's name and power limit
(``nvidia-smi``). ``chip_smoke.py``'s ``train_path`` fine-tunes at the
rate chosen from this sweep. Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, nargs="+",
                    default=[3e-5, 1e-4, 3e-4, 1e-3])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_finetune_lr: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import _train_losses
    from repro_torch.configs import get_config
    from repro_torch.toolkit import SAMP

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    for lr in args.lr:
        samp = SAMP.from_config(get_config("bert-base"), task="tnews",
                                seq_len=128, float_dtype="float32",
                                device=dev)
        logs = []
        t = time.perf_counter()
        samp.finetune(steps=args.steps, lr=lr, batch_size=32, log_every=1,
                      seed=0, log=logs.append)
        seconds = time.perf_counter() - t
        losses, dts = _train_losses(logs)
        print(json.dumps({
            "card": card, "lr": lr, "steps": args.steps,
            "finetune_s": seconds,
            "median_step_ms": statistics.median(dts) * 1e3,
            "losses_every_10": losses[::10],
            "loss_last10_mean": statistics.mean(losses[-10:]),
            "float_dev_accuracy": samp.eval(batches=4, batch_size=32)}),
            flush=True)
        del samp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
