"""Training launcher CLI (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 200 --batch 8 --seq 256 --ckpt /tmp/run1

The JAX CLI's flags, plus ``--device``: ``cuda`` (the default; an error
where there is no card) or ``cpu``, and ``--ranks``. The reduced config by
default, ``--full`` the production config. Resumes automatically from the
newest checkpoint in ``--ckpt`` (the JAX package's format, so a run either
package started, on any topology, resumes in the other); survives
kill-at-any-step. As the JAX CLI builds a mesh only over more than one
device, a run over more than one rank trains on ``make_host_mesh(model=
--mesh-model)``: ``--ranks N`` ranks started by
:func:`repro_torch.distributed.comm.spawn` (by default one a visible card,
one on ``--device cpu``), round-robin on the cards, so one card runs two
over gloo. ``--compress-pod-grads`` needs a ``pod`` axis, which the host
mesh never has: as in the JAX CLI it then carries a zero error state and
compresses nothing. An audio config's frames come from
``np.random.default_rng(i)`` where the JAX CLI draws them with
``jax.random``: the same shapes, other values.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.precision import EncoderPolicy
from repro_torch.data.pipeline import get_batch, make_task
from repro_torch.distributed import comm
from repro_torch.train import AdamW, TrainConfig, Trainer, cosine_schedule


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="production config (default: reduced smoke config)")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda trains on the card (an error where there is "
                         "none); cpu through plain PyTorch on the host")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to train on (default: one a visible card; "
                         "one on --device cpu); over 1, a (data, model) "
                         "mesh with model = --mesh-model")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from None
    ranks = args.ranks or (torch.cuda.device_count()
                           if device.type == "cuda" else 1)
    if ranks > 1:
        threads = (max(1, (os.cpu_count() or 1) // ranks)
                   if device.type == "cpu" else None)
        comm.spawn(ranks, _train_rank, (args,), device=device.type,
                   deadline_s=float("inf"), threads=threads)
    else:
        train(args, device)


def _train_rank(rank: int, device, args) -> None:
    from repro_torch.launch.mesh import make_host_mesh
    train(args, device, make_host_mesh(model=args.mesh_model))


def _log(msg: str) -> None:
    print(msg, flush=True)


def train(args, device, mesh=None) -> None:
    """One rank's run of the parsed ``args`` (on ``mesh`` when given)."""
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    policy = EncoderPolicy.full_float(cfg.num_layers, "bfloat16")
    tcfg = TrainConfig(steps=args.steps, checkpoint_dir=args.ckpt,
                       grad_accum=args.grad_accum, remat=True,
                       compute_dtype=args.dtype,
                       compress_pod_grads=args.compress_pod_grads)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=min(20, args.steps // 10),
                                   total=args.steps))
    trainer = Trainer(cfg, policy, mesh=mesh, optimizer=opt, tcfg=tcfg,
                      device=device)
    state = trainer.init_state(args.seed, dtype=getattr(torch, args.dtype))
    task = make_task("lm", vocab_size=cfg.vocab_size, seq_len=args.seq)

    def next_batch(i):
        b = get_batch(task, i, args.batch)
        if cfg.frontend == "audio":
            frames = np.random.default_rng(i).standard_normal(
                (args.batch, args.seq, cfg.frontend_dim), np.float32)
            return {"frames": torch.from_numpy(frames).to(
                        getattr(torch, args.dtype)),
                    "labels": b["tokens"] % cfg.vocab_size}
        return b

    trainer.fit(state, next_batch, log=_log)
    if trainer.rank == 0:
        where = f" on {mesh!r}" if mesh is not None else ""
        _log(f"[train] done: {args.steps} steps of {args.arch}"
             f"{' (reduced)' if not args.full else ''}{where}")


if __name__ == "__main__":
    main()
