"""The training loop (port of ``repro.train.trainer``): loss -> gradients
-> AdamW update, gradient accumulation, per-layer remat, atomic checkpoints
with auto-resume, and a straggler monitor, on one device.

The step is eager PyTorch autograd: no kernel of the port has a backward,
and none needs one, since the JAX package trains on its plain XLA path too
(its loss calls ``forward`` with no compute backend). The kernels come in
after training: calibrate -> ``apply_plan`` -> serve on the fused backend.

Checkpoints are the JAX package's: :meth:`TrainState.as_tree` writes the
params, both moments and the error state in its stacked layout under its
leaf names, so a checkpoint either package writes resumes in the other
through :mod:`repro_torch.checkpoint.store`. The data pipeline is
counter-indexed, so resume = load the newest checkpoint + fast-forward the
step counter.

Sharded training (``mesh=``) is ROADMAP queue 1 item 8b. With no mesh,
``compress_pod_grads`` keeps a zero error state, carried and checkpointed,
and compresses nothing: what the JAX package does on one device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import full_float32, resolve_device
from repro_torch.core.quantize import divide
from repro_torch.interop import (flatten_names, map_leaves,
                                 params_from_numpy, params_to_numpy)
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import (AdamW, AdamWState, global_norm,
                                         zeros_f32)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_last: int = 3
    grad_accum: int = 1
    remat: bool = True
    compute_dtype: str = "bfloat16"
    compress_pod_grads: bool = False       # int8 DCN all-reduce (beyond-paper)
    straggler_factor: float = 2.0          # step slower than f x median -> log


def _to_numpy(tree, plan) -> dict:
    """A params-shaped tree in the JAX layout; bfloat16 leaves, which numpy
    cannot hold, as float32."""
    return params_to_numpy(map_leaves(tree, lambda _n, p: (
        p.to(torch.float32) if p.dtype == torch.bfloat16 else p)), plan)


class TrainState:
    def __init__(self, params, opt_state: AdamWState, err_state=None):
        self.params = params
        self.opt_state = opt_state
        self.err_state = err_state          # error feedback (compression)

    def as_tree(self, plan) -> dict:
        """The JAX package's ``TrainState.as_tree`` as numpy: each tree
        stacked per execution group of ``plan``."""
        opt = self.opt_state
        t = {"params": _to_numpy(self.params, plan),
             "opt": {"step": opt.step.detach().cpu().numpy(),
                     "mu": _to_numpy(opt.mu, plan),
                     "nu": _to_numpy(opt.nu, plan)}}
        if self.err_state is not None:
            t["err"] = _to_numpy(self.err_state, plan)
        return t

    @classmethod
    def from_tree(cls, t: dict, plan,
                  device: Union[str, torch.device] = "cuda",
                  dtype: Optional[torch.dtype] = None) -> "TrainState":
        """Inverse of :meth:`as_tree`, onto ``device``; params cast to
        ``dtype`` when given (moments and error state stay float32)."""
        params = params_from_numpy(t["params"], plan, device)
        if dtype is not None:
            params = map_leaves(params, lambda _n, p: p.to(dtype))
        step = torch.as_tensor(np.asarray(t["opt"]["step"]),
                               dtype=torch.int32).to(device)
        opt = AdamWState(step, params_from_numpy(t["opt"]["mu"], plan, device),
                         params_from_numpy(t["opt"]["nu"], plan, device))
        err = (params_from_numpy(t["err"], plan, device) if "err" in t
               else None)
        return cls(params, opt, err)


class Trainer:
    def __init__(self, cfg: ArchConfig, policy, *, mesh=None,
                 optimizer: AdamW = AdamW(),
                 tcfg: TrainConfig = TrainConfig(),
                 scheme: T.QuantScheme = T.QuantScheme(),
                 loss_fn: Optional[Callable] = None,
                 head: Optional[tuple] = None,
                 device: Union[str, torch.device] = "cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): the port trains on one device; sharded "
                "training is ROADMAP queue 1 item 8b (multi-GPU)")
        self.cfg = cfg
        self.policy = policy
        self.plan = T.build_plan(cfg, policy)
        self.optimizer = optimizer
        self.tcfg = tcfg
        self.scheme = scheme
        self.head = head
        self.loss_fn = loss_fn or T.lm_loss
        self.device = resolve_device(device)
        # the float32 path computes in full float32, as the JAX package does
        full_float32()
        self._step_times: list[float] = []

    # -- state ----------------------------------------------------------------
    def init_state(self, seed: int = 0, dtype=torch.float32) -> TrainState:
        """Fresh params from ``seed`` (a ``torch.Generator`` on the
        trainer's device), zero moments, and a zero error state when
        ``compress_pod_grads`` is set."""
        params = T.init_params(self.cfg, self.policy, seed=seed,
                               head=self.head, device=self.device,
                               dtype=dtype)
        err = (zeros_f32(params) if self.tcfg.compress_pod_grads
               else None)
        return TrainState(params, self.optimizer.init(params), err)

    # -- the step -------------------------------------------------------------
    def _autocast(self):
        dtype = getattr(torch, self.tcfg.compute_dtype)
        if dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=dtype)

    def _value_and_grad(self, params, batch):
        """(loss, float32 grads mirroring ``params``); a leaf the loss does
        not reach gets a zero gradient, as under ``jax.value_and_grad``."""
        names, leaves = zip(*[(n, p.detach().requires_grad_())
                              for n, p in flatten_names(params)])
        by_name = dict(zip(names, leaves))
        tree = map_leaves(params, lambda n, _p: by_name[n])
        with torch.enable_grad(), self._autocast():
            loss = self.loss_fn(tree, batch, self.cfg, self.plan,
                                self.scheme, remat=self.tcfg.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        g = dict(zip(names, grads))
        return (loss.detach().to(torch.float32),
                map_leaves(params, lambda n, _p: g[n].to(torch.float32)))

    def _on_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def make_step(self):
        """The eager step ``(params, opt_state, err_state, batch) ->
        (params, opt_state, err_state, metrics)``; ``batch`` may hold numpy
        arrays or tensors. ``metrics`` are 0-d device tensors: ``loss`` and
        ``grad_norm``, the norm before clipping."""
        accum = self.tcfg.grad_accum

        def step(params, opt_state, err_state, batch):
            batch = self._on_device(batch)
            if accum > 1:
                B = next(iter(batch.values())).shape[0]
                if B % accum:
                    raise ValueError(f"batch of {B} rows does not split "
                                     f"into {accum} micro-batches")
                mb = B // accum
                loss, grads = None, None
                # contiguous micro-batches, as the JAX step reshapes them
                for i in range(accum):
                    sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                    lv, g = self._value_and_grad(params, sub)
                    if grads is None:
                        loss, grads = lv, g
                    else:
                        loss = loss + lv
                        gd = dict(flatten_names(g))
                        grads = map_leaves(grads, lambda n, a: a + gd[n])
                loss = divide(loss, float(accum))
                grads = map_leaves(grads,
                                   lambda _n, a: divide(a, float(accum)))
            else:
                loss, grads = self._value_and_grad(params, batch)
            with torch.no_grad():
                gnorm = global_norm(grads)
                params2, opt_state2 = self.optimizer.update(grads, opt_state,
                                                            params)
            return params2, opt_state2, err_state, \
                {"loss": loss, "grad_norm": gnorm}

        return step

    # -- the loop ------------------------------------------------------------
    def fit(self, state: TrainState, next_batch: Callable[[int], dict],
            *, start_step: int = 0, log=print) -> TrainState:
        """Run tcfg.steps steps. ``next_batch(i)`` supplies global batch i
        (counter-indexed => restart-safe). Auto-resumes from the newest
        checkpoint in tcfg.checkpoint_dir when one exists."""
        tcfg = self.tcfg
        step_fn = self.make_step()
        i = start_step
        if tcfg.checkpoint_dir:
            latest = store.latest_step(tcfg.checkpoint_dir)
            if latest is not None and latest > i:
                dtype = flatten_names(state.params)[0][1].dtype
                state = TrainState.from_tree(
                    store.restore(tcfg.checkpoint_dir, latest,
                                  state.as_tree(self.plan)),
                    self.plan, self.device, dtype)
                i = latest
                log(f"[trainer] resumed from step {latest}")
        while i < tcfg.steps:
            batch = next_batch(i)
            t0 = time.perf_counter()
            params, opt_state, err, metrics = step_fn(
                state.params, state.opt_state, state.err_state, batch)
            # reading the metrics waits for the device, as device_get does
            loss, gnorm = (float(metrics["loss"]),
                           float(metrics["grad_norm"]))
            dt = time.perf_counter() - t0
            state = TrainState(params, opt_state, err)
            i += 1
            self._note_step_time(dt, i, log)
            if i % tcfg.log_every == 0:
                log(f"[trainer] step {i} loss={loss:.4f} "
                    f"gnorm={gnorm:.3f} dt={dt:.3f}s")
            if tcfg.checkpoint_dir and i % tcfg.checkpoint_every == 0:
                store.save(tcfg.checkpoint_dir, i, state.as_tree(self.plan),
                           keep_last=tcfg.keep_last)
        if tcfg.checkpoint_dir:
            store.save(tcfg.checkpoint_dir, i, state.as_tree(self.plan),
                       keep_last=tcfg.keep_last)
        return state

    def _note_step_time(self, dt: float, step: int, log) -> None:
        """Straggler monitor: flag steps >> the running median (on real
        fleets this feeds the controller that evicts slow hosts)."""
        self._step_times.append(dt)
        hist = self._step_times[-50:]
        if len(hist) >= 10:
            med = float(np.median(hist))
            if dt > self.tcfg.straggler_factor * med:
                log(f"[trainer] STRAGGLER step {step}: {dt:.3f}s vs median "
                    f"{med:.3f}s")
