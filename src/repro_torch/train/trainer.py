"""The training loop (port of ``repro.train.trainer``): loss -> gradients
-> AdamW update, gradient accumulation, per-layer remat, atomic checkpoints
with auto-resume, and a straggler monitor, on one device or on a mesh of
ranks.

The step is eager PyTorch autograd: no kernel of the port has a backward,
and none needs one, since the JAX package trains on its plain XLA path too
(its loss calls ``forward`` with no compute backend). The kernels come in
after training: calibrate -> ``apply_plan`` -> serve on the fused backend.

On a mesh (``mesh=`` a :class:`~repro_torch.launch.mesh.ProcessMesh`)
every rank runs the same step SPMD, as the JAX package's one jitted
program does across devices (:class:`MeshLayout`):

* parameters, both moments and the error state are held sharded under
  ``Rules(cfg, mesh)`` with FSDP on (ZeRO-3): a rank holds its block;
* the global batch is split over the dp axes ``(pod, data)`` as
  ``Rules.batch_spec`` splits it (contiguous rows, row-major);
* inside autograd each FSDP-sharded leaf is gathered over ``data`` to the
  rank's model block (:func:`~repro_torch.distributed.autograd.
  fsdp_gather`, a reduce-scatter backward), and the tensor-parallel
  forward runs over ``model`` with differentiable collectives;
* a leaf the dp axes do not shard has its gradient summed over them, and
  every gradient and the loss are divided by the dp size (the loss is a
  plain mean over rows); a leaf replicated over ``model`` needs no sum
  there: its gradient is already the same on every model rank;
* the gradient norm, and the clip, sum each leaf's squares over exactly
  the axes that shard it;
* with ``compress_pod_grads`` and a ``pod`` axis, the reduced gradient goes
  through :func:`repro_torch.distributed.compression.
  compress_allreduce_pytree` over ``pod``, as the JAX step does.

Checkpoints are the JAX package's: :meth:`TrainState.as_tree` writes the
params, both moments and the error state in its stacked layout under its
leaf names (on a mesh, every leaf gathered whole; rank 0 writes), so a
checkpoint either package writes, on any topology, resumes in the other
through :mod:`repro_torch.checkpoint.store`. The data pipeline is
counter-indexed, so resume = load the newest checkpoint + fast-forward the
step counter. Without a mesh, ``compress_pod_grads`` keeps a zero error
state, carried and checkpointed, and compresses nothing: what the JAX
package does on one device.
"""
from __future__ import annotations

import collections
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
from repro_torch.distributed import autograd as dist_ag
from repro_torch.distributed import comm
from repro_torch.distributed.compression import compress_allreduce_pytree
from repro_torch.distributed.sharding import Rules, shard_tensor
from repro_torch.interop import (flatten_names, map_leaves,
                                 params_from_numpy, params_to_numpy,
                                 tree_from_names)
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


def _spec_axes(spec) -> tuple:
    """The mesh axes a PartitionSpec names, in its order."""
    out = []
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out.append(a)
    return tuple(out)


class MeshLayout:
    """Where each leaf of a training tree lives on ``mesh``: its spec
    under ``Rules(cfg, mesh)`` with FSDP on (named as
    :func:`~repro_torch.interop.flatten_names` names the port's tree), the
    dim that FSDP alone shards over ``data`` (None where there is none),
    and the dp axes its gradient is summed over (those over 1 rank that its
    spec does not hold). ``params`` is the whole tree or any tree of its
    names and shapes."""

    def __init__(self, cfg: ArchConfig, mesh, params):
        self.mesh = mesh
        self.rules = Rules(cfg, mesh)
        self.specs = self.rules.params_spec(params)
        plain = Rules(cfg, mesh, fsdp=False).params_spec(params)
        self.fsdp_dim = {}
        for n, spec in self.specs.items():
            dims = [d for d, (a, b) in enumerate(zip(spec, plain[n]))
                    if a != b]
            self.fsdp_dim[n] = dims[0] if dims else None
        self.shapes = {n: tuple(t.shape) for n, t in flatten_names(params)}
        self.dp_axes = self.rules.axes.dp
        self.dp_size, self.dp_index = mesh.index(self.dp_axes)
        self.sum_axes = {
            n: tuple(a for a in self.dp_axes
                     if mesh.size(a) > 1 and a not in _spec_axes(spec))
            for n, spec in self.specs.items()}
        self.shard_axes = {
            n: tuple(a for a in _spec_axes(spec) if mesh.size(a) > 1)
            for n, spec in self.specs.items()}

    def shard(self, tree):
        """The rank's block of every leaf of a whole ``tree`` (params,
        moments or error state: the same names, each of its whole
        shape)."""
        def block(n, t):
            if tuple(t.shape) != self.shapes[n]:
                raise ValueError(f"{n}: shape {tuple(t.shape)}, the whole "
                                 f"leaf is {self.shapes[n]}")
            return shard_tensor(t, self.specs[n], self.mesh)
        return map_leaves(tree, block)

    def whole(self, tree):
        """Every leaf gathered whole from the ranks' blocks (a collective:
        call on every rank)."""
        def gather(n, t):
            for dim, entry in enumerate(self.specs[n]):
                axes = entry if isinstance(entry, tuple) else (entry,)
                for a in reversed(axes):
                    if a is not None:
                        t = self.mesh.all_gather(t, a, dim)
            return t
        return map_leaves(tree, gather)

    def gather_fsdp(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A shard gathered over ``data`` to the rank's model block inside
        autograd (the leaf itself where FSDP does not shard it)."""
        dim = self.fsdp_dim[name]
        if dim is None:
            return t
        return dist_ag.fsdp_gather(t, self.mesh, self.rules.axes.data, dim)

    def rows(self, batch: dict) -> dict:
        """This rank's contiguous block of the global batch's rows."""
        B = next(iter(batch.values())).shape[0]
        if B % self.dp_size:
            raise ValueError(f"a batch of {B} rows does not split over the "
                             f"dp axes {self.dp_axes} of {self.dp_size} "
                             f"ranks")
        n = B // self.dp_size
        lo = self.dp_index * n
        return {k: v[lo:lo + n] for k, v in batch.items()}

    def reduce_grads(self, grads, loss: torch.Tensor):
        """Sum each gradient over its ``sum_axes`` (one collective an axis
        set, the leaves flattened into one buffer) and the loss over the dp
        axes; divide all by the dp size."""
        flat = dict(flatten_names(grads))
        buckets = collections.defaultdict(list)
        for n, axes in self.sum_axes.items():
            if axes:
                buckets[axes].append(n)
        for axes, names in buckets.items():
            buf = torch.cat([flat[n].reshape(-1) for n in names])
            for a in axes:
                buf = self.mesh.all_reduce(buf, a)
            for n, part in zip(names, torch.split(
                    buf, [flat[n].numel() for n in names])):
                flat[n] = part.view_as(flat[n])
        for a in self.dp_axes:
            loss = self.mesh.all_reduce(loss.reshape(1), a)[0]
        if self.dp_size == 1:
            return map_leaves(grads, lambda n, _g: flat[n]), loss
        n = float(self.dp_size)
        return (map_leaves(grads, lambda k, _g: divide(flat[k], n)),
                divide(loss, n))

    def global_norm(self, grads) -> torch.Tensor:
        """:func:`~repro_torch.train.optimizer.global_norm` of a sharded
        gradient tree: each leaf's squares summed over its shard axes."""
        return global_norm(grads, mesh=self.mesh, axes=self.shard_axes)


class TrainState:
    def __init__(self, params, opt_state: AdamWState, err_state=None,
                 layout: Optional[MeshLayout] = None):
        self.params = params
        self.opt_state = opt_state
        self.err_state = err_state          # error feedback (compression)
        self.layout = layout                # sharded over a mesh

    def whole(self) -> "TrainState":
        """The state with every leaf gathered whole (a collective on a
        mesh: call on every rank); the state itself where it is whole."""
        if self.layout is None:
            return self
        whole, opt = self.layout.whole, self.opt_state
        return TrainState(whole(self.params),
                          AdamWState(opt.step, whole(opt.mu), whole(opt.nu)),
                          None if self.err_state is None
                          else whole(self.err_state))

    def as_tree(self, plan) -> dict:
        """The JAX package's ``TrainState.as_tree`` as numpy: each tree
        stacked per execution group of ``plan``. A sharded state gathers
        every leaf whole first (:meth:`whole`)."""
        s = self.whole()
        opt = s.opt_state
        t = {"params": _to_numpy(s.params, plan),
             "opt": {"step": opt.step.detach().cpu().numpy(),
                     "mu": _to_numpy(opt.mu, plan),
                     "nu": _to_numpy(opt.nu, plan)}}
        if s.err_state is not None:
            t["err"] = _to_numpy(s.err_state, plan)
        return t

    @classmethod
    def from_tree(cls, t: dict, plan,
                  device: Union[str, torch.device] = "cuda",
                  dtype: Optional[torch.dtype] = None,
                  layout: Optional[MeshLayout] = None,
                  shapes: Optional[dict] = None) -> "TrainState":
        """Inverse of :meth:`as_tree`, onto ``device``; params cast to
        ``dtype`` when given (moments and error state stay float32), and
        every tree cut to the rank's blocks under ``layout`` when given.
        ``shapes``: each leaf's whole shape by name, which every tree must
        have."""
        def shard(tree):
            if shapes is not None:
                got = {n: tuple(x.shape) for n, x in flatten_names(tree)}
                if got != shapes:
                    bad = sorted(n for n in got.keys() | shapes.keys()
                                 if got.get(n) != shapes.get(n))[:4]
                    raise ValueError(f"checkpoint leaves {bad}: shapes "
                                     f"{[got.get(n) for n in bad]}, want "
                                     f"{[shapes.get(n) for n in bad]}")
            return layout.shard(tree) if layout else tree
        params = params_from_numpy(t["params"], plan, device)
        if dtype is not None:
            params = map_leaves(params, lambda _n, p: p.to(dtype))
        step = torch.as_tensor(np.asarray(t["opt"]["step"]),
                               dtype=torch.int32).to(device)
        opt = AdamWState(
            step, shard(params_from_numpy(t["opt"]["mu"], plan, device)),
            shard(params_from_numpy(t["opt"]["nu"], plan, device)))
        err = (shard(params_from_numpy(t["err"], plan, device))
               if "err" in t else None)
        return cls(shard(params), opt, err, layout)


class Trainer:
    def __init__(self, cfg: ArchConfig, policy, *, mesh=None,
                 optimizer: AdamW = AdamW(),
                 tcfg: TrainConfig = TrainConfig(),
                 scheme: T.QuantScheme = T.QuantScheme(),
                 loss_fn: Optional[Callable] = None,
                 head: Optional[tuple] = None, moe_groups: int = 1,
                 device: Union[str, torch.device] = "cuda"):
        """``mesh``: train SPMD on the ranks of a ``ProcessMesh`` (this
        rank's ``device``); its MoE layers route one token group a dp rank,
        the rank's rows (the JAX package's ``dsize`` groups where ``pod``
        is 1). ``moe_groups``: the token groups of an unmeshed trainer's
        MoE layers, so that one can stand in for a mesh's."""
        self.cfg = cfg
        self.policy = policy
        self.plan = T.build_plan(cfg, policy)
        self.mesh = mesh
        self.optimizer = optimizer
        self.tcfg = tcfg
        self.scheme = scheme
        self.head = head
        self.moe_groups = moe_groups
        self.loss_fn = loss_fn or T.lm_loss
        self.device = resolve_device(device)
        self.layout: Optional[MeshLayout] = None
        self.rank = mesh.rank if mesh is not None else 0
        # the float32 path computes in full float32, as the JAX package does
        full_float32()
        self._step_times: list[float] = []

    # -- state ----------------------------------------------------------------
    def init_state(self, seed: int = 0, dtype=torch.float32) -> TrainState:
        """Fresh params from ``seed`` (a ``torch.Generator`` on the
        trainer's device), zero moments, and a zero error state when
        ``compress_pod_grads`` is set. On a mesh every rank builds the
        whole tree from the seed and keeps its blocks; the moments and the
        error state are made from the blocks."""
        params = T.init_params(self.cfg, self.policy, seed=seed,
                               head=self.head, device=self.device,
                               dtype=dtype)
        return self.shard(TrainState(params, self.optimizer.init(params)))

    def shard(self, state: TrainState) -> TrainState:
        """A whole state as this trainer holds it: on a mesh, each tree
        cut to the rank's blocks (ZeRO-3); with ``compress_pod_grads``, a
        zero error state where it has none."""
        params, opt, err = state.params, state.opt_state, state.err_state
        if self.mesh is not None:
            if self.layout is None:
                self.layout = MeshLayout(self.cfg, self.mesh, params)
            shard = self.layout.shard
            params = shard(params)
            opt = AdamWState(opt.step, shard(opt.mu), shard(opt.nu))
            err = shard(err) if err is not None else None
        if err is None and self.tcfg.compress_pod_grads:
            err = zeros_f32(params)
        return TrainState(params, opt, err, self.layout)

    # -- the step -------------------------------------------------------------
    def _autocast(self):
        dtype = getattr(torch, self.tcfg.compute_dtype)
        if dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=dtype)

    def _loss_kw(self, batch: dict) -> dict:
        """The mesh's arguments of the loss: the mesh, the MoE token
        groups and the attention chunk the JAX step passes (from the
        global batch's shape)."""
        if self.mesh is None:
            return {"moe_groups": self.moe_groups} \
                if self.moe_groups > 1 else {}
        lay = self.layout
        lead = batch.get("tokens", batch.get("frames"))
        return {"mesh": self.mesh, "data_shard": lay.dp_size > 1,
                "chunk": lay.rules.attn_chunk(lead.shape[0] * lay.dp_size,
                                              lead.shape[1],
                                              self.cfg.num_heads)}

    def _value_and_grad(self, params, batch):
        """(loss, float32 grads mirroring ``params``); a leaf the loss does
        not reach gets a zero gradient, as under ``jax.value_and_grad``. On
        a mesh the loss is this rank's rows' and each gradient is the
        rank's block's, summed over ``data`` for the FSDP leaves."""
        names, leaves = zip(*[(n, p.detach().requires_grad_())
                              for n, p in flatten_names(params)])
        with torch.enable_grad(), self._autocast():
            used = (dict(zip(names, leaves)) if self.layout is None else
                    {n: self.layout.gather_fsdp(n, t)
                     for n, t in zip(names, leaves)})
            tree = map_leaves(params, lambda n, _p: used[n])
            loss = self.loss_fn(tree, batch, self.cfg, self.plan,
                                self.scheme, remat=self.tcfg.remat,
                                **self._loss_kw(batch))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        g = dict(zip(names, grads))
        return (loss.detach().to(torch.float32),
                map_leaves(params, lambda n, _p: g[n].to(torch.float32)))

    def _on_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def loss_and_grads(self, params, batch: dict):
        """(loss, float32 gradients) of one global ``batch`` (numpy arrays
        or tensors) as the update sees them, before any compression: the
        mean over ``grad_accum`` contiguous micro-batches, and on a mesh
        the rank's rows, reduced over the dp axes (this rank's blocks)."""
        lay = self.layout
        if self.mesh is not None and lay is None:
            raise ValueError("a meshed trainer's state comes from "
                             "init_state or shard")
        if lay is not None:
            batch = lay.rows(batch)
        batch = self._on_device(batch)
        accum = self.tcfg.grad_accum
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
            grads = map_leaves(grads, lambda _n, a: divide(a, float(accum)))
        else:
            loss, grads = self._value_and_grad(params, batch)
        if lay is not None:
            with torch.no_grad():
                grads, loss = lay.reduce_grads(grads, loss)
        return loss, grads

    def make_step(self):
        """The eager step ``(params, opt_state, err_state, batch) ->
        (params, opt_state, err_state, metrics)``; ``batch`` may hold numpy
        arrays or tensors (on a mesh, the global batch: each rank takes its
        rows). ``metrics`` are 0-d device tensors: ``loss`` and
        ``grad_norm``, the norm before clipping."""
        lay = self.layout

        def step(params, opt_state, err_state, batch):
            loss, grads = self.loss_and_grads(params, batch)
            with torch.no_grad():
                if lay is None:
                    gnorm = global_norm(grads)
                    params2, opt_state2 = self.optimizer.update(
                        grads, opt_state, params)
                    return params2, opt_state2, err_state, \
                        {"loss": loss, "grad_norm": gnorm}
                if err_state is not None and self.mesh.size("pod") > 1:
                    grads, err_state = compress_allreduce_pytree(
                        grads, err_state, mesh=self.mesh, axis="pod")
                gnorm = lay.global_norm(grads)
                params2, opt_state2 = self.optimizer.update(
                    grads, opt_state, params, grad_norm=gnorm)
            return params2, opt_state2, err_state, \
                {"loss": loss, "grad_norm": gnorm}

        return step

    # -- the loop ------------------------------------------------------------
    def fit(self, state: TrainState, next_batch: Callable[[int], dict],
            *, start_step: int = 0, log=print) -> TrainState:
        """Run tcfg.steps steps. ``next_batch(i)`` supplies global batch i
        (counter-indexed => restart-safe). Auto-resumes from the newest
        checkpoint in tcfg.checkpoint_dir when one exists. On a mesh every
        rank calls this with the same arguments; rank 0 logs and writes
        the checkpoints, and each rank watches its own step times."""
        tcfg = self.tcfg
        step_fn = self.make_step()
        say = log if self.rank == 0 else (lambda *_: None)
        i = start_step
        if tcfg.checkpoint_dir:
            latest = store.latest_step(tcfg.checkpoint_dir)
            if latest is not None and latest > i:
                state = self._restore(latest, state)
                i = latest
                say(f"[trainer] resumed from step {latest}")
        while i < tcfg.steps:
            batch = next_batch(i)
            t0 = time.perf_counter()
            params, opt_state, err, metrics = step_fn(
                state.params, state.opt_state, state.err_state, batch)
            # reading the metrics waits for the device, as device_get does
            loss, gnorm = (float(metrics["loss"]),
                           float(metrics["grad_norm"]))
            dt = time.perf_counter() - t0
            state = TrainState(params, opt_state, err, self.layout)
            i += 1
            self._note_step_time(dt, i, log)
            if i % tcfg.log_every == 0:
                say(f"[trainer] step {i} loss={loss:.4f} "
                    f"gnorm={gnorm:.3f} dt={dt:.3f}s")
            if tcfg.checkpoint_dir and i % tcfg.checkpoint_every == 0:
                self._save(i, state)
        if tcfg.checkpoint_dir:
            self._save(i, state)
        return state

    def _restore(self, step: int, state: TrainState) -> TrainState:
        """Checkpoint ``step`` as ``state`` is held (its params' dtype; on
        a mesh, the rank's blocks): every rank reads the leaves by name and
        holds each to its whole shape, so no tree is gathered for a
        template."""
        ckpt = self.tcfg.checkpoint_dir
        dtype = flatten_names(state.params)[0][1].dtype
        shapes = (self.layout.shapes if self.layout is not None else
                  {n: tuple(p.shape) for n, p in
                   flatten_names(state.params)})
        t = tree_from_names(store.load_leaves(ckpt, step))
        # as a restore into a template: a missing leaf raises, an extra one
        # is dropped
        if state.err_state is None:
            t.pop("err", None)
        elif "err" not in t:
            raise KeyError(f"checkpoint {ckpt} step {step} has no error "
                           f"state ('err')")
        return TrainState.from_tree(t, self.plan, self.device, dtype,
                                    self.layout, shapes)

    def _save(self, step: int, state: TrainState) -> None:
        """Checkpoint ``step``: gathered on a mesh, written by rank 0; the
        other ranks wait until it is on disk."""
        whole = state.whole()
        if self.rank == 0:
            store.save(self.tcfg.checkpoint_dir, step,
                       whole.as_tree(self.plan),
                       keep_last=self.tcfg.keep_last)
        if self.mesh is not None:
            comm.barrier()

    def _note_step_time(self, dt: float, step: int, log) -> None:
        """Straggler monitor: flag steps >> the running median (on real
        fleets this feeds the controller that evicts slow hosts); on a
        mesh each rank watches its own steps."""
        self._step_times.append(dt)
        hist = self._step_times[-50:]
        if len(hist) >= 10:
            med = float(np.median(hist))
            if dt > self.tcfg.straggler_factor * med:
                who = f" rank {self.rank}" if self.mesh is not None else ""
                log(f"[trainer] STRAGGLER{who} step {step}: {dt:.3f}s vs "
                    f"median {med:.3f}s")
