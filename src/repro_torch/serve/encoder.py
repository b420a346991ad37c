"""Encoder serving engine — the paper's primary workload, served (port of
``repro.serve.encoder``).

Admission is a :class:`~repro_torch.serve.scheduler.MicroBatcher`;
execution is a :class:`~repro_torch.serve.runtime.Runtime`, which pads each
flushed micro-batch to its (batch, length) bucket and masks the padding;
the target head comes from :mod:`repro_torch.toolkit.targets`. With a
``router`` (:class:`~repro_torch.adaptive.PlanRouter`) admission stamps
each request's traffic cluster, and each cluster-pure micro-batch runs its
cluster's params through that cluster's runtime sibling. With a ``mesh``
every rank of it runs the same engine on the same requests (SPMD): the
runtime splits each micro-batch over the data axis and the layers over the
model axis, and every rank retires every request with the whole logits.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.serve.metrics import engine_counters
from repro_torch.serve.runtime import Runtime
from repro_torch.serve.scheduler import EncoderRequest, MicroBatcher
from repro_torch.toolkit.targets import TargetSpec, get_target


class EncoderServeEngine:
    """Dynamic micro-batching server for encoder workloads. ``device``
    defaults to ``"cuda"`` (an error where CUDA is absent); ``params`` must
    already live there. ``mesh`` serves on a
    :class:`~repro_torch.launch.mesh.ProcessMesh`; the engine keeps only
    the rank's block of ``params``. ``backend`` and ``mesh`` are ignored
    when a runtime is passed (its own govern)."""

    def __init__(self, cfg: ArchConfig, params, plan, *,
                 target: Union[str, TargetSpec] = "cls",
                 scheme: T.QuantScheme = T.QuantScheme(),
                 max_batch: int = 8, max_wait: float = 0.0,
                 max_len: int = 256, runtime: Optional[Runtime] = None,
                 backend="reference", router=None,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        if isinstance(target, str):
            target = get_target(target)
        if "head" not in params:
            raise ValueError(
                f"target {target.name!r} needs head params; build them with "
                f"init_params(head=...)")
        self.cfg = cfg
        self.plan = plan
        self.target = target
        self.max_len = max_len
        self.runtime = runtime or Runtime(
            cfg, plan, scheme=scheme,
            head=lambda p, h: target.apply(p, h, cfg),
            token_level=target.token_level, max_len=max_len,
            backend=backend, device=device, mesh=mesh)
        self.params = self.runtime.local_params(params)
        self.batcher = MicroBatcher(max_batch=max_batch, max_wait=max_wait,
                                    max_len=max_len)
        self.router = router
        if router is not None and not router.bound:
            router.bind(self.runtime)
        self._stats = {"requests": 0, "batches": 0, "retired": 0,
                       "batched_rows": 0}

    def submit(self, req: EncoderRequest,
               now: Optional[float] = None) -> None:
        if len(req.tokens) == 0:
            raise ValueError("empty request")
        if len(req.tokens) > self.max_len:
            raise ValueError(f"request length {len(req.tokens)} exceeds "
                             f"max_len {self.max_len}")
        if req.segments is not None and len(req.segments) != len(req.tokens):
            raise ValueError("segments length must match tokens")
        if self.router is not None:
            self.router.admit(req)      # stamps req.cluster before queueing
        self.batcher.submit(req, now)
        self._stats["requests"] += 1

    def step(self, now: Optional[float] = None,
             force: bool = False) -> list[EncoderRequest]:
        """Serve every micro-batch that is due; returns retired requests."""
        retired: list[EncoderRequest] = []
        for blen, reqs in self.batcher.ready(now, force=force):
            B = len(reqs)
            tokens = np.zeros((B, blen), np.int32)
            segments = np.zeros((B, blen), np.int32)
            lengths = np.zeros((B,), np.int32)
            for i, req in enumerate(reqs):
                n = len(req.tokens)
                tokens[i, :n] = req.tokens
                if req.segments is not None:
                    segments[i, :n] = req.segments
                lengths[i] = n
            inputs = {"tokens": tokens}
            if self.cfg.num_segments:
                inputs["segments"] = segments
            if self.router is not None:
                # the batcher keys its queues on (bucket, cluster): one
                # member serves the whole batch
                entry = self.router.entry(reqs[0].cluster)
                logits = entry.runtime.encode(entry.params, inputs, lengths)
            else:
                logits = self.runtime.encode(self.params, inputs, lengths)
            for i, req in enumerate(reqs):
                row = logits[i]
                if self.target.token_level:
                    row = row[:int(lengths[i])]
                req.logits = row
                req.prediction = np.asarray(self.target.predict(row))
                req.done = True
                retired.append(req)
            self._stats["batches"] += 1
            self._stats["batched_rows"] += B
            self._stats["retired"] += B
        return retired

    def run(self, now: Optional[float] = None) -> list[EncoderRequest]:
        """Drain the queues (force-flush partial buckets too)."""
        return self.step(now, force=True)

    @property
    def stats(self) -> dict:
        # the unified counters surface (queue depth, occupancy, completed,
        # evicted, retraces) comes from serve.metrics.engine_counters
        s = dict(self._stats)
        s.update({f"runtime_{k}": v for k, v in self.runtime.stats.items()
                  if k != "buckets"})
        s.update(engine_counters(self))
        return s
