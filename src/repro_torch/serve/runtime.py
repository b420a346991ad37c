"""The runtime every inference path goes through (port of
``repro.serve.runtime``): bucketed encodes and the decode step.

A :class:`Runtime` is bound to one ``(cfg, plan, scheme, head, backend,
mesh)`` deployment:

* request shapes are rounded up to power-of-two (batch, length) buckets, so
  a mixed-length stream runs a bounded set of shapes, except for MoE
  configs, whose expert capacity scales with the token count: padded rows
  would take capacity and change the routing of real ones. Only token
  inputs take a length bucket: audio ``frames`` run at their own length;
* padded positions carry ``-1`` (past ``lengths + P`` with a vision
  config's P prefix embeddings), which
  :func:`repro_torch.models.layers.band_mask` drops from attention, and are
  clamped to 0 for the embedding gather, so a padded forward matches the
  natural-shape forward on the real rows and positions;
* the built forward callables are cached per (backend name, plan
  fingerprint, mesh fingerprint, cluster, batch bucket, length bucket): the
  JAX package's executable key. ``cluster`` is the traffic-cluster id of a
  routed deployment (None unrouted), so K clusters hold K entries per
  bucket even where their plans coincide: their calibrated scales differ;
* ``mesh`` (a :class:`~repro_torch.launch.mesh.ProcessMesh`) serves SPMD:
  every rank of the mesh makes the same calls. The rules of
  :mod:`repro_torch.distributed.sharding` (``fsdp=False``) slice the params
  to the rank's block (:meth:`Runtime.local_params`, once a tree), the
  model axis runs the tensor-parallel forward, and the data axis splits
  the batch: buckets round up to dp multiples, each rank runs its rows (a
  decode step its slots) and the outputs are all-gathered, so every rank
  returns the whole output. An MoE layer's token groups are the JAX
  package's over the whole batch (:meth:`Runtime.moe_args`), and its
  experts split over the data axis. The backend claims a rank's local
  tensors as it claims whole ones;
* the decode step (:meth:`Runtime.decode_fn`) is cached per (backend name,
  plan fingerprint, cluster, slot count, ``kv_geometry``), so float and
  int8 caches never share an entry;
* ``stats`` counts calls, real and padded tokens, cached callables and
  ``traces``, the callables built (the JAX package counts its traces
  there; here each build is one);
* :meth:`Runtime.share` binds a sibling to another plan that shares the
  cache and counters, as ``Pipeline.with_policy`` does.

PyTorch runs eagerly: there is no trace, and the cache holds the callable
each bucket runs (the place a CUDA graph per bucket would go).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import full_float32, resolve_device
from repro_torch.distributed.sharding import (Rules, ShardedParams,
                                              mesh_fingerprint, shard_params)
from repro_torch.kernels.backend import get_backend
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

HeadFn = Callable[[dict, torch.Tensor], torch.Tensor]   # (params, hidden)


def bucket_size(n: int, floor: int = 1, cap: Optional[int] = None) -> int:
    """Smallest power of two >= n (and >= floor); clamped to ``cap`` when
    the cap itself can hold ``n``."""
    if n <= 0:
        raise ValueError(f"bucket_size needs n >= 1, got {n}")
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    if cap is not None and cap >= n:
        b = min(b, cap)
    return b


class Runtime:
    """Cached, bucketed full-sequence forwards for one deployment.

    ``head`` maps ``(params, hidden) -> logits`` (a TargetSpec's apply);
    None returns the final-norm hidden states. ``token_level`` marks
    per-position outputs so :meth:`encode` slices padding back off.
    """

    def __init__(self, cfg: ArchConfig, plan, *,
                 scheme: T.QuantScheme = T.QuantScheme(), precision=None,
                 head: Optional[HeadFn] = None, token_level: bool = False,
                 min_batch: int = 1, min_len: int = 8,
                 max_len: Optional[int] = None,
                 chunk: Optional[int] = T.DEFAULT_CHUNK,
                 backend="reference",
                 device: Union[str, torch.device] = "cuda",
                 cluster: Optional[int] = None, mesh=None,
                 moe_groups: int = 1):
        self.device = resolve_device(device)
        # TF32 off, float32 matmuls at "highest": the JAX reference computes
        # in full float32, and int_matmul's float32 products must stay exact
        full_float32()
        self.cfg = cfg
        self.plan = plan
        self.scheme = scheme
        self.precision = precision          # Optional[PrecisionPlan]
        self.head = head
        self.token_level = token_level
        self.min_batch = min_batch
        self.min_len = min_len
        self.max_len = max_len
        self.chunk = chunk
        # inference replicates params over 'data' (an MoE stack's experts
        # excepted) and shards them over 'model'
        self.mesh = mesh
        self.rules = (Rules(cfg, mesh, fsdp=False) if mesh is not None
                      else None)
        self.backend = get_backend(backend)
        self._local: Optional[tuple] = None
        self.bucketed = cfg.moe is None
        # cache key half that names the scheme: the backend (one plan runs
        # different code per backend), the plan's stable fingerprint (or a
        # structural hash of (execution plan, scheme) without one), the
        # mesh topology (other shards, other collectives) and the traffic
        # cluster of a routed deployment
        self.cluster = cluster
        if mesh is not None and moe_groups != 1:
            raise ValueError("moe_groups is the unmeshed runtime's: a mesh "
                             "takes its token groups from its data axis")
        self.moe_groups = moe_groups
        # an unmeshed runtime's MoE token groups (1: the key as without)
        self._plan_key = (self.backend.name,
                          precision.fingerprint() if precision is not None
                          else hash((plan, scheme)),
                          mesh_fingerprint(mesh),
                          cluster) + ((moe_groups,) if moe_groups != 1
                                      else ())
        self._exe: dict[tuple, Callable] = {}
        self._stats = {"calls": 0, "traces": 0, "real_tokens": 0,
                       "padded_tokens": 0}

    @property
    def _dp(self) -> int:
        """Batch-sharding factor of the bound mesh (1 when unmeshed)."""
        return self.rules.dp_size if self.rules is not None else 1

    def rows(self, B: int) -> tuple[int, int]:
        """The rows [lo, hi) of a B-row batch (or B slots) this rank runs:
        its block of the data axis where dp divides B, else all of them."""
        if self._dp == 1 or B % self._dp:
            return 0, B
        n = B // self._dp
        d = int(self.mesh.coords["data"])
        return d * n, (d + 1) * n

    def local_params(self, params):
        """This rank's block of ``params`` under the mesh's rules (the
        params themselves unmeshed). A tree the runtime sliced before is
        not sliced again, and a block already sliced for this topology
        (``ShardedParams``) passes through."""
        if self.mesh is None:
            return params
        if isinstance(params, ShardedParams):
            want = (mesh_fingerprint(self.mesh), int(self.mesh.rank))
            if params.topology != want:
                raise ValueError(f"params sliced for {params.topology}, "
                                 f"the runtime serves {want}")
            return params
        if self._local is None or self._local[0] is not params:
            self._local = (params, shard_params(params, self.rules,
                                                self.mesh))
        return self._local[1]

    def moe_args(self, B: int) -> dict:
        """An MoE layer's token groups for a batch of B rows (or slots),
        as the JAX package groups them over the whole batch: the rank's
        rows are its own group where the data axis split them
        (``data_shard``), else every rank routes the dp groups (or the
        unmeshed runtime its ``moe_groups``) over all of them."""
        if self.mesh is None:
            return {"moe_groups": self.moe_groups, "data_shard": False}
        return {"moe_groups": self._dp,
                "data_shard": self.rows(B) != (0, B)}

    def _gather_rows(self, out: torch.Tensor, B: int) -> torch.Tensor:
        """Every rank's rows of a batch it split: the whole output."""
        if self.rows(B) == (0, B):
            return out
        return self.mesh.all_gather(out, "data", 0)

    @property
    def identity(self) -> dict:
        """The deployment identity every cache key leads with, as strings
        (the ``samp_build_info`` labels of an HTTP front-end): backend,
        plan fingerprint (or the structural hash), mesh topology
        (``"unmeshed"`` without one), and the cluster of a routed
        sibling."""
        fp = self._plan_key[1]
        out = {"backend": self.backend.name,
               "plan": fp if isinstance(fp, str)
               else f"structural:{fp & 0xFFFFFFFFFFFFFFFF:016x}",
               "mesh": mesh_fingerprint(self.mesh)}
        if self.cluster is not None:
            out["cluster"] = str(self.cluster)
        return out

    @property
    def stats(self) -> dict:
        return dict(self._stats, executables=len(self._exe),
                    buckets=sorted({k[2:4] for k in self._exe
                                    if k[0] == "encode"}))

    def share(self, plan, *, scheme: Optional[T.QuantScheme] = None,
              precision=None, backend=None, mesh="inherit",
              cluster: Optional[int] = None) -> "Runtime":
        """A sibling Runtime bound to a different (plan, scheme, precision,
        backend, mesh, cluster) that SHARES this runtime's callable cache
        and counters. Cache keys lead with (backend name, precision
        fingerprint, mesh fingerprint, cluster), so two pipelines under
        different plans, one plan on two backends or two topologies, or the
        K clusters of a routed deployment share one runtime without key
        collisions. ``mesh`` defaults to this runtime's; None gives an
        unmeshed sibling."""
        rt = Runtime(self.cfg, plan, scheme=scheme or self.scheme,
                     precision=precision, head=self.head,
                     token_level=self.token_level, min_batch=self.min_batch,
                     min_len=self.min_len, max_len=self.max_len,
                     chunk=self.chunk, backend=backend or self.backend,
                     device=self.device, cluster=cluster,
                     mesh=self.mesh if mesh == "inherit" else mesh,
                     moe_groups=(self.moe_groups if mesh == "inherit"
                                 else 1))
        rt._exe = self._exe
        rt._stats = self._stats
        return rt

    def _build_encode(self) -> Callable:
        self._stats["traces"] += 1
        cfg, plan, scheme = self.cfg, self.plan, self.scheme
        head, chunk, backend, mesh = (self.head, self.chunk, self.backend,
                                      self.mesh)

        def fn(params, inputs: dict, lengths: torch.Tensor,
               moe: dict) -> torch.Tensor:
            S = inputs["frames" if cfg.frontend == "audio"
                       else "tokens"].shape[1]
            P = (inputs["prefix_embeds"].shape[1]
                 if cfg.frontend == "vision" and "prefix_embeds" in inputs
                 else 0)
            idx = torch.arange(S + P, dtype=torch.int32,
                               device=lengths.device)
            valid = idx[None, :] < (lengths + P)[:, None]         # (B, S+P)
            # -1 on padding: band_mask drops these keys, so real rows
            # attend only over their true tokens
            positions = torch.where(valid, idx[None], -1)
            x = T.embed_inputs(params, inputs, cfg,
                               positions=torch.clamp(positions, min=0),
                               backend=backend, mesh=mesh)
            x = T.run_groups(x, params, cfg, plan, scheme,
                             positions=positions, chunk=chunk,
                             backend=backend, mesh=mesh, **moe)
            x = L.norm(x, params["final_norm"], cfg.norm_kind)
            return head(params, x) if head is not None else x
        return fn

    def encode(self, params, inputs: dict,
               lengths: Optional[np.ndarray] = None) -> np.ndarray:
        """Full-sequence forward through the bucketed cache. ``inputs`` maps
        ``"tokens"`` (and ``"segments"``) to (B, S) integer arrays, or, for
        an audio config, ``"frames"`` to (B, S, frontend_dim) floats; a
        vision config may add ``"prefix_embeds"`` (B, P, frontend_dim).
        ``lengths`` (B,) gives each row's true token or frame count (default
        S; a prefix counts whole). Returns the head's output for the real
        rows as numpy (a token-level output cut to P + S positions). On a
        mesh, ``params`` is the whole tree (or this rank's block) and every
        rank returns the whole output."""
        arrs = {k: np.asarray(v) for k, v in inputs.items()}
        lead = arrs.get("tokens", arrs.get("frames"))
        B, S = lead.shape[0], lead.shape[1]
        if lengths is None:
            lengths = np.full((B,), S, np.int32)
        lengths = np.asarray(lengths, np.int32)
        Bb = bucket_size(B, self.min_batch) if self.bucketed else B
        if self.bucketed and Bb % self._dp:
            # meshed serving: the batch splits evenly over the data axis,
            # so buckets round up to dp multiples
            Bb = -(-Bb // self._dp) * self._dp
        Sb = (bucket_size(S, self.min_len, self.max_len)
              if self.bucketed and "tokens" in arrs else S)
        padded = {}
        for k, v in arrs.items():
            pad = [(0, Bb - B)] + [(0, 0)] * (v.ndim - 1)
            if k in ("tokens", "segments"):
                pad[1] = (0, Sb - v.shape[1])
                v = v.astype(np.int32)
            else:                        # frames and prefix embeddings
                v = v.astype(np.float32)
            padded[k] = np.pad(v, pad)
        full_len = np.zeros((Bb,), np.int32)
        full_len[:B] = lengths
        key = ("encode", self._plan_key, Bb, Sb)
        fn = self._exe.get(key)
        if fn is None:
            fn = self._exe[key] = self._build_encode()
        lo, hi = self.rows(Bb)
        with torch.inference_mode():
            out = fn(self.local_params(params),
                     {k: torch.from_numpy(v[lo:hi]).to(self.device)
                      for k, v in padded.items()},
                     torch.from_numpy(full_len[lo:hi]).to(self.device),
                     self.moe_args(Bb))
            out = self._gather_rows(out, Bb)[:B].to("cpu").numpy()
        self._stats["calls"] += 1
        self._stats["real_tokens"] += int(lengths.sum())
        self._stats["padded_tokens"] += Bb * Sb - int(lengths.sum())
        if self.token_level and out.ndim >= 2:
            P = (arrs["prefix_embeds"].shape[1]
                 if self.cfg.frontend == "vision" and "prefix_embeds" in arrs
                 else 0)
            out = out[:, :P + S]
        return out

    # -- decode / token-level path -------------------------------------------
    def _build_decode(self) -> Callable:
        self._stats["traces"] += 1
        cfg, plan, scheme, backend, mesh = (self.cfg, self.plan, self.scheme,
                                            self.backend, self.mesh)

        def fn(params, caches, tokens, pos, active, pages, moe):
            logits, caches = T.decode_step(params, tokens, caches, pos, cfg,
                                           plan, scheme, active=active,
                                           pages=pages, backend=backend,
                                           mesh=mesh, **moe)
            return logits[:, -1, :], caches
        return fn

    def decode_fn(self, params, caches) -> Callable:
        """Resolve the decode step for this slot count and cache geometry
        once; the returned callable is the per-tick hot path. It takes the
        tick's numpy operands (tokens (B, 1), pos (B,), active (B,), and the
        page table for paged caches, else None) and returns (logits (B, V)
        on the device, new caches). On a mesh the operands are the whole
        batch's, ``caches`` hold this rank's slots (:meth:`rows`) and the
        logits come back for every slot."""
        key = ("decode", self._plan_key, T.cache_slots(caches),
               T.kv_geometry(caches))
        fn = self._exe.get(key)
        if fn is None:
            fn = self._exe[key] = self._build_decode()
        dev = self.device

        def step(params, caches, tokens, pos, active, pages=None):
            self._stats["calls"] += 1
            B = len(tokens)
            lo, hi = self.rows(B)
            if T.cache_slots(caches) != hi - lo:
                raise ValueError(f"caches hold {T.cache_slots(caches)} "
                                 f"slots; this rank runs {hi - lo} of {B}")

            def rows(a, dtype):
                return torch.from_numpy(np.asarray(a, dtype)[lo:hi]).to(dev)
            with torch.inference_mode():
                logits, caches = fn(
                    self.local_params(params), caches,
                    rows(tokens, np.int32), rows(pos, np.int32),
                    rows(active, bool),
                    None if pages is None else rows(pages, np.int32),
                    self.moe_args(B))
                return self._gather_rows(logits, B), caches
        return step

    def decode(self, params, caches, tokens, pos, active, pages=None):
        """One decode step through a per-call key resolution (engines bind
        :meth:`decode_fn` once instead)."""
        return self.decode_fn(params, caches)(params, caches, tokens, pos,
                                              active, pages)
