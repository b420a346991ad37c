"""Token-level continuous-batching decode engine (port of
``repro.serve.engine``).

* scheduling — a :class:`~repro_torch.serve.scheduler.SlotScheduler`: a
  fixed number of batch slots, FIFO admission, per-slot token cursors,
  release on retirement;
* execution — a :class:`~repro_torch.serve.runtime.Runtime`, whose decode
  step is cached per (backend, plan fingerprint, slots, cache geometry).

Every tick runs one decode step for the whole batch with per-slot positions:
each live slot consumes one token, its next prompt token while it
prefills, or its last generated token while it decodes, so new requests
stream in token by token beside generations in flight. Idle slots are masked
with ``active``, which gates their cache writes. With ``page_size`` the KV
caches are paged: pages are allocated as a slot's sequence grows, freed on
retirement or cancel, and their position rows invalidated before reuse; a
pool that cannot grow any live slot preempts the youngest request, which
replays from its prompt. With a ``router``
(:class:`~repro_torch.adaptive.PlanRouter`) each request is assigned a
traffic cluster at admission, the slot scheduler keeps the live batch to
one cluster, and each tick runs that cluster's params through its own
cached decode step; the KV caches are shared across clusters, so every
member plan must name the same KV-cache schemes. With a ``mesh`` every rank
of it runs the same engine (SPMD): the same scheduler, page table and
requests on every rank, the caches holding the rank's slots (the data axis
splits them where it divides them) and KV heads (the model axis), and the
page pool whole on every rank of the data axis, since page ids are global.
Every rank samples from the whole logits, so every rank serves the same
tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.metrics import engine_counters
from repro_torch.serve.runtime import Runtime
from repro_torch.serve.scheduler import PagePool, SlotScheduler

# page geometry when a plan implies paging but the caller picked no size
DEFAULT_PAGE_SIZE = 16


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    # adaptive routing: a tag from the client, and the cluster id assigned
    # at admission (decode batches stay cluster-pure)
    traffic_class: Optional[str] = None
    cluster: int = 0
    # engine-filled:
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def text_len(self) -> int:
        return len(self.prompt) + len(self.output)


class ServeEngine:
    """Greedy (or temperature-sampled) generation over a decode-capable
    config. ``kv_cache`` picks the page scheme of every layer ("float",
    "int8_per_head", "int8_per_token") and needs ``page_size``; None takes
    the per-layer schemes of ``precision`` (a PrecisionPlan, which implies
    paging when it quantizes any KV cache), else float. ``pool_pages``
    sizes the shared page pool (default: slots * pages_per_slot, no
    oversubscription). ``backend`` is ignored when a runtime is passed.
    ``router`` makes decode input-adaptive (see the module docstring);
    ``precision`` then defaults to the default member's plan. ``mesh``
    serves on a :class:`~repro_torch.launch.mesh.ProcessMesh` (ignored,
    like ``backend``, when a runtime is passed); the engine keeps only the
    rank's block of ``params``."""

    def __init__(self, cfg: ArchConfig, params, plan, *,
                 scheme: T.QuantScheme = T.QuantScheme(),
                 batch_slots: int = 4, max_len: int = 256, seed: int = 0,
                 runtime: Optional[Runtime] = None, backend="reference",
                 page_size: Optional[int] = None,
                 kv_cache: Optional[str] = None,
                 pool_pages: Optional[int] = None, precision=None,
                 router=None,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only; no decode — "
                             f"serve it through EncoderServeEngine")
        if router is not None:
            if not router.uniform_kv():
                raise ValueError(
                    "routed decode shares one KV-cache tree across "
                    "clusters: every PlanSet member must name the same "
                    "per-layer kv_cache schemes")
            if precision is None:
                precision = router.planset.plan_for(router.planset.default)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.plan = plan
        self.slots = batch_slots
        self.max_len = max_len
        if page_size is None and kv_cache is None and precision is not None \
                and precision.num_quant_kv:
            page_size = DEFAULT_PAGE_SIZE      # the plan asks for int8 KV
        self.page_size = page_size
        self.pool: Optional[PagePool] = None
        cache_kw = {}
        if page_size is not None:
            if kv_cache is not None:
                schemes = (kv_cache,) * cfg.num_layers
            elif precision is not None:
                schemes = precision.kv_schemes
            else:
                schemes = ("float",) * cfg.num_layers
            pps = T.pages_per_slot(max_len, page_size)
            num_pages = (pool_pages if pool_pages is not None
                         else batch_slots * pps)
            self.pool = PagePool(num_pages, page_size, batch_slots, pps)
            cache_kw = dict(page_size=page_size, num_pages=num_pages,
                            kv_schemes=schemes)
        elif kv_cache not in (None, "float"):
            raise ValueError("kv_cache quantization needs the paged layout; "
                             "pass page_size= as well")
        self.sched = SlotScheduler(batch_slots, pool=self.pool,
                                   cluster_pure=router is not None)
        self.runtime = runtime or Runtime(cfg, plan, scheme=scheme,
                                          precision=precision,
                                          backend=backend,
                                          device=self.device, mesh=mesh)
        self.params = self.runtime.local_params(params)
        self.router = router
        if router is not None and not router.bound:
            router.bind(self.runtime)
        # the slots [lo, hi) this rank holds (all of them unmeshed)
        self._lo, hi = self.runtime.rows(batch_slots)
        mesh = self.runtime.mesh
        with torch.inference_mode():
            self.caches = T.init_caches(cfg, plan, hi - self._lo, max_len,
                                        device=self.device, mesh=mesh,
                                        **cache_kw)
            # a fresh one-slot cache: what an admitted slot's rows reset to
            # (0, -1 for k_pos, ones for an sLSTM's normalizer)
            self._fresh1 = T.init_caches(
                cfg, plan, 1, max_len, device=self.device, mesh=mesh,
                **({**cache_kw, "num_pages": 1} if cache_kw else {}))
        # the decode step, resolved once; a routed engine resolves one per
        # cluster on first use, each under its sibling's cache key
        self._decode = (None if router is not None
                        else self.runtime.decode_fn(self.params,
                                                    self.caches))
        self._decode_by_cluster: dict = {}
        self.rng = np.random.default_rng(seed)
        self._stats = {"ticks": 0, "tokens": 0, "retired": 0, "stalls": 0,
                       "preemptions": 0, "requests": 0}
        # set when a deadlock preemption shows the pool cannot hold the
        # working set: admission waits until pages are freed, so preempted
        # requests do not thrash straight back into a slot
        self._admission_hold = False

    # -- request lifecycle ----------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) == 0:
            raise ValueError("empty prompt")
        if len(req.prompt) + req.max_tokens > self.max_len:
            raise ValueError(f"prompt+max_tokens exceeds max_len "
                             f"{self.max_len}")
        if self.router is not None:
            self.router.admit(req)      # stamps req.cluster before queueing
        self.sched.submit(req)
        self._stats["requests"] += 1

    def _reset_slot(self, s: int) -> None:
        """Reset slot ``s``'s rows of every cache (in place) to a fresh
        one-slot cache's: a dense ring's entries (K and V, or MLA's latent)
        to 0 and its ``k_pos`` to -1, ``pos`` to 0, a recurrent state to its
        start (an sLSTM's ``n`` to ones). The page pool has no slot axis: a
        slot's pages are its page-table row, owned by the scheduler, and
        stale page contents are invalidated by :meth:`_drain_freed`. On a
        mesh only the rank that holds slot ``s`` has rows to reset."""
        s -= self._lo
        if not 0 <= s < T.cache_slots(self.caches):
            return
        with torch.inference_mode():
            for c, fresh in zip(self.caches, self._fresh1):
                for key, leaf in c.items():
                    if not key.startswith("pages_"):
                        leaf[s] = fresh[key][0]

    def _drain_freed(self) -> None:
        """Invalidate the position rows of the pages freed since the last
        tick, before their ids can be handed out again: a reused page must
        never show another request's positions to the mask."""
        freed = self.sched.freed_pages
        if not freed:
            return
        self.sched.freed_pages = []
        self._admission_hold = False        # headroom again: admit freely
        idx = torch.tensor(sorted(set(freed)), dtype=torch.int64,
                           device=self.device)
        with torch.inference_mode():
            for c in self.caches:
                if "pages_pos" in c:
                    c["pages_pos"][idx] = -1

    # -- the serving loop -----------------------------------------------------
    def step(self) -> list[Request]:
        """One engine tick: one decode step for the whole batch."""
        if not self._admission_hold:
            for s in self.sched.admit():
                self._reset_slot(s)
        self._drain_freed()
        live = self.sched.live()
        if not live:
            return []
        if self.pool is not None:
            # grow each live slot's pages to cover this tick's token; slots
            # the pool cannot serve stall (masked, cursor held) until a
            # retirement frees pages
            def need(s):
                return int(self.sched.cursor[s]) + 1
            stalled = [s for s in live if not self.pool.ensure(s, need(s))]
            if stalled:
                self._stats["stalls"] += len(stalled)
                if len(stalled) == len(live):
                    # deadlock: every live slot needs a page and none can
                    # retire to free one. Preempt the youngest slot (least
                    # progress lost): its request goes back to the queue
                    # head, replayed from its prompt on re-admission
                    if len(live) == 1:
                        raise RuntimeError(
                            "page pool exhausted: a single request needs "
                            "more pages than the pool holds; raise "
                            "pool_pages")
                    victim = min(stalled,
                                 key=lambda s: int(self.sched.cursor[s]))
                    req = self.sched.active[victim]
                    self.sched.release(victim)
                    self.sched.queue.appendleft(req)
                    self._drain_freed()
                    self._admission_hold = True
                    self._stats["preemptions"] += 1
                    live.remove(victim)
                    stalled = [s for s in live
                               if not self.pool.ensure(s, need(s))]
                live = [s for s in live if s not in stalled]
                if not live:
                    return []
        tokens = np.zeros((self.slots, 1), np.int32)
        pos = np.zeros(self.slots, np.int32)
        active = np.zeros(self.slots, bool)
        for s in live:
            req = self.sched.active[s]
            c = int(self.sched.cursor[s])
            # the prompt, then the generated tokens: output[-1] at steady
            # state, the generated prefix replayed after a preemption
            tokens[s, 0] = (req.prompt[c] if c < len(req.prompt)
                            else req.output[c - len(req.prompt)])
            pos[s] = c
            active[s] = True
        pages = self.pool.table if self.pool is not None else None
        if self.router is not None:
            # a cluster-pure batch: run the live cluster's step and params
            entry = self.router.entry(self.sched.active_cluster)
            decode = self._decode_by_cluster.get(entry.cluster)
            if decode is None:
                decode = self._decode_by_cluster[entry.cluster] = \
                    entry.runtime.decode_fn(entry.params, self.caches)
            step_params = entry.params
        else:
            decode, step_params = self._decode, self.params
        logits, self.caches = decode(step_params, self.caches, tokens, pos,
                                     active, pages)
        logits = logits.to(torch.float32).cpu().numpy()
        self._stats["ticks"] += 1
        self._stats["tokens"] += len(live)

        retired: list[Request] = []
        for s in live:
            req = self.sched.active[s]
            self.sched.cursor[s] += 1
            # still consuming the prompt (or replaying generated tokens
            # after a preemption)? sampling resumes at the text frontier
            if self.sched.cursor[s] < req.text_len:
                continue
            row = logits[s]
            if req.temperature > 0:
                p = np.exp((row - row.max()) / req.temperature)
                p /= p.sum()
                nxt = int(self.rng.choice(len(p), p=p))
            else:
                nxt = int(row.argmax())
            req.output.append(nxt)
            hit_eos = req.eos_id is not None and nxt == req.eos_id
            if hit_eos or len(req.output) >= req.max_tokens \
                    or req.text_len >= self.max_len:
                req.done = True
                retired.append(req)
                self.sched.release(s)
                self._stats["retired"] += 1
        return retired

    def run(self, max_ticks: int = 100_000) -> list[Request]:
        """Drain the queue and the work in flight; returns the requests in
        retirement order."""
        done: list[Request] = []
        ticks = 0
        while self.sched.busy and ticks < max_ticks:
            done.extend(self.step())
            ticks += 1
        return done

    @property
    def kv_cache_bytes(self) -> int:
        """Total decode-cache footprint, paged or dense."""
        return T.cache_bytes(self.caches)

    @property
    def kv_pages_in_use(self) -> int:
        """Allocated pages in the pool (0 for dense caches)."""
        return self.pool.pages_in_use() if self.pool is not None else 0

    @property
    def stats(self) -> dict:
        # the unified counters surface (queue depth, occupancy, completed,
        # evicted, KV bytes and pages, retraces) comes from
        # serve.metrics.engine_counters
        s = dict(self._stats)
        s.update({f"runtime_{k}": v for k, v in self.runtime.stats.items()
                  if k != "buckets"})
        s.update(engine_counters(self))
        return s
