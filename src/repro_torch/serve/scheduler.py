"""Scheduling for both serving engines (port of ``repro.serve.scheduler``).

* :class:`SlotScheduler` — token-level continuous batching: a fixed number
  of batch slots, FIFO admission into free slots, per-slot token cursors,
  release on retirement; with a :class:`PagePool` it also owns the KV
  pages' lifecycle; with ``cluster_pure`` the live batch holds one traffic
  cluster at a time (a routed decode tick runs one member plan).
* :class:`MicroBatcher` — per-(length bucket, cluster) FIFO queues of
  encoder requests, flushed when a bucket reaches ``max_batch``, when its
  oldest request has waited ``max_wait`` seconds, or on demand (drain), so
  similar-length requests batch together, padding waste stays bounded and
  every micro-batch runs under one member plan.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.serve.runtime import bucket_size


@dataclasses.dataclass
class EncoderRequest:
    """One encoder-workload request; the engine fills ``logits`` and
    ``prediction`` at retirement."""
    uid: int
    tokens: list[int]
    segments: Optional[list[int]] = None
    traffic_class: Optional[str] = None
    cluster: int = 0
    # engine-filled:
    arrival: Optional[float] = None
    logits: Optional[np.ndarray] = None
    prediction: Optional[np.ndarray] = None
    done: bool = False


class PagePool:
    """Fixed pool of KV-cache pages with a per-slot page table.

    ``table`` is the dense ``(slots, pages_per_slot)`` int32 array the
    decode step takes as an operand: row ``s`` lists the page ids slot ``s``
    owns in token order, ``-1`` beyond its allocation. Pages are handed out
    on demand (:meth:`ensure`) as a slot's sequence crosses a page boundary
    and returned wholesale on :meth:`release`."""

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 pages_per_slot: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.table = -np.ones((slots, pages_per_slot), np.int32)
        self.free: deque = deque(range(num_pages))
        self.alloc_failures = 0

    def ensure(self, s: int, tokens: int) -> bool:
        """Grow slot ``s`` to cover ``tokens`` tokens. Returns False (table
        untouched) when the pool cannot supply enough pages: the caller
        stalls the slot until a release frees some."""
        need = -(-tokens // self.page_size) if tokens > 0 else 0
        if need > self.pages_per_slot:
            raise ValueError(f"slot {s} needs {need} pages > "
                             f"pages_per_slot={self.pages_per_slot}")
        have = int((self.table[s] >= 0).sum())
        if need - have > len(self.free):
            self.alloc_failures += 1
            return False
        for j in range(have, need):
            self.table[s, j] = self.free.popleft()
        return True

    def release(self, s: int) -> list[int]:
        """Free every page slot ``s`` owns; returns the freed ids (the
        engine invalidates their ``pages_pos`` rows before reuse)."""
        freed = [int(p) for p in self.table[s] if p >= 0]
        self.free.extend(freed)
        self.table[s] = -1
        return freed

    def pages_in_use(self) -> int:
        return self.num_pages - len(self.free)

    def bytes_per_page(self, caches) -> int:
        """One page's bytes summed over every paged tensor of ``caches``
        (the port's list of per-layer cache dicts)."""
        return sum(t.numel() // t.shape[0] * t.element_size()
                   for c in caches for name, t in c.items()
                   if name.startswith("pages_"))


class SlotScheduler:
    """Slot, admission and queue bookkeeping for token-level continuous
    batching. ``active[s]`` holds the request in slot ``s`` (None = free);
    ``cursor[s]`` counts the tokens it has consumed (prompt, then generated).
    With a :class:`PagePool`, release and cancel return the slot's pages and
    stash their ids in ``freed_pages`` for the engine to invalidate. With
    ``cluster_pure``, admission keeps the live batch to one cluster:
    requests of other clusters wait, FIFO among themselves, until the batch
    drains."""

    def __init__(self, slots: int, pool: Optional[PagePool] = None, *,
                 cluster_pure: bool = False):
        self.slots = slots
        self.queue: deque = deque()
        self.active: list = [None] * slots
        self.cursor = np.zeros(slots, np.int64)
        self.evicted = 0        # cancellations
        self.pool = pool
        self.freed_pages: list[int] = []
        self.cluster_pure = cluster_pure

    def submit(self, req) -> None:
        self.queue.append(req)

    @property
    def active_cluster(self) -> Optional[int]:
        """Cluster id of the live batch (None when no slot is occupied)."""
        for a in self.active:
            if a is not None:
                return getattr(a, "cluster", 0)
        return None

    def admit(self) -> list[int]:
        """Fill free slots FIFO; returns the newly occupied slot ids (the
        caller resets their per-slot state). In ``cluster_pure`` mode only
        requests of the live batch's cluster (on an empty batch, the queue
        head's) are admitted; the others keep their queue order."""
        newly = []
        current = self.active_cluster
        if current is None and self.queue:
            current = getattr(self.queue[0], "cluster", 0)
        skipped: deque = deque()
        for s in range(self.slots):
            if self.active[s] is not None:
                continue
            while self.queue:
                req = self.queue.popleft()
                if self.cluster_pure and getattr(req, "cluster", 0) \
                        != current:
                    skipped.append(req)
                    continue
                self.active[s] = req
                self.cursor[s] = 0
                newly.append(s)
                break
        skipped.extend(self.queue)
        self.queue = skipped
        return newly

    def live(self) -> list[int]:
        return [s for s in range(self.slots) if self.active[s] is not None]

    def release(self, s: int) -> None:
        self.active[s] = None
        if self.pool is not None:
            self.freed_pages.extend(self.pool.release(s))

    def cancel(self, req) -> Optional[str]:
        """Abandon ``req``: drop it from the queue (``"queued"``) or free
        its slot mid-generation (``"active"``). None when this scheduler
        does not hold it."""
        try:
            self.queue.remove(req)
            self.evicted += 1
            return "queued"
        except ValueError:
            pass
        for s in range(self.slots):
            if self.active[s] is req:
                self.release(s)
                self.evicted += 1
                return "active"
        return None

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(a is not None for a in self.active)


class MicroBatcher:
    """Per-(bucket, cluster) queues with size- and age-triggered flushing."""

    def __init__(self, *, max_batch: int = 8, max_wait: float = 0.0,
                 min_len: int = 8, max_len: Optional[int] = None):
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.min_len = min_len
        self.max_len = max_len
        self._queues: dict[tuple[int, int], deque] = {}
        self.evicted = 0

    def bucket(self, length: int) -> int:
        return bucket_size(length, self.min_len, self.max_len)

    def submit(self, req: EncoderRequest, now: Optional[float] = None) -> int:
        """File ``req``; returns the length bucket it landed in."""
        b = self.bucket(len(req.tokens))
        req.arrival = time.monotonic() if now is None else now
        self._queues.setdefault((b, req.cluster), deque()).append(req)
        return b

    def ready(self, now: Optional[float] = None,
              force: bool = False) -> list[tuple[int, list[EncoderRequest]]]:
        """Pop every due batch as (length_bucket, requests). Every queue
        gets its own due check, so overdue partial buckets all flush."""
        now = time.monotonic() if now is None else now
        out = []
        for key in sorted(self._queues):
            q = self._queues[key]
            while q and (force or len(q) >= self.max_batch
                         or now - q[0].arrival >= self.max_wait):
                out.append((key[0], [q.popleft()
                                     for _ in range(min(self.max_batch,
                                                        len(q)))]))
        return out

    def depth_by_cluster(self) -> dict[int, int]:
        """Queued request count per cluster id."""
        out: dict[int, int] = {}
        for (_b, c), q in self._queues.items():
            out[c] = out.get(c, 0) + len(q)
        return out

    def evict(self, predicate) -> list[EncoderRequest]:
        """Remove every queued request with ``predicate(req)`` true."""
        out: list[EncoderRequest] = []
        for key, q in self._queues.items():
            keep: deque = deque()
            for req in q:
                (out if predicate(req) else keep).append(req)
            self._queues[key] = keep
        self.evicted += len(out)
        return out

    def cancel(self, req: EncoderRequest) -> bool:
        """Drop one queued request (no-op if already flushed)."""
        return bool(self.evict(lambda r: r is req))

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())
