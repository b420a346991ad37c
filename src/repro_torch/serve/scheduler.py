"""Encoder admission: requests and dynamic micro-batching (port of the
``EncoderRequest`` / ``MicroBatcher`` half of ``repro.serve.scheduler``).

:class:`MicroBatcher` keeps per-(length bucket, cluster) FIFO queues,
flushed when a bucket reaches ``max_batch``, when its oldest request has
waited ``max_wait`` seconds, or on demand (drain), so similar-length
requests batch together and padding waste stays bounded.
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
