"""Engine-side executor thread: the sync engines, driven asynchronously
(port of ``repro.serve.frontend.driver``).

The serving engines (:class:`~repro_torch.serve.engine.ServeEngine`,
:class:`~repro_torch.serve.encoder.EncoderServeEngine`) are synchronous,
single-threaded loops — by design: one thread owns the model state, the
schedulers, the cached callables and so every CUDA launch. The asyncio
front-end therefore never touches an engine, or a tensor. Instead:

* the event loop hands :class:`FrontendRequest` envelopes to the driver
  through a bounded, lock-guarded inbox (:meth:`EngineDriver.submit` is
  also the **admission controller**: over ``max_pending`` in-flight
  requests -> ``"capacity"``, during drain -> ``"draining"``, and the
  caller maps those to 429 / 503);
* one dedicated thread ticks the engines, evicts deadline-expired queued
  work (``MicroBatcher.evict`` / ``SlotScheduler.cancel`` — abandoned
  requests stop consuming batch occupancy *before* they are batched),
  streams decode tokens as they appear, and finalizes results back onto
  each request's event loop via ``call_soon_threadsafe``. The engines hand
  back host values only (encoder logits as numpy, decode tokens as ints),
  so nothing that crosses to the loop holds a device tensor;
* cancellation (client disconnect, deadline, shutdown) flows the other
  way through :meth:`EngineDriver.cancel` — also just an inbox message,
  so every engine mutation stays on the driver thread.

An engine exception (a CUDA error among them) answers every waiting client
with 500 and re-raises on the driver thread: it never retries elsewhere.

Counters (``admitted`` / ``rejected_*`` / ``completed`` /
``cancelled_*``) and the latency histogram live here; the HTTP layer
exports them at ``/metrics``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import threading
import time
from typing import Optional

from repro_torch.serve.metrics import Histogram

import numpy as np


class RequestError(Exception):
    """A per-request failure with an HTTP status (deadline -> 504,
    validation -> 400, shutdown -> 503); resolved into encode futures."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


@dataclasses.dataclass
class FrontendRequest:
    """One in-flight front-end request: the engine-level request plus the
    asyncio-side delivery channel (a future for encode, a token queue for
    generate) and its deadline (absolute ``time.monotonic()``)."""
    uid: int
    kind: str                                   # "encode" | "generate"
    engine_req: object                          # EncoderRequest | Request
    loop: asyncio.AbstractEventLoop
    future: Optional[asyncio.Future] = None     # encode completion
    tokens: Optional[asyncio.Queue] = None      # generate event stream
    deadline: Optional[float] = None
    submitted: float = 0.0
    emitted: int = 0                            # tokens already streamed
    finalized: bool = False


class EngineDriver:
    """Admission control + the engine executor thread."""

    CANCEL_REASONS = ("disconnect", "deadline", "shutdown")

    def __init__(self, *, encoder=None, decode=None, max_pending: int = 64,
                 tick_interval: float = 0.002,
                 latency: Optional[Histogram] = None):
        if encoder is None and decode is None:
            raise ValueError("EngineDriver needs at least one engine")
        self.encoder = encoder
        self.decode = decode
        self.max_pending = max_pending
        self.tick_interval = tick_interval
        self.latency = latency if latency is not None else Histogram(
            "samp_request_latency_seconds")
        self.counts = {"admitted": 0.0, "completed": 0.0,
                       "rejected_capacity": 0.0, "rejected_draining": 0.0,
                       **{f"cancelled_{r}": 0.0 for r in self.CANCEL_REASONS}}
        self.draining = False
        self._stopping = False
        self._abort = False
        self._cond = threading.Condition()
        self._inbox: list[FrontendRequest] = []
        self._cancels: list[tuple[FrontendRequest, str]] = []
        self._live: dict[int, FrontendRequest] = {}
        self._pending = 0                       # inbox + live
        self._drained = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- event-loop-side API (all thread-safe) -------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="samp-engine-driver")
        self._thread.start()

    @property
    def inflight(self) -> int:
        return self._pending

    def submit(self, fr: FrontendRequest) -> Optional[str]:
        """Admit ``fr`` or return the rejection reason: ``"capacity"``
        (bounded in-flight budget exhausted -> 429 + Retry-After) or
        ``"draining"`` (shutdown in progress -> 503)."""
        with self._cond:
            if self.draining or self._stopping:
                self.counts["rejected_draining"] += 1
                return "draining"
            if self._pending >= self.max_pending:
                self.counts["rejected_capacity"] += 1
                return "capacity"
            self._pending += 1
            fr.submitted = time.monotonic()
            self._inbox.append(fr)
            self.counts["admitted"] += 1
            self._cond.notify()
        return None

    def cancel(self, fr: FrontendRequest, reason: str) -> None:
        """Abandon an in-flight request (reason: disconnect | deadline |
        shutdown); the driver thread releases its slot / evicts its queue
        entry on the next tick."""
        with self._cond:
            self._cancels.append((fr, reason))
            self._cond.notify()

    def begin_drain(self) -> None:
        """Stop admitting; in-flight requests run to completion (partial
        encoder micro-batches are force-flushed)."""
        with self._cond:
            self.draining = True
            self._cond.notify()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        return self._drained.wait(timeout)

    def stop(self, *, drain: bool = False, timeout: float = 60.0) -> None:
        """Stop the driver thread. ``drain=True`` completes in-flight work
        first; ``drain=False`` cancels it with reason ``shutdown``."""
        with self._cond:
            self.draining = True
            self._stopping = True
            self._abort = self._abort or not drain
            self._cond.notify()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)

    # -- driver-thread internals ---------------------------------------------
    def _run(self) -> None:
        try:
            self._loop()
        except Exception as e:                  # engine failure: fail every
            err = RequestError(                 # waiting client, not hang it
                500, f"engine failure: {type(e).__name__}: {e}")
            with self._cond:
                stranded = list(self._live.values()) + self._inbox
                self._live.clear()
                self._inbox.clear()
            for fr in stranded:
                self._finalize(fr, error=err, count_completed=False)
            self._drained.set()
            raise

    def _loop(self) -> None:
        while True:
            with self._cond:
                if not (self._inbox or self._cancels or self._live
                        or self._stopping):
                    if self.draining:
                        self._drained.set()
                    self._cond.wait(0.1)
                inbox, self._inbox = self._inbox, []
                cancels, self._cancels = self._cancels, []
                stopping, abort = self._stopping, self._abort
            for fr in inbox:
                self._admit(fr)
            for fr, reason in cancels:
                self._do_cancel(fr, reason)
            if abort:
                for fr in list(self._live.values()):
                    self._do_cancel(fr, "shutdown")
            self._evict_expired()
            progressed = self._tick()
            if not (self._live or self._inbox):
                if self.draining:
                    self._drained.set()
                if stopping:
                    break
            elif not progressed:
                # work is queued but nothing was due (micro-batch still
                # ageing, deadline not yet reached): short engine tick
                time.sleep(self.tick_interval)
        self._drained.set()

    def _engine_for(self, fr: FrontendRequest):
        return self.encoder if fr.kind == "encode" else self.decode

    def _admit(self, fr: FrontendRequest) -> None:
        try:
            self._engine_for(fr).submit(fr.engine_req)
        except ValueError as e:                 # engine-level validation
            self._finalize(fr, error=RequestError(400, str(e)))
            return
        self._live[fr.uid] = fr

    def _do_cancel(self, fr: FrontendRequest, reason: str) -> None:
        if fr.finalized:
            return                              # retired before the cancel
        if fr.kind == "encode":
            self.encoder.batcher.cancel(fr.engine_req)
        else:
            self.decode.sched.cancel(fr.engine_req)
        self._live.pop(fr.uid, None)
        self.counts[f"cancelled_{reason}"] += 1
        if reason == "deadline":
            err = RequestError(504, "deadline exceeded")
        elif reason == "shutdown":
            err = RequestError(503, "server shutting down")
        else:                                   # client gone: nobody reads
            err = None
        self._finalize(fr, error=err, count_completed=False)

    def _evict_expired(self) -> None:
        now = time.monotonic()
        expired = [fr for fr in self._live.values()
                   if fr.deadline is not None and now >= fr.deadline]
        for fr in expired:
            self._do_cancel(fr, "deadline")

    def _tick(self) -> bool:
        """One pass over both engines; True when any request advanced."""
        progressed = False
        if self.encoder is not None and len(self.encoder.batcher):
            retired = self.encoder.step(force=self.draining)
            for req in retired:
                fr = self._live.pop(req.uid, None)
                if fr is None:
                    continue
                pred = np.asarray(req.prediction).tolist()
                self._finalize(fr, result={
                    "logits": np.asarray(req.logits).tolist(),
                    "prediction": pred,
                    "latency_s": time.monotonic() - fr.submitted})
            progressed |= bool(retired)
        if self.decode is not None and self.decode.sched.busy:
            retired = self.decode.step()
            for fr in list(self._live.values()):
                if fr.kind != "generate":
                    continue
                out = fr.engine_req.output
                while fr.emitted < len(out):    # stream newly decoded tokens
                    tok = out[fr.emitted]
                    self._deliver(fr, ("token", {"token": int(tok),
                                                 "index": fr.emitted}))
                    fr.emitted += 1
            for req in retired:
                fr = self._live.pop(req.uid, None)
                if fr is None:
                    continue
                stop = (req.eos_id is not None and req.output
                        and req.output[-1] == req.eos_id)
                self._finalize(fr, result={
                    "tokens": [int(t) for t in req.output],
                    "finish_reason": "stop" if stop else "length",
                    "latency_s": time.monotonic() - fr.submitted})
            progressed = True                   # a decode tick moves tokens
        return progressed

    # -- result delivery back to the event loop ------------------------------
    def _finalize(self, fr: FrontendRequest, *, result=None, error=None,
                  count_completed: bool = True) -> None:
        if fr.finalized:
            return
        fr.finalized = True
        with self._cond:
            self._pending -= 1
            self._cond.notify()
        if result is not None and count_completed:
            self.counts["completed"] += 1
            self.latency.observe(result["latency_s"])
        if fr.kind == "encode":
            self._deliver_future(fr, result, error)
        else:
            if error is not None:
                self._deliver(fr, ("error", {"uid": fr.uid,
                                             "status": error.status,
                                             "error": error.message}))
            elif result is not None:
                self._deliver(fr, ("done", {
                    "uid": fr.uid, "tokens": result["tokens"],
                    "finish_reason": result["finish_reason"],
                    "latency_ms": round(result["latency_s"] * 1e3, 3)}))
            else:                               # disconnect: stream is dead
                self._deliver(fr, ("error", {"uid": fr.uid, "status": 499,
                                             "error": "client disconnected"}))

    def _deliver_future(self, fr, result, error) -> None:
        def resolve():
            if fr.future.done():
                return
            if error is not None:
                fr.future.set_exception(error)
            else:
                # result=None (disconnect): resolve quietly — nobody reads
                fr.future.set_result(result)
        self._call_soon(fr, resolve)

    def _deliver(self, fr, item) -> None:
        self._call_soon(fr, fr.tokens.put_nowait, item)

    @staticmethod
    def _call_soon(fr, fn, *args) -> None:
        try:
            fr.loop.call_soon_threadsafe(fn, *args)
        except RuntimeError:
            pass                                # event loop already closed
