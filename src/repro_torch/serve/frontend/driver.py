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

On a mesh every rank must make every engine call (each forward runs
collectives), but only rank 0 holds the listener. So each pass of the
driver loop is first written as an ordered list of engine operations,
host values only (:data:`OPS`): ``submit`` (the request's fields, and the
arrival time an encoder request is stamped with), ``cancel`` (a uid:
client disconnects, shutdown and deadline evictions, all decided on rank
0), ``encode_step`` (with rank 0's clock reading and the force flag) and
``decode_step``. With ``publish`` set, rank 0 sends that list (through
:func:`repro_torch.distributed.comm.broadcast_object`) before it runs it,
and :func:`follow` replays each list on a follower rank's own engines.
Rank 0's clock decides the micro-batches: the batcher stamps arrivals and
ages queues with the times in the list, never a follower's own clock,
so every rank forms the same batches and runs the same collectives. A
last ``stop`` list ends the followers after a drain or an abort.
Unmeshed (``publish=None``) the engines read their own clocks, as before.

Counters (``admitted`` / ``rejected_*`` / ``completed`` /
``cancelled_*``) and the latency histogram live here; the HTTP layer
exports them at ``/metrics``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import threading
import time
from typing import Callable, Optional

from repro_torch.serve.metrics import Histogram

import numpy as np

#: the engine operations of a pass, as they cross to the follower ranks
OPS = ("submit", "cancel", "encode_step", "decode_step", "stop")

#: an idle meshed driver sends an empty list this often, so a follower's
#: wait for the next list never reaches the process group's timeout
HEARTBEAT_S = 60.0


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
                 latency: Optional[Histogram] = None,
                 publish: Optional[Callable] = None):
        if encoder is None and decode is None:
            raise ValueError("EngineDriver needs at least one engine")
        self.encoder = encoder
        self.decode = decode
        # a meshed rank 0 sends each pass's operations to the followers
        self.publish = publish
        self._published = time.monotonic()
        self.failure: Optional[BaseException] = None
        self.on_failure: Optional[Callable] = None
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
            if self.publish is not None:
                self.publish([("stop",)])       # the followers return
        except Exception as e:                  # engine failure: fail every
            self.failure = e                    # waiting client, not hang it
            err = RequestError(
                500, f"engine failure: {type(e).__name__}: {e}")
            with self._cond:
                stranded = list(self._live.values()) + self._inbox
                self._live.clear()
                self._inbox.clear()
            for fr in stranded:
                self._finalize(fr, error=err, count_completed=False)
            self._drained.set()
            if self.on_failure is not None:
                self.on_failure()
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
            ops = self._plan(inbox, cancels, abort)
            if self.publish is not None and (
                    ops or time.monotonic() - self._published
                    >= HEARTBEAT_S):
                self.publish([op for op, _ in ops])
                self._published = time.monotonic()
            progressed = False
            for op, fr in ops:
                progressed |= self._apply(op, fr)
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

    def _plan(self, inbox, cancels, abort) -> list:
        """The pass as ``[(operation, its request or None)]``, in the order
        the driver has always run it: admissions, cancels, the shutdown of
        everything live on an abort, deadline evictions, then one step of
        each engine that has or gets work. An operation on a request that
        turns out finalized (a failed admission, a second cancel) is a
        no-op on every rank. Meshed, the encoder steps only when a
        micro-batch is due at the pass's clock reading, so an ageing
        queue sends no lists."""
        now = time.monotonic() if self.publish is not None else None
        ops = []
        live = dict(self._live)
        for fr in inbox:
            r = fr.engine_req
            if fr.kind == "encode":
                fields = {"uid": r.uid, "tokens": list(r.tokens),
                          "segments": (None if r.segments is None
                                       else list(r.segments)),
                          "traffic_class": r.traffic_class}
            else:
                fields = {"uid": r.uid, "prompt": list(r.prompt),
                          "max_tokens": r.max_tokens,
                          "temperature": r.temperature, "eos_id": r.eos_id,
                          "traffic_class": r.traffic_class}
            ops.append((("submit", fr.kind, fields, now), fr))
            live[fr.uid] = fr
        dropped = [(fr, reason) for fr, reason in cancels]
        if abort:
            dropped += [(fr, "shutdown") for fr in live.values()]
        t = time.monotonic()
        dropped += [(fr, "deadline") for fr in live.values()
                    if fr.deadline is not None and t >= fr.deadline]
        ops += [(("cancel", fr.kind, fr.uid, reason), fr)
                for fr, reason in dropped]
        kinds = {fr.kind for fr in inbox}
        if self.encoder is not None:
            force = self.draining
            due = ("encode" in kinds or (
                len(self.encoder.batcher)
                and (now is None or self.encoder.batcher.due(now, force))))
            if due:
                ops.append((("encode_step", now, force), None))
        if self.decode is not None and ("generate" in kinds
                                        or self.decode.sched.busy):
            ops.append((("decode_step",), None))
        return ops

    def _apply(self, op: tuple, fr: Optional[FrontendRequest]) -> bool:
        """Run one planned operation on rank 0's engines, delivering what
        it retires; True when a request advanced."""
        if op[0] == "submit":
            self._admit(fr, op[3])
        elif op[0] == "cancel":
            self._do_cancel(fr, op[3])
        elif op[0] == "encode_step":
            return self._encode_step(op[1], op[2])
        elif op[0] == "decode_step":
            return self._decode_step()
        return False

    def _engine_for(self, fr: FrontendRequest):
        return self.encoder if fr.kind == "encode" else self.decode

    def _admit(self, fr: FrontendRequest, now: Optional[float] = None) -> None:
        try:
            if fr.kind == "encode" and now is not None:
                self.encoder.submit(fr.engine_req, now)
            else:
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

    def _encode_step(self, now: Optional[float], force: bool) -> bool:
        """The encoder's due micro-batches; True when any retired."""
        if not len(self.encoder.batcher):
            return False
        retired = (self.encoder.step(force=force) if now is None
                   else self.encoder.step(now, force))
        for req in retired:
            fr = self._live.pop(req.uid, None)
            if fr is None:
                continue
            pred = np.asarray(req.prediction).tolist()
            self._finalize(fr, result={
                "logits": np.asarray(req.logits).tolist(),
                "prediction": pred,
                "latency_s": time.monotonic() - fr.submitted})
        return bool(retired)

    def _decode_step(self) -> bool:
        """One decode tick, streaming its tokens; True when it ran (a
        decode tick moves tokens)."""
        if not self.decode.sched.busy:
            return False
        retired = self.decode.step()
        for fr in list(self._live.values()):
            if fr.kind != "generate":
                continue
            out = fr.engine_req.output
            while fr.emitted < len(out):        # stream newly decoded tokens
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
        return True

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


# ---------------------------------------------------------------------------
# the follower ranks of a meshed server
# ---------------------------------------------------------------------------


def follow(*, encoder=None, decode=None, receive: Callable) -> dict:
    """A follower rank's loop: ``receive()`` each list of operations rank
    0's driver published and replay it, in order, on this rank's engines,
    until ``stop``. Requests are rebuilt from their host fields; the
    encoder's arrivals and steps take rank 0's clock readings from the
    list. Nothing is delivered: every rank computes every result, and
    rank 0 answers. Returns counts of what was replayed."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.scheduler import EncoderRequest
    held: dict = {}
    counts = {op: 0 for op in OPS}
    counts["lists"] = 0
    while True:
        ops = receive()
        counts["lists"] += 1
        for op in ops:
            counts[op[0]] += 1
            if op[0] == "stop":
                return counts
            if op[0] == "submit":
                _, kind, fields, now = op
                try:
                    if kind == "encode":
                        req = EncoderRequest(**fields)
                        encoder.submit(req, now)
                    else:
                        req = Request(**fields)
                        decode.submit(req)
                except ValueError:              # rank 0 answered it 400
                    continue
                held[(kind, req.uid)] = req
            elif op[0] == "cancel":
                req = held.pop((op[1], op[2]), None)
                if req is None:
                    continue                    # retired or never admitted
                if op[1] == "encode":
                    encoder.batcher.cancel(req)
                else:
                    decode.sched.cancel(req)
            elif op[0] == "encode_step":
                if len(encoder.batcher):
                    for req in encoder.step(op[1], op[2]):
                        held.pop(("encode", req.uid), None)
            elif op[0] == "decode_step":
                if decode.sched.busy:
                    for req in decode.step():
                        held.pop(("generate", req.uid), None)
