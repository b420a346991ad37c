"""The asyncio HTTP/SSE serving front-end (port of
``repro.serve.frontend.server``).

One :class:`HTTPFrontend` holds up to two engines — an encoder engine
(JSON request/response) and a decode engine (SSE token streaming) — and
exposes them over four routes:

* ``POST /v1/encode`` — ``{"tokens": [...], "segments"?, "deadline_ms"?}``
  -> ``{"uid", "logits", "prediction", "latency_ms"}``;
* ``POST /v1/generate`` — ``{"prompt": [...], "max_tokens"?,
  "temperature"?, "eos_id"?, "deadline_ms"?}`` -> an SSE stream of
  ``token`` events followed by one ``done`` (or ``error``) event;
* ``GET /metrics`` — Prometheus text (the catalog in
  ``docs/http-serving.md``);
* ``GET /healthz`` — liveness; 503 while draining.

Transport policy (the engine/transport split):

* the event loop only parses/writes bytes and awaits futures — every
  engine mutation happens on the :class:`EngineDriver` thread;
* admission control is a bounded in-flight budget (``max_pending``):
  overflow answers **429 + Retry-After**, drain answers **503**;
* a dropped connection cancels the request wherever it is — queued
  requests are evicted before batching, an active decode slot is
  released mid-generation;
* ``begin_drain()`` (wired to SIGTERM by :meth:`run_forever`) stops
  admission, completes in-flight work, then closes the listener.
"""
from __future__ import annotations

import asyncio
import itertools
import signal
import time
from typing import Optional

from repro_torch.serve.frontend import protocol as P
from repro_torch.serve.frontend.driver import (EngineDriver,
                                               FrontendRequest, RequestError)
from repro_torch.serve.metrics import MetricsRegistry, engine_counters
from repro_torch.serve.scheduler import EncoderRequest


class HTTPFrontend:
    """HTTP/SSE transport over the serving engines (see module docstring).

    ``encoder`` / ``decode`` are pre-built engines (at least one);
    ``max_pending`` bounds admitted-but-unfinished requests;
    ``default_deadline_s`` applies to requests that state no
    ``deadline_ms`` (None = no deadline). ``port=0`` binds an ephemeral
    port (read it back from ``self.port`` after :meth:`start`).
    ``publish`` makes this the rank 0 of a meshed server: the driver sends
    each pass's engine operations through it to the follower ranks
    (:func:`~repro_torch.serve.frontend.driver.follow`), and an engine
    failure drains the front-end, so the rank returns and reports it."""

    def __init__(self, *, encoder=None, decode=None,
                 host: str = "127.0.0.1", port: int = 8000,
                 max_pending: int = 64,
                 default_deadline_s: Optional[float] = None,
                 tick_interval: float = 0.002,
                 registry: Optional[MetricsRegistry] = None, log=print,
                 publish=None):
        self.encoder = encoder
        self.decode = decode
        self.host = host
        self.port = port
        self.default_deadline_s = default_deadline_s
        self.log = log
        self.registry = registry or MetricsRegistry()
        self.driver = EngineDriver(encoder=encoder, decode=decode,
                                   max_pending=max_pending,
                                   tick_interval=tick_interval,
                                   publish=publish)
        self.draining = False
        self._uids = itertools.count(1)
        self._server: Optional[asyncio.base_events.Server] = None
        self._done: Optional[asyncio.Event] = None
        self._register_metrics()

    # -- metrics wiring ------------------------------------------------------
    def _register_metrics(self) -> None:
        reg, drv = self.registry, self.driver
        reg.register(drv.latency, "histogram",
                     "end-to-end request latency, admission to completion "
                     "(seconds); quantiles over the recent-sample reservoir")

        def count(key):
            return lambda: drv.counts[key]

        reg.counter("samp_requests_admitted_total",
                    "requests accepted by admission control",
                    fn=count("admitted"))
        for reason in ("capacity", "draining"):
            reg.counter("samp_requests_rejected_total",
                        "requests refused at admission (429 capacity / "
                        "503 draining)", labels={"reason": reason},
                        fn=count(f"rejected_{reason}"))
        for reason in drv.CANCEL_REASONS:
            reg.counter("samp_requests_cancelled_total",
                        "in-flight requests abandoned (disconnect / "
                        "deadline / shutdown)", labels={"reason": reason},
                        fn=count(f"cancelled_{reason}"))
        reg.gauge("samp_requests_inflight",
                  "admitted requests not yet finished",
                  fn=lambda: drv.inflight)
        # decode KV-cache occupancy — always exported (0 when no decode
        # engine is mounted) so dashboards keyed on CORE_METRICS never
        # miss the family
        dec = self.decode
        reg.gauge("samp_kv_cache_bytes",
                  "decode cache footprint in bytes, every leaf (paged "
                  "pools or dense rings, data + scales + bookkeeping)",
                  fn=lambda: float(dec.kv_cache_bytes) if dec else 0.0)
        reg.gauge("samp_kv_pages_in_use",
                  "KV pages currently allocated out of the decode page "
                  "pool (0 for dense caches)",
                  fn=lambda: float(dec.kv_pages_in_use) if dec else 0.0)

        for name, engine in (("encoder", self.encoder),
                             ("decode", self.decode)):
            if engine is None:
                continue
            labels = {"engine": name}
            reg.gauge("samp_build_info",
                      "active deployment identity (constant 1; the labels "
                      "carry plan fingerprint and backend)",
                      labels={**labels, **engine.runtime.identity},
                      fn=lambda: 1.0)

            def sample(key, e=engine):
                return lambda: float(engine_counters(e)[key])

            reg.gauge("samp_queue_depth", "requests queued in the "
                      "scheduler, not yet running", labels,
                      fn=sample("queue_depth"))
            reg.gauge("samp_batch_occupancy", "busy decode slots / mean "
                      "encoder micro-batch fill", labels,
                      fn=sample("occupancy"))
            reg.counter("samp_requests_completed_total",
                        "requests retired by the engine", labels,
                        fn=sample("completed"))
            reg.counter("samp_requests_evicted_total",
                        "requests evicted by the scheduler (cancel / "
                        "deadline)", labels, fn=sample("evicted"))
            reg.counter("samp_runtime_retraces_total",
                        "cached callables the runtime built", labels,
                        fn=sample("retraces"))
            reg.gauge("samp_runtime_executables",
                      "distinct callables in the runtime cache",
                      labels, fn=sample("executables"))
            # adaptive-routing families — always exported (CORE_METRICS):
            # an unrouted engine books every request under cluster "0" and
            # reports one active plan
            router = getattr(engine, "router", None)
            if router is not None:
                for c in sorted(router.requests_by_cluster):
                    reg.counter(
                        "samp_cluster_requests_total",
                        "requests assigned to each traffic cluster at "
                        "admission", labels={**labels, "cluster": str(c)},
                        fn=(lambda r=router, c=c:
                            float(r.requests_by_cluster[c])))
                reg.gauge("samp_active_plans",
                          "distinct precision-plan fingerprints live in "
                          "the deployment", labels,
                          fn=lambda r=router: float(r.active_plans))
            else:
                reg.counter("samp_cluster_requests_total",
                            "requests assigned to each traffic cluster at "
                            "admission", labels={**labels, "cluster": "0"},
                            fn=(lambda e=engine:
                                float(e._stats.get("requests", 0))))
                reg.gauge("samp_active_plans",
                          "distinct precision-plan fingerprints live in "
                          "the deployment", labels, fn=lambda: 1.0)

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> "HTTPFrontend":
        self._done = asyncio.Event()
        if self.driver.publish is not None:
            loop = asyncio.get_running_loop()
            self.driver.on_failure = (
                lambda: loop.call_soon_threadsafe(self.begin_drain))
        self.driver.start()
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def serve_forever(self) -> None:
        """Returns once a drain (or stop) completes."""
        await self._done.wait()

    def begin_drain(self) -> None:
        """Graceful shutdown, signal-handler safe: reject new requests
        (503), finish in-flight ones, then close the listener."""
        if self.draining:
            return
        self.draining = True
        self.driver.begin_drain()
        asyncio.get_running_loop().create_task(self._finish_drain())

    async def _finish_drain(self) -> None:
        while not self.driver.wait_drained(0):
            await asyncio.sleep(0.02)
        await self._shutdown(drain=True)

    async def drain(self) -> None:
        """Awaitable graceful drain (what SIGTERM triggers)."""
        self.begin_drain()
        await self._done.wait()

    async def stop(self) -> None:
        """Hard stop: close the listener and cancel in-flight work with
        reason ``shutdown`` (503 into any waiting client)."""
        self.draining = True
        await self._shutdown(drain=False)

    async def _shutdown(self, *, drain: bool) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self.driver.stop(drain=drain)
        if self._done is not None:
            self._done.set()

    def run_forever(self) -> None:
        """Blocking entrypoint: start, install SIGTERM/SIGINT drain
        handlers, serve until drained."""

        async def main():
            await self.start()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    loop.add_signal_handler(sig, self.begin_drain)
                except NotImplementedError:     # non-unix event loops
                    pass
            mounted = [n for n, e in (("encoder", self.encoder),
                                      ("decode", self.decode)) if e]
            self.log(f"[server] listening on http://{self.host}:{self.port} "
                     f"engines={'+'.join(mounted)}", flush=True)
            await self.serve_forever()
            self.log("[server] drained; bye", flush=True)

        asyncio.run(main())

    # -- connection handling -------------------------------------------------
    async def _handle(self, reader, writer) -> None:
        try:
            req = await P.read_request(reader)
            if req is not None:
                await self._dispatch(req, reader, writer)
        except P.ProtocolError as e:
            self._write(writer, P.json_response(e.status,
                                                {"error": e.reason}))
        except (ConnectionResetError, BrokenPipeError,
                asyncio.IncompleteReadError):
            pass                                # client went away mid-parse
        except Exception as e:                  # keep the listener alive
            try:
                self._write(writer, P.json_response(
                    500, {"error": f"{type(e).__name__}: {e}"}))
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _dispatch(self, req, reader, writer) -> None:
        if req.path == "/metrics" and req.method == "GET":
            self._write(writer, P.response(
                200, self.registry.render().encode("utf-8"),
                content_type="text/plain; version=0.0.4"))
        elif req.path == "/healthz" and req.method == "GET":
            status = 503 if self.draining else 200
            self._write(writer, P.json_response(status, {
                "status": "draining" if self.draining else "ok",
                "engines": {"encoder": self.encoder is not None,
                            "decode": self.decode is not None},
                "inflight": self.driver.inflight}))
        elif req.path == "/v1/encode" and req.method == "POST":
            await self._encode(req, reader, writer)
        elif req.path == "/v1/generate" and req.method == "POST":
            await self._generate(req, reader, writer)
        else:
            self._write(writer, P.json_response(
                404, {"error": f"no route {req.method} {req.path}"}))

    @staticmethod
    def _write(writer, payload: bytes) -> None:
        if not writer.is_closing():
            writer.write(payload)

    def _write_reject(self, writer, reason: str) -> None:
        if reason == "capacity":
            self._write(writer, P.json_response(
                429, {"error": "server at capacity; retry later",
                      "reason": reason},
                headers={"Retry-After": "1"}))
        else:
            self._write(writer, P.json_response(
                503, {"error": "server draining; not accepting requests",
                      "reason": reason},
                headers={"Retry-After": "5"}))

    # -- request validation helpers ------------------------------------------
    @staticmethod
    def _int_list(payload: dict, key: str, max_len: int) -> list[int]:
        v = payload.get(key)
        if (not isinstance(v, list) or not v
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in v)):
            raise P.ProtocolError(
                400, f"{key!r} must be a non-empty list of ints")
        if len(v) > max_len:
            raise P.ProtocolError(
                400, f"{key!r} length {len(v)} exceeds max_len {max_len}")
        return v

    @staticmethod
    def _traffic_class(req, payload: dict) -> Optional[str]:
        """The request's traffic-class tag: the ``traffic_class`` JSON
        field when present, else the ``X-SAMP-Traffic-Class`` header
        (headers arrive lowercased). None when neither is given — the
        router then clusters on content alone."""
        tc = payload.get("traffic_class")
        if tc is None:
            tc = req.headers.get("x-samp-traffic-class")
        if tc is not None and (not isinstance(tc, str) or not tc):
            raise P.ProtocolError(400, "'traffic_class' must be a "
                                       "non-empty string")
        return tc

    def _deadline(self, payload: dict) -> Optional[float]:
        ms = payload.get("deadline_ms")
        if ms is None:
            return (time.monotonic() + self.default_deadline_s
                    if self.default_deadline_s else None)
        if not isinstance(ms, (int, float)) or isinstance(ms, bool) \
                or ms <= 0:
            raise P.ProtocolError(400, "'deadline_ms' must be a positive "
                                       "number")
        return time.monotonic() + float(ms) / 1e3

    # -- POST /v1/encode ------------------------------------------------------
    async def _encode(self, req, reader, writer) -> None:
        if self.encoder is None:
            self._write(writer, P.json_response(
                404, {"error": "no encoder engine mounted"}))
            return
        payload = req.json()
        tokens = self._int_list(payload, "tokens", self.encoder.max_len)
        segments = payload.get("segments")
        if segments is not None and (
                not isinstance(segments, list)
                or len(segments) != len(tokens)
                or not all(isinstance(t, int) for t in segments)):
            raise P.ProtocolError(400, "'segments' must be an int list the "
                                       "same length as 'tokens'")
        deadline = self._deadline(payload)
        loop = asyncio.get_running_loop()
        uid = next(self._uids)
        fr = FrontendRequest(uid=uid, kind="encode",
                             engine_req=EncoderRequest(
                                 uid=uid, tokens=tokens, segments=segments,
                                 traffic_class=self._traffic_class(req,
                                                                   payload)),
                             loop=loop, future=loop.create_future(),
                             deadline=deadline)
        reason = self.driver.submit(fr)
        if reason is not None:
            self._write_reject(writer, reason)
            return
        eof = asyncio.ensure_future(reader.read(1))
        try:
            done, _ = await asyncio.wait({fr.future, eof},
                                         return_when=asyncio.FIRST_COMPLETED)
            if fr.future not in done:           # connection dropped
                self.driver.cancel(fr, "disconnect")
                return
            result = fr.future.result()
        except RequestError as e:
            self._write(writer, P.json_response(
                e.status, {"uid": uid, "error": e.message}))
            return
        finally:
            eof.cancel()
        if result is None:                      # cancelled under our feet
            return
        self._write(writer, P.json_response(200, {
            "uid": uid, "logits": result["logits"],
            "prediction": result["prediction"],
            "latency_ms": round(result["latency_s"] * 1e3, 3)}))

    # -- POST /v1/generate ----------------------------------------------------
    async def _generate(self, req, reader, writer) -> None:
        if self.decode is None:
            self._write(writer, P.json_response(
                404, {"error": "no decode engine mounted"}))
            return
        payload = req.json()
        prompt = self._int_list(payload, "prompt", self.decode.max_len)
        max_tokens = payload.get("max_tokens", 16)
        if not isinstance(max_tokens, int) or isinstance(max_tokens, bool) \
                or max_tokens < 1:
            raise P.ProtocolError(400, "'max_tokens' must be a positive int")
        if len(prompt) + max_tokens > self.decode.max_len:
            raise P.ProtocolError(
                400, f"prompt+max_tokens ({len(prompt)}+{max_tokens}) "
                     f"exceeds max_len {self.decode.max_len}")
        temperature = payload.get("temperature", 0.0)
        if not isinstance(temperature, (int, float)) \
                or isinstance(temperature, bool) or temperature < 0:
            raise P.ProtocolError(400, "'temperature' must be >= 0")
        eos_id = payload.get("eos_id")
        if eos_id is not None and not isinstance(eos_id, int):
            raise P.ProtocolError(400, "'eos_id' must be an int")
        deadline = self._deadline(payload)
        loop = asyncio.get_running_loop()
        uid = next(self._uids)
        from repro_torch.serve.engine import Request
        fr = FrontendRequest(uid=uid, kind="generate",
                             engine_req=Request(uid=uid, prompt=prompt,
                                                max_tokens=max_tokens,
                                                temperature=float(
                                                    temperature),
                                                eos_id=eos_id,
                                                traffic_class=self.
                                                _traffic_class(req, payload)),
                             loop=loop, tokens=asyncio.Queue(),
                             deadline=deadline)
        reason = self.driver.submit(fr)
        if reason is not None:
            self._write_reject(writer, reason)
            return
        writer.write(P.sse_preamble())
        await writer.drain()
        eof = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                get = asyncio.ensure_future(fr.tokens.get())
                done, _ = await asyncio.wait(
                    {get, eof}, return_when=asyncio.FIRST_COMPLETED)
                if get not in done:             # connection dropped
                    get.cancel()
                    self.driver.cancel(fr, "disconnect")
                    return
                event, data = get.result()
                try:
                    writer.write(P.sse_event(event, data))
                    await writer.drain()
                except (ConnectionResetError, BrokenPipeError):
                    self.driver.cancel(fr, "disconnect")
                    return
                if event in ("done", "error"):
                    return
        finally:
            eof.cancel()
