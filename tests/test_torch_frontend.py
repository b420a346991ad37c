"""Port parity for the HTTP/SSE front-end (``repro_torch.serve.frontend``
against ``repro.serve.frontend``): the wire protocol byte for byte, the
engine cases of ``tests/test_frontend.py`` on the port's engines (HTTP
encode equal to ``Pipeline.predict_logits``, 429 burst, deadline 504,
drain, one metrics surface, SSE decode equal to the direct engine,
disconnect), an engine failure answered with 500s, and the same numpy
weights served through both packages' front-ends.

The clients here are a small stdlib one (SSE parsed by the port's
``protocol.parse_sse``); every HTTP session, and every exchange in it, has
a time limit of its own."""
import asyncio
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.serve import EncoderServeEngine as JaxEncoderEngine
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.frontend import HTTPFrontend as JaxFrontend
from repro.serve.frontend import protocol as JP

from repro_torch.configs import get_config
from repro_torch.core.plan import PrecisionPlan
from repro_torch.launch.serve import build_model
from repro_torch.serve import (EncoderRequest, EncoderServeEngine,
                               MicroBatcher, Request, ServeEngine,
                               SlotScheduler)
from repro_torch.serve.frontend import HTTPFrontend
from repro_torch.serve.frontend import protocol as P
from repro_torch.serve.metrics import CORE_METRICS, engine_counters
from repro_torch.toolkit import SAMP

from test_torch_decode import qw  # noqa: F401  (module fixture)
from test_torch_support import GOLDEN, bert_slice, rel_linf

HOST = "127.0.0.1"
EXCHANGE_S = 60.0            # one HTTP exchange
SESSION_S = 120.0            # one front-end session
SILENT = lambda *a, **k: None  # noqa: E731


# ---------------------------------------------------------------------------
# a small stdlib client
# ---------------------------------------------------------------------------


def _request(method: str, path: str, body=None) -> bytes:
    data = (b"" if body is None else body if isinstance(body, bytes)
            else json.dumps(body).encode("utf-8"))
    return (f"{method} {path} HTTP/1.1\r\nHost: {HOST}\r\n"
            f"Content-Length: {len(data)}\r\n\r\n").encode("latin1") + data


async def _exchange(port: int, raw: bytes, timeout: float = EXCHANGE_S):
    """Send one request, read to connection close: (status, headers,
    body bytes)."""

    async def go():
        reader, writer = await asyncio.open_connection(HOST, port)
        try:
            writer.write(raw)
            await writer.drain()
            return await reader.read()
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    data = await asyncio.wait_for(go(), timeout)
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode("latin1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    return int(lines[0].split()[1]), headers, body


async def http_json(port, method, path, body=None):
    status, headers, raw = await _exchange(port, _request(method, path,
                                                          body))
    return status, headers, json.loads(raw)


async def http_sse(port, body):
    """POST /v1/generate: (status, headers, [(event, data), ...]) for a
    stream, or the JSON object of a refusal."""
    status, headers, raw = await _exchange(
        port, _request("POST", "/v1/generate", body))
    if headers.get("content-type") == "text/event-stream":
        return status, headers, P.parse_sse(raw.decode("utf-8"))
    return status, headers, json.loads(raw)


async def scrape_metrics(port) -> str:
    _, _, raw = await _exchange(port, _request("GET", "/metrics"))
    return raw.decode("utf-8")


def run_session(fe, scenario):
    """Boot ``fe`` (either package's front-end), run ``scenario(port)``
    against it under the session's time limit, always stop."""

    async def main():
        await fe.start()
        try:
            return await asyncio.wait_for(scenario(fe.port), SESSION_S)
        finally:
            await fe.stop()

    return asyncio.run(main())


# ---------------------------------------------------------------------------
# the wire protocol: the JAX package's bytes
# ---------------------------------------------------------------------------

EVENTS = [("token", {"token": 7, "index": 0}),
          ("done", {"uid": 3, "tokens": [7, 9], "finish_reason": "stop",
                    "latency_ms": 1.25}),
          ("error", {"uid": 4, "status": 504, "error": "deadline exceeded"}),
          ("message", {"text": "naïve 中文"})]


@pytest.mark.parametrize("event,data", EVENTS, ids=[e for e, _ in EVENTS])
def test_sse_event_bytes_match_jax(event, data):
    assert P.sse_event(event, data) == JP.sse_event(event, data)
    assert P.sse_preamble() == JP.sse_preamble()


RESPONSES = [(200, {"uid": 1, "logits": [0.5, -1.0]}, None),
             (429, {"error": "x", "reason": "capacity"},
              {"Retry-After": "1"}),
             (503, {"error": "draining"}, {"Retry-After": "5"}),
             (404, {"error": "no route GET /x"}, None),
             (499, {"error": "unknown status"}, None)]


@pytest.mark.parametrize("status,obj,headers", RESPONSES,
                         ids=[str(r[0]) for r in RESPONSES])
def test_responses_match_jax(status, obj, headers):
    assert P.json_response(status, obj, headers=headers) == \
        JP.json_response(status, obj, headers=headers)
    body = json.dumps(obj).encode()
    for ct in ("application/json", "text/plain; version=0.0.4"):
        assert P.response(status, body, content_type=ct,
                          headers=headers) == \
            JP.response(status, body, content_type=ct, headers=headers)
    head = P.json_response(status, obj, headers=headers).split(
        b"\r\n\r\n")[0]
    assert b"Connection: close" in head


SSE_BODIES = [
    "".join(JP.sse_event(e, d).decode() for e, d in EVENTS),
    "event: token\ndata: {\"token\": 1}\n\n: a comment\n\ndata: {\"a\": 2}",
    "",
    "event: only-a-name\n\n",
]


@pytest.mark.parametrize("body", SSE_BODIES, ids=range(len(SSE_BODIES)))
def test_parse_sse_matches_jax(body):
    assert P.parse_sse(body) == JP.parse_sse(body)


_BIG = P.MAX_BODY_BYTES + 1
STREAMS = {
    "post": b'POST /v1/encode?x=1 HTTP/1.1\r\nHost: x\r\n'
            b'Content-Length: 18\r\n\r\n{"tokens": [1, 2]}',
    "get": b"get /healthz HTTP/1.0\r\nX-Trace:  a:b \r\n\n",
    "eof": b"",
    "garbage": b"NOT A REQUEST\r\n\r\n",
    "not_http": b"GET / FTP/1.1\r\n\r\n",
    "truncated_headers": b"GET / HTTP/1.1\r\nHost: x\r\n",
    "malformed_header": b"GET / HTTP/1.1\r\nno colon here\r\n\r\n",
    "bad_length": b"POST / HTTP/1.1\r\nContent-Length: ten\r\n\r\n",
    "oversize_body": b"POST / HTTP/1.1\r\nContent-Length: %d\r\n\r\n" % _BIG,
    "oversize_headers": b"GET / HTTP/1.1\r\n"
                        + b"X-Pad: " + b"a" * P.MAX_HEADER_BYTES + b"\r\n\r\n",
    "missing_length": b"POST /v1/encode HTTP/1.1\r\n\r\n{\"tokens\": [1]}",
    "short_body": b"POST / HTTP/1.1\r\nContent-Length: 10\r\n\r\nabc",
}


async def _read(mod, data: bytes):
    r = asyncio.StreamReader(limit=2 * P.MAX_HEADER_BYTES)
    r.feed_data(data)
    r.feed_eof()
    try:
        req = await mod.read_request(r)
    except mod.ProtocolError as e:
        return ("ProtocolError", e.status, e.reason)
    except asyncio.IncompleteReadError as e:
        return ("IncompleteReadError", len(e.partial), e.expected)
    if req is None:
        return None
    return (req.method, req.path, req.headers, req.body)


@pytest.mark.parametrize("name", list(STREAMS))
def test_read_request_matches_jax(name):
    async def both():
        return (await asyncio.wait_for(_read(P, STREAMS[name]), EXCHANGE_S),
                await asyncio.wait_for(_read(JP, STREAMS[name]), EXCHANGE_S))
    ours, theirs = asyncio.run(both())
    assert ours == theirs


@pytest.mark.parametrize("body", [b'{"tokens": [1, 2]}', b"", b"[1, 2]",
                                  b"{not json", b"\xff\xfe"])
def test_request_json_matches_jax(body):
    def parse(mod):
        try:
            return mod.HTTPRequest("POST", "/", {}, body).json()
        except mod.ProtocolError as e:
            return ("ProtocolError", e.status, e.reason)
    assert parse(P) == parse(JP)


# ---------------------------------------------------------------------------
# scheduler-level cancellation units (no model)
# ---------------------------------------------------------------------------


def test_slot_scheduler_cancel_queued_and_active():
    sched = SlotScheduler(slots=1)
    a = Request(uid=0, prompt=[1, 2], max_tokens=4)
    b = Request(uid=1, prompt=[3], max_tokens=4)
    sched.submit(a)
    sched.submit(b)
    assert sched.admit() == [0] and sched.active[0] is a
    assert sched.cancel(b) == "queued"          # evicted before a slot
    assert sched.cancel(a) == "active"          # slot released mid-flight
    assert sched.live() == [] and sched.evicted == 2
    assert sched.cancel(a) is None              # already gone


def test_microbatcher_evict_preserves_queue_order():
    mb = MicroBatcher(max_batch=8, max_wait=100.0, min_len=8)
    reqs = [EncoderRequest(uid=i, tokens=[1] * 5) for i in range(4)]
    for r in reqs:
        mb.submit(r, now=0.0)
    gone = mb.evict(lambda r: r.uid in (1, 3))
    assert [r.uid for r in gone] == [1, 3] and mb.evicted == 2
    assert len(mb) == 2
    assert mb.cancel(reqs[0]) and not mb.cancel(reqs[0])
    got = mb.ready(now=0.0, force=True)
    assert [q.uid for _, qs in got for q in qs] == [2]  # order kept


# ---------------------------------------------------------------------------
# encoder: HTTP == Pipeline.predict_logits on the golden plan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bert_golden():
    """Golden-plan-quantized bert facade on the CPU; engines built from it
    share the quantized pipeline's runtime."""
    samp = SAMP.from_config(get_config("bert-base").reduced(), task="tnews",
                            seq_len=32, float_dtype="float32", device="cpu")
    samp.pipeline.init_params(torch.Generator("cpu").manual_seed(0))
    samp.calibrate(num_batches=1, batch_size=4,
                   precision=PrecisionPlan.load(GOLDEN))
    qpipe = samp.apply_plan_file(GOLDEN)
    return samp, qpipe


def test_concurrent_encode_matches_pipeline_and_metrics(bert_golden):
    """Two concurrent HTTP clients read the logits the direct
    ``Pipeline.predict_logits`` path computes, and a /metrics scrape
    exposes the full core catalog."""
    samp, qpipe = bert_golden
    fe = samp.serve_http(port=0, batch_slots=4, max_len=32, max_wait=0.01,
                         log=SILENT)
    toks = [[5, 9, 3, 7, 2, 11], [4, 8, 1, 6, 2, 9, 10, 3]]
    batches = [{"tokens": np.asarray([t]),
                "segments": np.zeros((1, len(t)), np.int32)} for t in toks]
    direct = [qpipe.predict_logits(b)[0] for b in batches]
    direct_pred = [int(qpipe.predict(b)[0]) for b in batches]

    async def scenario(port):
        results = await asyncio.gather(
            *(http_json(port, "POST", "/v1/encode", {"tokens": t})
              for t in toks))
        return results, await scrape_metrics(port)

    results, metrics = run_session(fe, scenario)
    for (status, _, obj), want, want_pred in zip(results, direct,
                                                 direct_pred):
        assert status == 200
        np.testing.assert_allclose(np.asarray(obj["logits"]),
                                   np.asarray(want), rtol=0, atol=1e-5)
        assert obj["prediction"] == want_pred
    for name in CORE_METRICS:
        assert name in metrics, name
    assert 'samp_build_info{backend="reference",engine="encoder"' in metrics
    assert "samp_requests_admitted_total 2" in metrics
    assert "cached callables the runtime built" in metrics
    # the deployment identity names the topology, as the JAX package's
    assert 'mesh="unmeshed"' in metrics


def test_burst_over_capacity_yields_429_and_rejection_counter(bert_golden):
    """6 concurrent clients against max_pending=2 with a long micro-batch
    ageing window: exactly 4 get 429 + Retry-After, counted at /metrics."""
    samp, _ = bert_golden
    engine = samp.serve(batch_slots=8, max_len=32, max_wait=0.5)
    fe = HTTPFrontend(encoder=engine, port=0, max_pending=2, log=SILENT)

    async def scenario(port):
        results = await asyncio.gather(
            *(http_json(port, "POST", "/v1/encode",
                        {"tokens": [3 + i, 5, 9, 2]}) for i in range(6)))
        return results, await scrape_metrics(port)

    results, metrics = run_session(fe, scenario)
    assert sorted(s for s, _, _ in results) == [200, 200, 429, 429, 429, 429]
    for status, headers, obj in results:
        if status == 429:
            assert headers.get("retry-after") == "1"
            assert obj["reason"] == "capacity"
    assert 'samp_requests_rejected_total{reason="capacity"} 4' in metrics
    assert fe.driver.counts["rejected_capacity"] == 4


def test_deadline_expiry_evicts_queued_microbatch_request(bert_golden):
    """A queued request whose deadline passes before its bucket ages out is
    evicted from the MicroBatcher (never batched) and answered 504."""
    samp, _ = bert_golden
    engine = samp.serve(batch_slots=8, max_len=32, max_wait=10.0)
    fe = HTTPFrontend(encoder=engine, port=0, log=SILENT)

    async def scenario(port):
        t0 = time.monotonic()
        status, _, obj = await http_json(
            port, "POST", "/v1/encode",
            {"tokens": [5, 9, 3], "deadline_ms": 100})
        return status, obj, time.monotonic() - t0

    status, obj, took = run_session(fe, scenario)
    assert status == 504 and "deadline" in obj["error"]
    assert took < 5.0                           # never waited out max_wait
    assert engine.batcher.evicted == 1
    assert fe.driver.counts["cancelled_deadline"] == 1
    assert engine._stats["batches"] == 0     # never batched, only evicted
    assert len(engine.batcher) == 0


def test_drain_completes_inflight_and_rejects_new(bert_golden):
    """begin_drain: the queued in-flight request is force-flushed to a 200,
    a post-drain submission gets 503, and the server task returns. The
    forced flush is held at a gate until the 503 has been read, so the
    listener cannot close before the second client connects."""
    samp, _ = bert_golden
    engine = samp.serve(batch_slots=8, max_len=32, max_wait=30.0)
    gate = threading.Event()
    step = engine.step

    def gated_step(now=None, force=False):
        if force:
            gate.wait(SESSION_S)
        return step(now, force)

    engine.step = gated_step
    fe = HTTPFrontend(encoder=engine, port=0, log=SILENT)

    async def scenario(port):
        try:
            inflight = asyncio.create_task(http_json(
                port, "POST", "/v1/encode", {"tokens": [7, 2, 9, 4]}))
            for _ in range(500):                # wait until it is admitted
                if fe.driver.inflight:
                    break
                await asyncio.sleep(0.01)
            assert fe.driver.inflight == 1
            fe.begin_drain()
            health = await http_json(port, "GET", "/healthz")
            rejected = await http_json(port, "POST", "/v1/encode",
                                       {"tokens": [1, 2, 3]})
        finally:
            gate.set()
        completed = await inflight
        await asyncio.wait_for(fe.serve_forever(), SESSION_S)
        return completed, rejected, health

    (st_ok, _, obj_ok), (st_no, hdr_no, _), health = run_session(fe,
                                                                 scenario)
    assert st_ok == 200 and "logits" in obj_ok  # drained, not dropped
    assert st_no == 503 and hdr_no.get("retry-after") == "5"
    assert health[0] == 503 and health[2]["status"] == "draining"
    assert fe.driver.counts["rejected_draining"] == 1
    assert fe.driver.counts["completed"] == 1


def test_engine_stats_and_metrics_share_one_surface(bert_golden):
    """engine.stats carries exactly the engine_counters numbers /metrics
    samples."""
    samp, _ = bert_golden
    engine = samp.serve(batch_slots=4, max_len=32)
    counters = engine_counters(engine)
    stats = engine.stats
    for key in ("queue_depth", "occupancy", "capacity", "completed",
                "evicted", "retraces", "executables"):
        assert stats[key] == counters[key], key


def test_engine_failure_answers_500_and_reraises(bert_golden):
    """An engine exception (on the card, a CUDA error) answers every
    waiting client with 500 and stops the driver thread: no retry."""
    samp, _ = bert_golden
    engine = samp.serve(batch_slots=8, max_len=32, max_wait=0.05)

    def broken(now=None, force=False):
        raise RuntimeError("quant_linear: CUDA error: an illegal memory "
                           "access was encountered")

    engine.step = broken
    fe = HTTPFrontend(encoder=engine, port=0, log=SILENT)
    errors = []
    hook = threading.excepthook
    threading.excepthook = lambda a: errors.append(a.exc_value)
    try:
        async def scenario(port):
            return await asyncio.gather(
                *(http_json(port, "POST", "/v1/encode", {"tokens": [3, i]})
                  for i in range(1, 4)))
        results = run_session(fe, scenario)
    finally:
        threading.excepthook = hook
    assert [s for s, _, _ in results] == [500, 500, 500]
    assert all("RuntimeError" in obj["error"] and "CUDA" in obj["error"]
               for _, _, obj in results)
    assert [type(e) for e in errors] == [RuntimeError]
    assert fe.driver.counts["completed"] == 0


# ---------------------------------------------------------------------------
# decode: SSE stream == direct ServeEngine.run on the golden plan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen_golden():
    cfg = get_config("qwen2-0.5b").reduced()
    params, plan, _ = build_model(cfg, plan_file=GOLDEN, log=SILENT,
                                  device="cpu")
    return cfg, params, plan


def test_concurrent_sse_decode_matches_direct_engine(qwen_golden):
    cfg, params, plan = qwen_golden
    prompts = [[2, 17, 9], [5, 40]]
    direct = ServeEngine(cfg, params, plan, batch_slots=2, max_len=48,
                         device="cpu")
    for i, p in enumerate(prompts):
        direct.submit(Request(uid=i, prompt=list(p), max_tokens=5))
    want = {tuple(r.prompt): r.output for r in direct.run()}
    fe = HTTPFrontend(decode=ServeEngine(cfg, params, plan, batch_slots=2,
                                         max_len=48, device="cpu"),
                      port=0, log=SILENT)

    async def scenario(port):
        return await asyncio.gather(
            *(http_sse(port, {"prompt": p, "max_tokens": 5})
              for p in prompts))

    for p, (status, _, events) in zip(prompts, run_session(fe, scenario)):
        assert status == 200
        streamed = [d["token"] for e, d in events if e == "token"]
        done = [d for e, d in events if e == "done"]
        assert len(done) == 1
        assert done[0]["tokens"] == streamed    # stream == final transcript
        assert streamed == want[tuple(p)]       # == direct engine decode
        assert [d["index"] for e, d in events if e == "token"] == \
            list(range(len(streamed)))


def test_disconnect_mid_decode_releases_slot(qwen_golden):
    """A client that vanishes mid-stream frees its slot (slots=1, so a
    follow-up request completes only if the first was cancelled)."""
    cfg, params, plan = qwen_golden
    engine = ServeEngine(cfg, params, plan, batch_slots=1, max_len=48,
                         device="cpu")
    fe = HTTPFrontend(decode=engine, port=0, log=SILENT)

    async def scenario(port):
        reader, writer = await asyncio.open_connection(HOST, port)
        writer.write(_request("POST", "/v1/generate",
                              {"prompt": [2, 17, 9], "max_tokens": 40}))
        await writer.drain()
        buf = b""
        while buf.count(b"event: token") < 2:   # mid-generation, provably
            chunk = await asyncio.wait_for(reader.read(512), EXCHANGE_S)
            assert chunk, "stream ended before two tokens"
            buf += chunk
        writer.close()                          # client vanishes
        await writer.wait_closed()
        for _ in range(500):                    # slot must come free
            if not engine.sched.live() and not fe.driver.inflight:
                break
            await asyncio.sleep(0.02)
        assert not engine.sched.live()
        return await http_sse(port, {"prompt": [5, 40], "max_tokens": 3})

    status, _, events = run_session(fe, scenario)
    assert status == 200
    assert len([d for e, d in events if e == "done"]) == 1
    assert engine.sched.evicted >= 1
    assert fe.driver.counts["cancelled_disconnect"] == 1


# ---------------------------------------------------------------------------
# the same numpy weights through both packages' front-ends
# ---------------------------------------------------------------------------

ENCODE_CALLS = [
    ("POST", "/v1/encode", {"tokens": [5, 9, 3, 7, 2, 11]}),
    ("POST", "/v1/encode", {"tokens": list(range(1, 30)),
                            "segments": [0] * 29}),
    ("POST", "/v1/encode", {"tokens": [4, 8, 1], "deadline_ms": 60000}),
    ("POST", "/v1/encode", {"tokens": []}),
    ("POST", "/v1/encode", {"tokens": [1] * 40}),
    ("POST", "/v1/encode", {"tokens": [1, 2], "segments": [0]}),
    ("POST", "/v1/encode", {"tokens": [1, 2], "deadline_ms": -1}),
    ("POST", "/v1/encode", b"{not json"),
    ("POST", "/v1/generate", {"prompt": [1, 2]}),
    ("GET", "/healthz", None),
    ("GET", "/v1/encode", None),
    ("DELETE", "/nowhere", None),
]

GENERATE_CALLS = [
    {"prompt": [2, 17, 9], "max_tokens": 5},
    {"prompt": [5, 40], "max_tokens": 4, "eos_id": 999999},
    {"prompt": [11, 3, 7, 1], "max_tokens": 6, "deadline_ms": 60000},
    {"prompt": [1, 2], "max_tokens": 0},
    {"prompt": [1] * 40, "max_tokens": 20},
    {"prompt": [1, 2], "temperature": -1},
    {"prompt": [1, True]},
    {"prompt": [1, 2], "eos_id": "x"},
]


def _encode_session(fe):
    async def scenario(port):
        out = []
        for method, path, body in ENCODE_CALLS:     # one at a time: each
            out.append(await http_json(port, method, path, body))
        return out                                  # a batch of one
    return run_session(fe, scenario)


def _generate_session(fe):
    async def scenario(port):
        out = [await http_sse(port, body) for body in GENERATE_CALLS]
        out.append(await http_json(port, "POST", "/v1/encode",
                                   {"tokens": [1]}))
        return out
    return run_session(fe, scenario)


def test_encoder_frontends_agree_with_jax():
    """The JAX-quantized golden plan, carried across: the same status
    codes and JSON keys on every call, identical predictions and logits
    within 5e-3 rel-Linf."""
    s = bert_slice(GOLDEN)
    kw = dict(target="cls", max_batch=4, max_wait=0.0, max_len=32)
    jfe = JaxFrontend(encoder=JaxEncoderEngine(s["jcfg"], s["jq"],
                                               s["jqplan"], **kw),
                      port=0, log=SILENT)
    fe = HTTPFrontend(encoder=EncoderServeEngine(
        s["cfg"], s["qparams_from_jax"], s["qplan"], device="cpu", **kw),
        port=0, log=SILENT)
    theirs, ours = _encode_session(jfe), _encode_session(fe)
    assert [r[0] for r in ours] == [r[0] for r in theirs]
    assert [r[0] for r in ours][:4] == [200, 200, 200, 400]
    for (status, _, obj), (_, _, jobj) in zip(ours, theirs):
        assert sorted(obj) == sorted(jobj)
        if status == 200 and "logits" in obj:
            assert obj["prediction"] == jobj["prediction"]
            assert rel_linf(jobj["logits"], obj["logits"]) <= 5e-3
            assert obj["uid"] == jobj["uid"]
    assert ours[-3][2]["engines"] == theirs[-3][2]["engines"]


def test_decode_frontends_agree_with_jax(qw):  # noqa: F811
    """The JAX-quantized golden plan on reduced qwen2, carried across, over
    int8 per-token pages: the same statuses and keys, the same streamed
    tokens and transcripts, and 0 pages in use afterwards."""
    g = qw["golden"]
    kw = dict(batch_slots=2, max_len=48, page_size=8,
              kv_cache="int8_per_token")
    jfe = JaxFrontend(decode=JaxServeEngine(qw["jcfg"], g["jq"], g["jqplan"],
                                            precision=g["jplan"], **kw),
                      port=0, log=SILENT)
    engine = ServeEngine(qw["cfg"], g["q"], g["qplan"], precision=g["plan"],
                         device="cpu", **kw)
    fe = HTTPFrontend(decode=engine, port=0, log=SILENT)
    theirs, ours = _generate_session(jfe), _generate_session(fe)
    assert [r[0] for r in ours] == [r[0] for r in theirs]
    assert [r[0] for r in ours][:4] == [200, 200, 200, 400]
    for (status, headers, got), (_, jheaders, jgot) in zip(ours, theirs):
        assert headers.get("content-type") == jheaders.get("content-type")
        if isinstance(got, dict):
            assert sorted(got) == sorted(jgot)
            continue
        assert [e for e, _ in got] == [e for e, _ in jgot]
        for (_, d), (_, jd) in zip(got, jgot):
            assert sorted(d) == sorted(jd)
            assert d.get("token") == jd.get("token")
            assert d.get("tokens") == jd.get("tokens")
            assert d.get("finish_reason") == jd.get("finish_reason")
    assert engine.kv_pages_in_use == 0
