"""Minimal HTTP/1.1 + Server-Sent-Events wire layer over asyncio streams
(port of ``repro.serve.frontend.protocol``, stdlib only like its original;
every byte it writes is the original's).

Deliberately small instead of a framework dependency: the serving stack
stays stdlib-only (the toolkit's "easy to deploy" claim), and the whole
protocol surface the front-end needs is

* request parsing — request line, headers, ``Content-Length`` body
  (no chunked *request* bodies; inference payloads are one JSON object);
* fixed responses — status + headers + ``Content-Length`` body, always
  ``Connection: close`` (one request per connection keeps cancellation
  unambiguous: connection gone = client gone);
* SSE framing — ``event:``/``data:`` frames for token streaming, where
  the body ends at connection close (legal for ``Connection: close``
  responses, so no chunked encoding is needed).

:func:`parse_sse` is the client-side inverse, shared by clients and the
tests.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 8 * 1024 * 1024

REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 408: "Request Timeout",
           413: "Payload Too Large", 429: "Too Many Requests",
           431: "Request Header Fields Too Large",
           500: "Internal Server Error", 503: "Service Unavailable",
           504: "Gateway Timeout"}


class ProtocolError(Exception):
    """Malformed request; carries the HTTP status to answer with."""

    def __init__(self, status: int, reason: str):
        super().__init__(reason)
        self.status = status
        self.reason = reason


@dataclasses.dataclass
class HTTPRequest:
    method: str
    path: str
    headers: dict[str, str]
    body: bytes

    def json(self) -> dict:
        try:
            obj = json.loads(self.body.decode("utf-8") or "{}")
        except (ValueError, UnicodeDecodeError) as e:
            raise ProtocolError(400, f"invalid JSON body: {e}") from None
        if not isinstance(obj, dict):
            raise ProtocolError(400, "JSON body must be an object")
        return obj


async def read_request(reader) -> Optional[HTTPRequest]:
    """Parse one request off the stream; None on clean EOF (client closed
    without sending anything)."""
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin1").strip().split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise ProtocolError(400, "malformed request line")
    method, target = parts[0].upper(), parts[1]
    path = target.split("?", 1)[0]
    headers: dict[str, str] = {}
    total = 0
    while True:
        line = await reader.readline()
        if not line:
            raise ProtocolError(400, "truncated headers")
        total += len(line)
        if total > MAX_HEADER_BYTES:
            raise ProtocolError(431, "headers too large")
        if line in (b"\r\n", b"\n"):
            break
        key, sep, value = line.decode("latin1").partition(":")
        if not sep:
            raise ProtocolError(400, f"malformed header line {line!r}")
        headers[key.strip().lower()] = value.strip()
    try:
        n = int(headers.get("content-length", "0") or "0")
    except ValueError:
        raise ProtocolError(400, "bad Content-Length") from None
    if n > MAX_BODY_BYTES:
        raise ProtocolError(413, f"body exceeds {MAX_BODY_BYTES} bytes")
    body = await reader.readexactly(n) if n > 0 else b""
    return HTTPRequest(method, path, headers, body)


def response(status: int, body: bytes, *,
             content_type: str = "application/json",
             headers: Optional[dict] = None) -> bytes:
    head = [f"HTTP/1.1 {status} {REASONS.get(status, 'Unknown')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    for k, v in (headers or {}).items():
        head.append(f"{k}: {v}")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin1") + body


def json_response(status: int, obj, *,
                  headers: Optional[dict] = None) -> bytes:
    return response(status, (json.dumps(obj) + "\n").encode("utf-8"),
                    headers=headers)


def sse_preamble() -> bytes:
    """Response head for a token stream; the body is SSE frames and ends
    at connection close."""
    return (b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n")


def sse_event(event: str, data) -> bytes:
    return (f"event: {event}\ndata: {json.dumps(data)}\n\n").encode("utf-8")


def parse_sse(body: str) -> list[tuple[str, dict]]:
    """Client-side inverse of :func:`sse_event`: ``[(event, data), ...]``."""
    events = []
    for frame in body.split("\n\n"):
        name, data = "message", None
        for line in frame.splitlines():
            if line.startswith("event:"):
                name = line[len("event:"):].strip()
            elif line.startswith("data:"):
                data = json.loads(line[len("data:"):].strip())
        if data is not None:
            events.append((name, data))
    return events
