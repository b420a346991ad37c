"""Serving (port of ``repro.serve``): the runtime, the schedulers, the
encoder engine, the token-level decode engine and the metrics surface. The
HTTP/SSE front-end (``repro_torch.serve.frontend``) is imported lazily, so
``import repro_torch.serve`` stays free of asyncio machinery."""
from repro_torch.serve.encoder import EncoderServeEngine
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.runtime import Runtime, bucket_size
from repro_torch.serve.scheduler import (EncoderRequest, MicroBatcher,
                                         PagePool, SlotScheduler)

__all__ = ["EncoderServeEngine", "EncoderRequest", "MicroBatcher", "PagePool",
           "Request", "Runtime", "ServeEngine", "SlotScheduler",
           "bucket_size"]
