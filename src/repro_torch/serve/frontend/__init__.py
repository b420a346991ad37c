"""Async HTTP/SSE serving front-end over the engines (port of
``repro.serve.frontend``: the transport half of the engine/transport split,
see docs/http-serving.md)."""
from repro_torch.serve.frontend.driver import (EngineDriver, FrontendRequest,
                                               RequestError)
from repro_torch.serve.frontend.server import HTTPFrontend

__all__ = ["HTTPFrontend", "EngineDriver", "FrontendRequest",
           "RequestError"]
