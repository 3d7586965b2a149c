"""Continuous-batching serving (torch counterpart of `repro.serving`)."""

from repro_torch.serving.engine import (  # noqa: F401
    EngineConfig,
    EngineReport,
    FinishedRequest,
    ServeEngine,
    serve_requests,
)
from repro_torch.serving.requests import (  # noqa: F401
    Request,
    RequestQueue,
    synthetic_trace,
)
