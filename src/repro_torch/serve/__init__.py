"""Serving (port of ``repro/serve/``): the continuous-batching engine over
the paged KV pool and its telemetry.  The router, the disaggregated
prefill/decode front and the cache channel come in a later slice (ROADMAP
queue A item 17)."""
from repro_torch.serve.engine import Completion, Request, ServeEngine
from repro_torch.serve.telemetry import (ServingLoad, ServingTelemetry,
                                         merge_loads)

__all__ = ["Completion", "Request", "ServeEngine", "ServingLoad",
           "ServingTelemetry", "merge_loads"]
