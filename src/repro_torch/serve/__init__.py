"""Serving (port of ``repro/serve/``): the continuous-batching engine over
the paged KV pool and its telemetry, the multi-GMI request router
(``router.py``) and the disaggregated prefill/decode front with its
migration planner (``disagg.py``), whose cache channel is
``core/channels.py::CacheChannel``."""
from repro_torch.serve.disagg import (CachePayload, DisaggFront,
                                      MigrationPlanner, PrefillEngine)
from repro_torch.serve.engine import Completion, Request, ServeEngine
from repro_torch.serve.router import RequestRouter, ServingRole
from repro_torch.serve.telemetry import (ServingLoad, ServingTelemetry,
                                         merge_loads)

__all__ = [
    "Completion", "Request", "ServeEngine",
    "RequestRouter", "ServingRole",
    "CachePayload", "DisaggFront", "MigrationPlanner", "PrefillEngine",
    "ServingLoad", "ServingTelemetry", "merge_loads",
]
