"""Online serving, twin of `repro.serving`: the SONAR gateway, its
front-ends, and the model-execution engine.

- `repro_torch.serving.gateway`    — `SonarGateway`: batch routing over the
  engines with telemetry feed-forward, health ejection, chunked load-aware
  routing, and an optional device telemetry ring.
- `repro_torch.serving.engine`     — `ServeEngine`: slot-based continuous
  batching for the model-execution side.
- `repro_torch.serving.microbatch` — deadline-aware micro-batching
  (`BatchingPolicy`, `MicroBatcher`) and the virtual-time `MicroBatchPump`.
- `repro_torch.serving.frontend`   — `AsyncServingGateway`: the same policy
  on the asyncio event loop.
"""
from repro_torch.serving.frontend import AsyncServingGateway
from repro_torch.serving.gateway import SonarGateway, replica_pool
from repro_torch.serving.microbatch import (
    BatchingPolicy,
    MicroBatcher,
    MicroBatchPump,
    PumpReport,
    ServeResult,
)

__all__ = [
    "AsyncServingGateway",
    "BatchingPolicy",
    "MicroBatchPump",
    "MicroBatcher",
    "PumpReport",
    "ServeResult",
    "SonarGateway",
    "replica_pool",
]
