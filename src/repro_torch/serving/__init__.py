"""Serving: request queue, typed configuration, fault plans,
continuous-batching engine."""
from repro_torch.serving.config import (  # noqa: F401
    CacheConfig,
    EngineConfig,
    configs_from_flags,
    validate_configs,
)
from repro_torch.serving.engine import (  # noqa: F401
    RequestHandle,
    ServingEngine,
    SlotState,
    engine_step,
    init_slots,
)
from repro_torch.serving.faults import FaultEvent, FaultPlan  # noqa: F401
from repro_torch.serving.queue import (  # noqa: F401
    QueueEmpty,
    QueueFullError,
    Request,
    RequestQueue,
)
