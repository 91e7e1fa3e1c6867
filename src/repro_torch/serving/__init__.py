"""Serving: request queue, typed configuration, continuous-batching engine."""
from repro_torch.serving.config import (  # noqa: F401
    CacheConfig,
    EngineConfig,
    configs_from_flags,
    validate_configs,
)
from repro_torch.serving.engine import (  # noqa: F401
    ServingEngine,
    SlotState,
    engine_step,
    init_slots,
)
from repro_torch.serving.queue import Request, RequestQueue  # noqa: F401
