"""Serving: request queue, typed configuration, fault plans, drafters,
continuous-batching engine."""
from repro_torch.serving.config import (  # noqa: F401
    CacheConfig,
    EngineConfig,
    SpecConfig,
    configs_from_flags,
    from_kwargs,
    validate_configs,
)
from repro_torch.serving.drafter import (  # noqa: F401
    HybridSSMDrafter,
    PromptLookupDrafter,
    make_drafter,
)
from repro_torch.serving.engine import (  # noqa: F401
    RequestHandle,
    ServingEngine,
    SlotState,
    engine_step,
    init_slots,
    serve_all,
)
from repro_torch.serving.faults import FaultEvent, FaultPlan  # noqa: F401
from repro_torch.serving.pager import release_tail  # noqa: F401
from repro_torch.serving.queue import (  # noqa: F401
    QueueEmpty,
    QueueFullError,
    Request,
    RequestQueue,
)
