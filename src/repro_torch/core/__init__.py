"""Portability core: backend policy and op registry."""
from repro_torch.core.policy import (  # noqa: F401
    Backend,
    current_backend,
    resolve_device,
    set_default_backend,
    use_backend,
    use_hopper,
)
from repro_torch.core.registry import coverage, get_op, list_ops  # noqa: F401
