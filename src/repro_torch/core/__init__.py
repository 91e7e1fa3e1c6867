"""Portability core: backend policy, op registry and functors."""
from repro_torch.core.functor import (  # noqa: F401
    for_each_elementwise,
    for_each_rows,
    for_each_tiles,
    matrix_plus_vector_rows,
)
from repro_torch.core.policy import (  # noqa: F401
    Backend,
    current_backend,
    resolve_device,
    set_default_backend,
    use_backend,
    use_hopper,
)
from repro_torch.core.registry import coverage, get_op, list_ops  # noqa: F401
