"""Architecture configurations (JAX-free copies of ``repro.configs``)."""
from repro_torch.configs.base import ArchConfig  # noqa: F401
from repro_torch.configs.registry import arch_ids, get_arch  # noqa: F401
