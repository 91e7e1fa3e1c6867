"""Model zoo (dense family for now): components, the LM and the facade."""
from repro_torch.models.model import Model, build_model  # noqa: F401
