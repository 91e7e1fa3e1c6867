"""seamless-m4t-medium [audio] — enc-dec backbone; the modality frontend is
a stub (the caller passes precomputed frame embeddings).
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,               # decoder layers
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    sub_quadratic=False,
    source="arXiv:2308.11596; hf",
)
