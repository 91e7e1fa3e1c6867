"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    n_experts=8,
    top_k=2,
    window=4096,               # SWA -> sub-quadratic -> runs long_500k
    rope_theta=1_000_000.0,
    sub_quadratic=True,
    source="arXiv:2401.04088; hf",
)
