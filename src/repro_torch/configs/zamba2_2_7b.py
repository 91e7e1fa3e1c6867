"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,               # mamba2 blocks
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,             # MHA in the shared block
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    attn_every=6,              # one shared attn+mlp block every 6 mamba blocks
    sub_quadratic=True,        # hybrid: runs long_500k
    source="arXiv:2411.15242; hf",
)
