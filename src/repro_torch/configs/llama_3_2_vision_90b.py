"""llama-3.2-vision-90b [vlm] — cross-attention image layers.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,              # 80 self + 20 cross (every 5th is cross-attn)
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,              # GQA kv=8
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_vision_tokens=1601,      # (448/14)^2 + 1 patch embeddings (stub frontend)
    sub_quadratic=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
