"""Architecture configuration schema (the port's copy of ``repro.configs.base``).

``ArchConfig`` holds the same fields with the same defaults as the JAX
package's, so a configuration can be compared field for field; ``dtype_()``
returns a torch dtype and ``reduced()`` derives the same tiny smoke variant.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # attention details
    head_dim: int = 0              # 0 -> d_model // n_heads
    window: Optional[int] = None   # sliding-window attention
    qkv_bias: bool = False         # qwen2.5
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # hybrid: one shared attention block applied every N layers
    attn_every: int = 0
    # enc-dec
    encoder_layers: int = 0
    # vlm: cross-attention every N layers
    cross_attn_every: int = 0
    n_vision_tokens: int = 0
    # norm / misc
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    sub_quadratic: bool = False
    source: str = ""

    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:       # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def dtype_(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests (f32)."""
        small = dict(
            dtype="float32",
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads))
            if self.n_heads
            else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=128,
            head_dim=16,
        )
        if self.n_experts:
            small.update(n_experts=4, top_k=min(2, self.top_k))
        if self.ssm_state:
            small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.attn_every:
            small.update(attn_every=2, n_layers=4)
        if self.encoder_layers:
            small.update(encoder_layers=2)
        if self.cross_attn_every:
            small.update(cross_attn_every=2, n_layers=4, n_vision_tokens=8)
        if self.window:
            small["window"] = 32
        return dataclasses.replace(self, name=self.name + "-smoke", **small)
