"""Model components of the dense decoder (the port's subset of
``repro.models.components``).

Everything is built on the portable ops (``repro_torch.kernels.ops``), so
the model is single-source across the reference and hopper backends.
Parameters are plain dicts of tensors drawn from a ``torch.Generator`` with
the JAX package's shapes and scales.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Projection over the last axis via the portable matmul."""
    lead = x.shape[:-1]
    y = ops.matmul(x.reshape(-1, x.shape[-1]), w)
    if b is not None:
        y = ops.bias_add_rows(y, b)
    return y.reshape(*lead, w.shape[-1])


def norm(cfg: ArchConfig, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return ops.rmsnorm(x, w)


def rope_freqs(cfg: ArchConfig,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., head_dim//2), f32."""
    hd = cfg.head_dim_
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32,
                     device=positions.device) / hd
    ))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2).  Runs in f32,
    then casts back to ``x.dtype``."""
    x1, x2 = x.chunk(2, dim=-1)
    while cos.dim() < x.dim():
        cos, sin = cos[..., None, :], sin[..., None, :]  # broadcast over H
        if cos.dim() < x.dim():
            cos, sin = cos[None], sin[None]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_normal(gen: torch.Generator, shape, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in f32 on ``gen``'s device, then cast."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def init_attention(cfg: ArchConfig, gen: torch.Generator) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    s = 1.0 / math.sqrt(d)
    dt, dev = cfg.dtype_(), gen.device
    p = {
        "wq": init_normal(gen, (d, h * hd), s, dt),
        "wk": init_normal(gen, (d, hkv * hd), s, dt),
        "wv": init_normal(gen, (d, hkv * hd), s, dt),
        "wo": init_normal(gen, (h * hd, d), s, dt),
        "ln": torch.ones((d,), dtype=dt, device=dev),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dt, device=dev)
    return p


def init_mlp(cfg: ArchConfig, gen: torch.Generator) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    dt = cfg.dtype_()
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    return {
        "wg": init_normal(gen, (d, ff), s_in, dt),
        "wi": init_normal(gen, (d, ff), s_in, dt),
        "wo": init_normal(gen, (ff, d), s_out, dt),
        "ln": torch.ones((d,), dtype=dt, device=gen.device),
    }


def mlp_block(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm SwiGLU MLP with residual; SiLU in the working dtype."""
    xn = norm(cfg, p["ln"], x)
    h = F.silu(dense(xn, p["wg"])) * dense(xn, p["wi"])
    return x + dense(h, p["wo"])
