"""Model components of the dense decoder, the MoE block and the Mamba-2
block (the port's subset of ``repro.models.components``).

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


def attention_block(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Pre-norm self-attention with residual over a whole sequence
    x (B, S, d): RoPE at ``positions`` (default ``0 .. S-1``), then the
    flash-attention forward."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    xn = norm(cfg, p["ln"], x)
    q = dense(xn, p["wq"], p.get("bq")).reshape(b, s, h, hd)
    k = dense(xn, p["wk"], p.get("bk")).reshape(b, s, hkv, hd)
    v = dense(xn, p["wv"], p.get("bv")).reshape(b, s, hkv, hd)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    cos, sin = rope_freqs(cfg, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = ops.attention(q, k, v, causal=causal, window=window)
    return x + dense(o.reshape(b, s, h * hd), p["wo"])


# ---------------------------------------------------------------------------
# MoE (top-k routing, capacity-based dispatch), single device
# ---------------------------------------------------------------------------

def init_moe(cfg: ArchConfig, gen: torch.Generator) -> Params:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.dtype_()
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    return {
        "router": init_normal(gen, (d, e), s_in, torch.float32),
        "wg": init_normal(gen, (e, d, ff), s_in, dt),
        "wi": init_normal(gen, (e, d, ff), s_in, dt),
        "wo": init_normal(gen, (e, ff, d), s_out, dt),
        "ln": torch.ones((d,), dtype=dt, device=gen.device),
    }


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: descending, and of equal
    values the lower index first (``torch.topk`` promises no tie order, a
    stable sort does)."""
    idx = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
    return probs.gather(-1, idx), idx


def _bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert product (E, c, K) @ (E, K, N) in the promoted dtype, as
    JAX's einsum promotes mixed inputs."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.bmm(a.to(dt), w.to(dt))


def moe_block(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Token-drop capacity MoE with residual over x (B, S, d)
    (``repro.models.components.moe_block`` with one token group).

    The router runs in f32: softmax, top-k of the probabilities (JAX's
    tie order), gates renormalized over the k picks.  Every one of the
    B*S tokens, padding and idle rows included, takes a rank in its
    experts' queues by a cumsum of one-hots in flattened (token, k)
    order; ranks past ``ceil(t * k / e * capacity_factor)`` are dropped
    (they add exact zeros into the last slot).  The expert SwiGLU runs
    as batched products over the (E, capacity, d) buffer, outside the
    kernels as in JAX; the combine gathers each pick's output, weighted
    by its gate and summed over k."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xn = norm(cfg, p["ln"], x).reshape(t, d)
    logits = torch.matmul(xn.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, k)                          # (t, k)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    cap = max(1, int(math.ceil(t * k / e * cfg.capacity_factor)))

    flat_e = idx.reshape(t * k)
    # one-hots by comparison: F.one_hot validates its input on the host
    onehot = (flat_e[:, None] == torch.arange(e, device=x.device)).long()
    ranks = torch.cumsum(onehot, dim=0) - onehot
    rank = ranks.gather(1, flat_e[:, None])[:, 0]
    keep = rank < cap
    rank_c = rank.clamp(max=cap - 1)
    tok = torch.arange(t * k, device=x.device) // k
    keep_x = keep[:, None].to(xn.dtype)
    # JAX's buf.at[flat_e, rank_c].add: kept picks own distinct slots, so
    # the adds are exact in any order
    buf = torch.zeros((e * cap, d), dtype=xn.dtype, device=x.device)
    buf.index_add_(0, flat_e * cap + rank_c, xn[tok] * keep_x)
    buf = buf.view(e, cap, d)
    h = (F.silu(_bmm(buf, p["wg"]).to(xn.dtype))
         * _bmm(buf, p["wi"]).to(xn.dtype))
    out_e = _bmm(h, p["wo"]).to(xn.dtype)                  # (E, cap, d)
    pulled = out_e[flat_e, rank_c] * keep_x                # (t*k, d)
    combined = (pulled.reshape(t, k, d)
                * gates[..., None].to(xn.dtype)).sum(dim=1)
    return x + combined.reshape(b, s, d)


# ---------------------------------------------------------------------------
# Mamba-2 block (conv1d + SSD): whole sequence, chunk and decode
# ---------------------------------------------------------------------------

def init_mamba(cfg: ArchConfig, gen: torch.Generator) -> Params:
    d, di = cfg.d_model, cfg.d_inner
    n, h = cfg.ssm_state, cfg.ssm_heads
    dt, dev = cfg.dtype_(), gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        # in_proj emits [z (di), x (di), B (n), C (n), dt (h)]
        "w_in": init_normal(gen, (d, 2 * di + 2 * n + h),
                            1.0 / math.sqrt(d), dt),
        "conv_w": init_normal(gen, (cfg.ssm_conv, di), 0.1, dt),
        "a_log": torch.zeros((h,), **f32),
        "d_skip": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "w_out": init_normal(gen, (di, d), 1.0 / math.sqrt(di), dt),
        "ln": torch.ones((d,), dtype=dt, device=dev),
        "ln_inner": torch.ones((di,), dtype=dt, device=dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, x (B, S, di), w (K, di): the K shifted
    products summed left to right in the storage dtype."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i: i + x.shape[1]] * w[i][None, None, :]
               for i in range(k))


def _split_mamba_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    """Column views of the in_proj output (nothing is copied; the SSD
    kernel reads B and C by their strides)."""
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di: 2 * di]
    b_ = zxbcdt[..., 2 * di: 2 * di + n]
    c_ = zxbcdt[..., 2 * di + n: 2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xs, b_, c_, dt


def _mamba_out(cfg: ArchConfig, p: Params, x: torch.Tensor, y, xs, z):
    """Skip term, gate, inner norm and out projection with residual:
    ``y + xs * d_skip`` promotes to f32 and is cast after ``* silu(z)``."""
    b, s = x.shape[:2]
    h, hd = cfg.ssm_heads, cfg.ssm_head_dim
    y = y + xs.reshape(b, s, h, hd) * p["d_skip"][None, None, :, None]
    y = (y.reshape(b, s, cfg.d_inner) * F.silu(z)).to(x.dtype)
    y = ops.rmsnorm(y, p["ln_inner"])
    return x + dense(y, p["w_out"])


def mamba_block(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Mamba-2 block with residual over a whole sequence x (B, S, d), from
    a zero state."""
    b, s, _ = x.shape
    n, h, hd = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xn = norm(cfg, p["ln"], x)
    z, xs, b_, c_, dt = _split_mamba_proj(cfg, dense(xn, p["w_in"]))
    xs = F.silu(_causal_conv(xs, p["conv_w"]))
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y = ops.ssd_scan(xs.reshape(b, s, h, hd), dt, a,
                     b_.reshape(b, s, 1, n), c_.reshape(b, s, 1, n),
                     chunk=cfg.ssm_chunk)
    return _mamba_out(cfg, p, x, y, xs, z)


def mamba_prefill_block(cfg: ArchConfig, p: Params, x: torch.Tensor,
                        ssm_state: torch.Tensor, conv_state: torch.Tensor,
                        valid: torch.Tensor,
                        ssm_out: Optional[torch.Tensor] = None):
    """Chunked Mamba-2 block with carried state
    (``repro.models.components.mamba_prefill_block``): x (B, C, d),
    ssm_state (B, H, P, N) f32, conv_state (B, K-1, di), valid (B, C) a
    prefix mask of real tokens.  A padding position's ``dt`` is zeroed
    (an exact no-op on the SSD state) and the new conv window ends at each
    row's last real token, so a row with no real tokens carries both
    states through bit for bit.  Returns (x, ssm_state, conv_state); the
    conv state is a new tensor, and so is the SSD state unless ``ssm_out``
    (which may be ``ssm_state`` itself) is given to receive it."""
    b, c, _ = x.shape
    n, h, hd = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    k = cfg.ssm_conv
    xn = norm(cfg, p["ln"], x)
    z, xs, b_, c_, dt = _split_mamba_proj(cfg, dense(xn, p["w_in"]))
    # position i of the chunk reads raw inputs i-K+1 .. i, reaching into
    # the carried window for i < K-1
    win = torch.cat([conv_state, xs], dim=1)              # (B, K-1+C, di)
    xs = sum(win[:, i: i + c] * p["conv_w"][i][None, None, :]
             for i in range(k))
    # the last K-1 inputs up to each row's width (width 0 gathers the old
    # window verbatim)
    width = valid.sum(dim=1)                               # (B,)
    gidx = width[:, None] + torch.arange(k - 1, device=x.device)[None, :]
    conv_state = win.gather(1, gidx[:, :, None].expand(b, k - 1,
                                                       win.shape[2]))
    xs = F.silu(xs)
    dt = F.softplus(dt.float() + p["dt_bias"])
    dt = torch.where(valid[:, :, None], dt, 0.0)          # padding: no-op
    a = -torch.exp(p["a_log"])
    y, ssm_state = ops.ssd_prefill_chunk(
        xs.reshape(b, c, h, hd), dt, a, b_.reshape(b, c, 1, n),
        c_.reshape(b, c, 1, n), ssm_state, chunk=cfg.ssm_chunk, out=ssm_out)
    return _mamba_out(cfg, p, x, y, xs, z), ssm_state, conv_state


def mamba_decode_block(cfg: ArchConfig, p: Params, x: torch.Tensor,
                       ssm_state: torch.Tensor, conv_state: torch.Tensor,
                       valid: Optional[torch.Tensor] = None,
                       ssm_out: Optional[torch.Tensor] = None):
    """Single-token decode, the C = 1 case of ``mamba_prefill_block``;
    ``valid`` (B, 1) marks live rows (None: all)."""
    if valid is None:
        valid = torch.ones((x.shape[0], 1), dtype=torch.bool,
                           device=x.device)
    y, ssm_state, conv_state = mamba_prefill_block(
        cfg, p, x[:, None], ssm_state, conv_state, valid, ssm_out)
    return y[:, 0], ssm_state, conv_state
