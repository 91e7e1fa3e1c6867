"""Decoder-only LM, dense family, contiguous KV cache (the port's subset of
``repro.models.lm``).

Public functions mirror the JAX module: ``init_params``,
``init_decode_state``, ``decode_step``, ``reset_decode_rows`` and
``lm_logits``.  Where JAX scans over stacked layer params, the port keeps a
list of per-layer dicts and loops in Python.  JAX's functions are pure; the
port updates the decode caches **in place** (``decode_step`` and
``reset_decode_rows`` write into ``state["k"]``/``state["v"]`` and return a
dict that shares them), which saves a full rewrite of the cache slab on
every step.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import components as C


def check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: this slice of the port serves the dense "
            "family only (moe, ssm, hybrid, vlm, encdec come with later slices)"
        )


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random params with ``repro.models.lm.init_params``'s shapes and
    scales, drawn from ``gen`` on its device.  ``params["layers"]`` is a
    list of ``{"attn": ..., "mlp": ...}`` dicts (JAX stacks them)."""
    check_family(cfg)
    dt = cfg.dtype_()
    params: Dict[str, Any] = {
        "embed": C.init_normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt),
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = C.init_normal(
            gen, (cfg.d_model, cfg.vocab_size), 1.0 / math.sqrt(cfg.d_model),
            dt,
        )
    params["layers"] = [
        {"attn": C.init_attention(cfg, gen), "mlp": C.init_mlp(cfg, gen)}
        for _ in range(cfg.n_layers)
    ]
    return params


def lm_logits(cfg: ArchConfig, params, h: torch.Tensor) -> torch.Tensor:
    # the tied head is the (d, vocab) transposed *view* of the embedding;
    # the gemm kernel reads it by its strides, so nothing is copied
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return C.dense(h, w)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      per_row_pos: bool = False,
                      device: str | torch.device = "cuda"
                      ) -> Dict[str, torch.Tensor]:
    """Contiguous decode caches ``(layers, B, max_len, Hkv, hd)``.
    ``per_row_pos=True`` keeps ``pos`` as a (B,) vector so rows may sit at
    different depths (continuous batching)."""
    check_family(cfg)
    dev = resolve_device(device)
    dt = cfg.dtype_()
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    # sliding-window archs only ever need `window` cache slots (ring buffer)
    eff = min(max_len, cfg.window) if cfg.window else max_len
    shape = (cfg.n_layers, batch, eff, hkv, hd)
    return {
        "pos": torch.zeros((batch,) if per_row_pos else (), dtype=torch.int32,
                           device=dev),
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
    }


def _cache_index(cfg: ArchConfig, pos: torch.Tensor) -> torch.Tensor:
    return pos % cfg.window if cfg.window else pos


def _cache_update(cache: torch.Tensor, new: torch.Tensor,
                  idx: torch.Tensor) -> None:
    """Write one token's K/V per row at ``idx`` into a (B, S, Hkv, hd)
    cache, in place.

    JAX writes with ``jnp.where(pos_iota == idx)``, so a row whose index
    matches no slot (``idx = -1`` marks inactive rows) is dropped.  A torch
    index of -1 would wrap to the last slot, so the mask comes first: rows
    outside ``[0, S)`` scatter back the value they already hold.
    """
    b, s = cache.shape[:2]
    idx = idx.reshape(-1).expand(b).long()
    keep = (idx >= 0) & (idx < s)
    slot = idx.clamp(0, s - 1).view(b, 1, 1, 1).expand(b, 1, *cache.shape[2:])
    old = cache.gather(1, slot)
    val = torch.where(keep.view(b, 1, 1, 1), new[:, None].to(cache.dtype), old)
    cache.scatter_(1, slot, val)


def decode_step(
    cfg: ArchConfig, params, state, token: torch.Tensor,   # (B,) int
    *, active: Optional[torch.Tensor] = None,               # (B,) bool
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token for every sequence in the batch; returns (logits, state).

    ``state["pos"]`` may be a scalar (all rows in lockstep) or a (B,) vector
    (rows at independent depths).  ``active`` (per-row ``pos`` only) masks
    rows that are between requests: their caches are not written and their
    ``pos`` does not advance.  The caches are updated in place.
    """
    pos = state["pos"]
    x = params["embed"].index_select(0, token).to(cfg.dtype_())   # (B, d)
    idx = _cache_index(cfg, pos)
    if cfg.window:
        cache_len = torch.clamp(pos + 1, max=cfg.window)
    else:
        cache_len = pos + 1
    rope_pos = pos[..., None] if pos.dim() == 1 else pos[None]
    # inactive rows are routed to slot -1, which _cache_update drops
    if active is not None and idx.dim() == 1:
        w_idx = torch.where(active, idx, -1)
    else:
        w_idx = idx
    b = x.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    # one rotation for all layers (JAX recomputes it inside the scan body)
    cos, sin = C.rope_freqs(cfg, rope_pos)

    for layer, p in enumerate(params["layers"]):
        a = p["attn"]
        xn = C.norm(cfg, a["ln"], x)
        q = C.dense(xn, a["wq"], a.get("bq")).reshape(b, 1, cfg.n_heads, hd)
        k_new = C.dense(xn, a["wk"], a.get("bk")).reshape(b, 1, hkv, hd)
        v_new = C.dense(xn, a["wv"], a.get("bv")).reshape(b, hkv, hd)
        q = C.apply_rope(q, cos, sin).reshape(b, cfg.n_heads, hd)
        k_new = C.apply_rope(k_new, cos, sin).reshape(b, hkv, hd)
        ck, cv = state["k"][layer], state["v"][layer]
        _cache_update(ck, k_new, w_idx)
        _cache_update(cv, v_new, w_idx)
        o = ops.attention_decode(q, ck, cv, cache_len)
        x = x + C.dense(o.reshape(b, -1), a["wo"])
        x = C.mlp_block(cfg, p["mlp"], x)

    x = C.norm(cfg, params["ln_f"], x)
    logits = lm_logits(cfg, params, x)
    if active is not None and pos.dim() == 1:
        new_pos = pos + active.to(torch.int32)
    else:
        new_pos = pos + 1
    return logits, {**state, "pos": new_pos}


def reset_decode_rows(
    cfg: ArchConfig, state: Dict[str, torch.Tensor],
    mask: torch.Tensor,                                   # (B,) bool
    start=0,                                              # () or (B,) int
) -> Dict[str, torch.Tensor]:
    """Zero the caches of the rows selected by ``mask`` (in place) and put
    their decode clock at ``start`` — the serving engine's slot refill.
    Requires per-row ``pos`` state."""
    if state["pos"].dim() != 1:
        raise ValueError(
            "reset_decode_rows needs per_row_pos=True decode state"
        )
    unknown = set(state) - {"pos", "k", "v"}
    if unknown:
        # a silently skipped cache key would leak the previous request's
        # state into the slot's next occupant
        raise ValueError(
            f"reset_decode_rows: unhandled decode-state keys {sorted(unknown)}"
        )
    for key in ("k", "v"):
        state[key].masked_fill_(mask.view(1, -1, 1, 1, 1), 0)
    return {**state, "pos": torch.where(mask, start, state["pos"])}
