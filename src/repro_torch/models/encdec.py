"""Encoder-decoder family (the seamless-m4t-medium backbone; the port's
``repro.models.encdec``).

The audio frontend is a stub: ``frames`` are precomputed frame embeddings
(B, S_enc, d).  Encoder: a non-causal self-attention stack.  Decoder:
causal self-attention, cross-attention to the encoder's memory, and an
MLP, a layer each.  Where JAX scans over stacked layer params, the port
keeps lists of per-layer dicts, ``params["enc_layers"]`` and
``params["dec_layers"]``.  Serving keeps the contiguous slab only; the
decode caches ``k``/``v`` are written in place, as in ``lm``, and the
cross K/V ``xk``/``xv`` are projected once from the memory by
``prefill_cross_cache``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import components as C
from repro_torch.models.lm import (
    _chunk_attn_slab,
    _decode_attn_slab,
    _remat,
    _xent,
)


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random params with ``repro.models.encdec.init_params``'s shapes and
    scales, drawn from ``gen`` on its device: ``enc_layers``, a list of
    ``{"attn", "mlp"}`` dicts, and ``dec_layers``, of ``{"attn", "cross",
    "mlp"}`` dicts (the cross block has no gate)."""
    dt, dev = cfg.dtype_(), gen.device
    return {
        "embed": C.init_normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt),
        "enc_layers": [
            {"attn": C.init_attention(cfg, gen), "mlp": C.init_mlp(cfg, gen)}
            for _ in range(cfg.encoder_layers)
        ],
        "dec_layers": [
            {"attn": C.init_attention(cfg, gen),
             "cross": C.init_attention(cfg, gen),
             "mlp": C.init_mlp(cfg, gen)}
            for _ in range(cfg.n_layers)
        ],
        "ln_enc": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": C.init_normal(gen, (cfg.d_model, cfg.vocab_size),
                                 1.0 / math.sqrt(cfg.d_model), dt),
    }


def encode(cfg: ArchConfig, params, frames: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """The encoder's memory (B, S_enc, d), normed with ``ln_enc``.  With
    grad mode on and ``remat``, each layer runs under
    ``torch.utils.checkpoint``, as JAX checkpoints it."""
    x = frames.to(cfg.dtype_())
    pos = torch.arange(x.shape[1], device=x.device)

    def layer(x, p):
        x = C.attention_block(cfg, p["attn"], x, positions=pos,
                              causal=False)
        return C.mlp_block(cfg, p["mlp"], x)

    layer = _remat(layer, remat and torch.is_grad_enabled())
    for p in params["enc_layers"]:
        x = layer(x, p)
    return C.norm(cfg, params["ln_enc"], x)


def decode_train(cfg: ArchConfig, params, tokens: torch.Tensor,
                 memory: torch.Tensor, *, remat: bool = True) -> torch.Tensor:
    """The teacher-forced decoder over tokens (B, S) against ``memory``:
    the final-normed hidden states (B, S, d)."""
    x = params["embed"][tokens].to(cfg.dtype_())
    pos = torch.arange(x.shape[1], device=x.device)

    def layer(x, p):
        x = C.attention_block(cfg, p["attn"], x, positions=pos, causal=True)
        x = C.attention_block(cfg, p["cross"], x, kv_src=memory,
                              causal=False)
        return C.mlp_block(cfg, p["mlp"], x)

    layer = _remat(layer, remat and torch.is_grad_enabled())
    for p in params["dec_layers"]:
        x = layer(x, p)
    return C.norm(cfg, params["ln_f"], x)


def train_loss(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """Next-token loss of ``batch["tokens"]`` (B, S+1) given
    ``batch["frames"]``: the f32 NLL of the last S tokens."""
    memory = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    h = decode_train(cfg, params, tokens[:, :-1], memory)
    return _xent(C.dense(h, params["lm_head"]), tokens[:, 1:])


def prefill(cfg: ArchConfig, params, tokens: torch.Tensor,
            frames: torch.Tensor) -> torch.Tensor:
    """The last position's logits (B, V) of the teacher-forced pass: the
    encoder, the decoder and the head (JAX's ``build_model`` prefill)."""
    memory = encode(cfg, params, frames, remat=False)
    h = decode_train(cfg, params, tokens, memory, remat=False)
    return C.dense(h[:, -1], params["lm_head"])


# -- serving ---------------------------------------------------------------

def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      enc_len: int, *, per_row_pos: bool = False,
                      snapshots: bool = False, cache=None,
                      device: str | torch.device = "cuda"
                      ) -> Dict[str, torch.Tensor]:
    """Decode state on the contiguous slab: ``k``/``v`` ``(L, B, max_len,
    Hkv, hd)`` and the cross K/V ``xk``/``xv`` ``(L, B, enc_len, Hkv,
    hd)``, zero until ``prefill_cross_cache`` replaces them.
    ``per_row_pos=True`` keeps ``pos`` as a (B,) vector.  ``snapshots``
    is accepted for signature parity with ``lm`` and ignored (no recurrent
    state); a ``CacheConfig`` with a paged layout raises, as in JAX."""
    del snapshots
    if cache is not None and cache.layout != "contiguous":
        raise NotImplementedError(
            "encdec decode state is contiguous-only — "
            f"cache.layout {cache.layout!r} is not supported")
    dev = resolve_device(device)
    dt = cfg.dtype_()
    hkv, hd, n = cfg.n_kv_heads, cfg.head_dim_, cfg.n_layers
    state = {"pos": torch.zeros((batch,) if per_row_pos else (),
                                dtype=torch.int32, device=dev)}
    for key, s in (("k", max_len), ("v", max_len), ("xk", enc_len),
                   ("xv", enc_len)):
        state[key] = torch.zeros((n, batch, s, hkv, hd), dtype=dt,
                                 device=dev)
    return state


def reset_decode_rows(cfg: ArchConfig, state: Dict[str, torch.Tensor],
                      mask: torch.Tensor, start=0
                      ) -> Dict[str, torch.Tensor]:
    """Zero the masked rows' caches, the cross K/V included (a refilled
    slot serves a new utterance), in place, and put their decode clock at
    ``start``.  Requires per-row ``pos`` state; an unknown state key
    raises."""
    if state["pos"].dim() != 1:
        raise ValueError(
            "reset_decode_rows needs per_row_pos=True decode state")
    unknown = set(state) - {"pos", "k", "v", "xk", "xv"}
    if unknown:
        raise ValueError(
            f"reset_decode_rows: unhandled decode-state keys {sorted(unknown)}"
        )
    for key in ("k", "v", "xk", "xv"):
        t = state[key]                        # (L, B, S, Hkv, hd)
        t.masked_fill_(mask.view(1, -1, 1, 1, 1), 0)
    return {**state, "pos": torch.where(mask, start, state["pos"])}


def prefill_cross_cache(cfg: ArchConfig, params, memory: torch.Tensor,
                        state):
    """The cross K/V of every decoder layer from ``memory`` (B, S_enc, d):
    new ``xk``/``xv`` ``(L, B, S_enc, Hkv, hd)`` in place of the state's,
    as JAX replaces them."""
    b, s = memory.shape[:2]
    xk = torch.empty((cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim_),
                     dtype=cfg.dtype_(), device=memory.device)
    xv = torch.empty_like(xk)
    for i, p in enumerate(params["dec_layers"]):
        k, v = C.cross_kv(cfg, p["cross"], memory)
        xk[i].copy_(k)
        xv[i].copy_(v)
    return {**state, "xk": xk, "xv": xv}


def prefill_chunk(cfg: ArchConfig, params, state, toks: torch.Tensor,
                  width, *, active: Optional[torch.Tensor] = None,
                  cow: bool = False, snap_every: int = 0):
    """Ingest up to C prompt tokens per row (``lm.prefill_chunk``'s
    contract): causal self-attention through the chunk kernel over the
    cache, and cross-attention through the same kernel with every row
    anchored at ``start = enc_len - 1``, ``width = 1``, so each of the C
    query rows sees the whole memory.  Returns the logits at each row's
    last real position and the state with ``pos`` advanced by ``width``
    for active rows.  ``cow``/``snap_every`` are accepted for signature
    parity and do nothing (no shared pages, no recurrent state)."""
    del cow, snap_every
    pos = state["pos"]
    if pos.dim() != 1:
        raise ValueError("prefill_chunk needs per_row_pos=True decode state")
    b, c = toks.shape
    dev = toks.device
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)
    width = torch.as_tensor(width, device=dev).to(torch.int32).reshape(
        -1).expand(b).clamp(1, c)
    x = params["embed"].index_select(0, toks.reshape(-1)).reshape(
        b, c, -1).to(cfg.dtype_())
    offs = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    posmat = pos[:, None] + offs
    valid = active[:, None] & (offs < width[:, None])
    enc_len = state["xk"].shape[2]
    enc_start = torch.full((b,), enc_len - 1, dtype=torch.int32, device=dev)
    enc_one = torch.ones((b,), dtype=torch.int32, device=dev)
    cos, sin = C.rope_freqs(cfg, posmat)
    for i, p in enumerate(params["dec_layers"]):
        x = _chunk_attn_slab(cfg, p["attn"], x, state["k"][i],
                             state["v"][i], cos, sin, posmat, valid, pos,
                             width)
        a = p["cross"]
        q = C.dense(C.norm(cfg, a["ln"], x), a["wq"]).reshape(
            b, c, cfg.n_heads, cfg.head_dim_)
        o = ops.attention_prefill_chunk(q, state["xk"][i], state["xv"][i],
                                        enc_start, enc_one)
        x = x + C.dense(o.reshape(b, c, -1), a["wo"])
        x = C.mlp_block(cfg, p["mlp"], x)
    last = x.gather(1, (width.long() - 1)[:, None, None].expand(
        b, 1, x.shape[-1]))[:, 0]
    logits = C.dense(C.norm(cfg, params["ln_f"], last), params["lm_head"])
    return logits, {**state, "pos": pos + torch.where(active, width, 0)}


def decode_step(cfg: ArchConfig, params, state, token: torch.Tensor, *,
                active: Optional[torch.Tensor] = None, cow: bool = False,
                snap_every: int = 0):
    """One token for every row: causal self-attention through the cache
    (written in place), cross-attention over the memory's K/V (every key,
    a scalar length), the MLP, then the head.  ``state["pos"]`` is a scalar
    or, with ``active`` masking idle rows, a (B,) vector, as in
    ``lm.decode_step``.  ``cow``/``snap_every``: signature parity."""
    del cow, snap_every
    pos = state["pos"]
    x = params["embed"].index_select(0, token).to(cfg.dtype_())
    rope_pos = pos[..., None] if pos.dim() == 1 else pos[None]
    cos, sin = C.rope_freqs(cfg, rope_pos)
    if active is not None and pos.dim() == 1:
        w_idx = torch.where(active, pos, -1)
    else:
        w_idx = pos
    cache_len = pos + 1
    enc_len = torch.full((), state["xk"].shape[2], dtype=torch.int32,
                         device=x.device)
    for i, p in enumerate(params["dec_layers"]):
        x = _decode_attn_slab(cfg, p["attn"], x, state["k"][i],
                              state["v"][i], cos, sin, w_idx, cache_len)
        x = C.cross_decode(cfg, p["cross"], x, state["xk"][i],
                           state["xv"][i], enc_len)
        x = C.mlp_block(cfg, p["mlp"], x)
    logits = C.dense(C.norm(cfg, params["ln_f"], x), params["lm_head"])
    if active is not None and pos.dim() == 1:
        new_pos = pos + active.to(torch.int32)
    else:
        new_pos = pos + 1
    return logits, {**state, "pos": new_pos}
