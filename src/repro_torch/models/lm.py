"""Decoder-only LM: the dense, moe, ssm (Mamba-2) and hybrid (Zamba2)
families, contiguous or paged KV cache, the paged pool in the model's
dtype, bf16 or int8 (the port's subset of ``repro.models.lm``).

Public functions mirror the JAX module: ``init_params``, ``forward``,
``train_loss``, ``init_decode_state``, ``decode_step``, ``prefill_chunk``,
``reset_decode_rows`` and ``lm_logits``.  Where JAX scans over stacked
layer params, the port keeps lists of per-layer dicts and loops in
Python: ``params["layers"]`` (dense, moe, ssm) or ``params["groups"]``,
``g`` lists of ``attn_every`` Mamba layers each followed by the shared
attention and MLP block (hybrid).  JAX's functions are pure; the port
updates the KV caches and page pools **in place** (``decode_step``,
``prefill_chunk`` and ``reset_decode_rows`` write into
``state["k"]``/``state["v"]`` or ``state["kp"]``/``state["vp"]`` (and an
int8 pool's scales ``state["ksc"]``/``state["vsc"]``) and return a dict
that shares them), which saves a full rewrite of the cache on every
step; the recurrent ``ssm``/``conv`` states are written layer by layer
into their stacks the same way.  The small allocator tensors (block
table, free list, refcounts) are replaced, as in JAX.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import (
    current_backend,
    resolve_device,
    use_backend,
)
from repro_torch.kernels import ops
from repro_torch.models import components as C
from repro_torch.serving import pager as PG


FAMILIES = ("dense", "moe", "ssm", "hybrid")
KV_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves {', '.join(FAMILIES)} "
            "(vlm, encdec come with later slices)"
        )


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random params with ``repro.models.lm.init_params``'s shapes and
    scales, drawn from ``gen`` on its device.  ``params["layers"]`` is a
    list of ``{"attn": ..., "mlp": ...}`` (dense), ``{"attn": ...,
    "moe": ...}`` (moe) or ``{"mamba": ...}`` (ssm) dicts; hybrid has
    ``params["groups"]``, ``g`` lists of ``attn_every`` ``{"mamba": ...}``
    dicts, and the unstacked ``shared_attn`` and ``shared_mlp`` (JAX
    stacks the layers)."""
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
    if cfg.family == "dense":
        params["layers"] = [
            {"attn": C.init_attention(cfg, gen), "mlp": C.init_mlp(cfg, gen)}
            for _ in range(cfg.n_layers)
        ]
    elif cfg.family == "moe":
        params["layers"] = [
            {"attn": C.init_attention(cfg, gen), "moe": C.init_moe(cfg, gen)}
            for _ in range(cfg.n_layers)
        ]
    elif cfg.family == "ssm":
        params["layers"] = [{"mamba": C.init_mamba(cfg, gen)}
                            for _ in range(cfg.n_layers)]
    else:
        params["groups"] = [
            [{"mamba": C.init_mamba(cfg, gen)}
             for _ in range(cfg.attn_every)]
            for _ in range(cfg.n_layers // cfg.attn_every)
        ]
        params["shared_attn"] = C.init_attention(cfg, gen)
        params["shared_mlp"] = C.init_mlp(cfg, gen)
    return params


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            remat: bool = True) -> torch.Tensor:
    """Teacher-forced forward over tokens (B, S) from empty caches: the
    final-normed hidden states (B, S, d) (``repro.models.lm.forward``).
    With grad mode on and ``remat``, each layer (and, hybrid, each group
    too) runs under ``torch.utils.checkpoint``, as JAX checkpoints them:
    only the layer inputs are kept, and the backward runs each layer's
    forward again.  Nothing here writes in place into a tensor autograd
    saved (the caches of the serving functions are not touched)."""
    check_family(cfg)
    x = params["embed"][tokens].to(cfg.dtype_())
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _trunk(
        cfg, params, x,
        lambda p, x, _: C.attention_block(cfg, p, x, positions=positions,
                                          window=cfg.window),
        lambda p, x, _: C.mamba_block(cfg, p, x),
        remat=remat and torch.is_grad_enabled())
    return C.norm(cfg, params["ln_f"], x)


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Stable mean NLL in f32 over (..., V) logits
    (``repro.models.lm._xent``)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = lf.gather(-1, targets[..., None].long())[..., 0]
    return (lse - picked).mean()


def train_loss(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """Next-token loss of ``batch["tokens"]`` (B, S+1): the forward over
    the first S tokens, the head, and the f32 NLL of the last S."""
    tokens = batch["tokens"]
    h = forward(cfg, params, tokens[:, :-1])
    return _xent(lm_logits(cfg, params, h), tokens[:, 1:])


def lm_logits(cfg: ArchConfig, params, h: torch.Tensor) -> torch.Tensor:
    # the tied head is the (d, vocab) transposed *view* of the embedding;
    # the gemm kernel reads it by its strides, so nothing is copied
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return C.dense(h, w)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      per_row_pos: bool = False,
                      layout: str = "contiguous", page_size: int = 16,
                      n_pages: Optional[int] = None, kv_dtype: str = "f32",
                      cache=None, device: str | torch.device = "cuda"
                      ) -> Dict[str, torch.Tensor]:
    """Decode caches: the contiguous slab ``(stacks, B, max_len, Hkv, hd)``,
    or (``layout="paged"``) page pools ``(stacks, n_pages + 1, page_size,
    Hkv, hd)`` with the allocator state (``repro_torch.serving.pager``; the
    trailing page is the write-drop sentinel).  ``stacks`` is the layer
    count (dense, moe) or the group count (hybrid: one KV cache per
    application of the shared block).  ``kv_dtype`` (paged only) is the
    pools' storage: ``"f32"`` the model's dtype, ``"bf16"``, or ``"int8"``
    with f32 per-(page, head) scale pools ``ksc``/``vsc`` ``(stacks,
    n_pages + 1, Hkv)``, zero until a page's first write.  The recurrent
    families add ``ssm`` ``(layers, B, H, P, N)`` f32 and ``conv``
    ``(layers, B, K-1, d_inner)`` in the storage dtype, which stay
    contiguous under either layout; ssm has no KV and so no pool whatever
    the layout.  ``n_pages=None`` sizes the pool
    at the worst case, ``batch * ceil(max_len / page_size)``.  ``cache``
    (a ``CacheConfig``) supplies layout, page size, pool size and
    ``kv_dtype``.
    ``per_row_pos=True`` keeps ``pos`` as a (B,) vector so rows may sit at
    different depths (continuous batching)."""
    check_family(cfg)
    if cache is not None:
        layout, page_size, n_pages = cache.layout, cache.page_size, \
            cache.n_pages
        kv_dtype = cache.kv_dtype
    if layout not in ("contiguous", "paged"):
        raise ValueError(f"unknown KV-cache layout {layout!r}")
    if kv_dtype not in ("f32", "bf16", "int8"):
        raise ValueError(f"unknown kv_dtype {kv_dtype!r} "
                         "(expected 'f32', 'bf16', or 'int8')")
    if kv_dtype != "f32" and layout != "paged":
        raise ValueError(
            "sub-f32 KV storage is a paged-pool feature (quantized "
            "scales are per page) — layout='paged' required for "
            f"kv_dtype={kv_dtype!r}"
        )
    dev = resolve_device(device)
    dt = cfg.dtype_()
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    state = {"pos": torch.zeros((batch,) if per_row_pos else (),
                                dtype=torch.int32, device=dev)}
    if cfg.family in ("ssm", "hybrid"):
        state["ssm"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
             cfg.ssm_state), dtype=torch.float32, device=dev)
        state["conv"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dt,
            device=dev)
    if cfg.family == "ssm":
        return state
    stacks = (cfg.n_layers if cfg.family in ("dense", "moe")
              else cfg.n_layers // cfg.attn_every)
    if layout == "paged":
        # absolute positions (no window ring): the table covers max_len
        max_blocks = -(-max_len // page_size)
        pages = batch * max_blocks if n_pages is None else n_pages
        ps = PG.init_pager(pages, dev)
        shape = (stacks, pages + 1, page_size, hkv, hd)
        kv_dt = KV_DTYPES.get(kv_dtype, dt)
        state.update({
            "kp": torch.zeros(shape, dtype=kv_dt, device=dev),
            "vp": torch.zeros(shape, dtype=kv_dt, device=dev),
            "block_table": PG.init_block_table(batch, max_blocks, dev),
            "page_free": ps.free, "page_top": ps.top, "page_rc": ps.rc,
        })
        if kv_dtype == "int8":
            # zero scale = empty page (write_page_quant resets at slot 0)
            for key in ("ksc", "vsc"):
                state[key] = torch.zeros((stacks, pages + 1, hkv),
                                         dtype=torch.float32, device=dev)
        return state
    # sliding-window archs only ever need `window` cache slots (ring buffer)
    eff = min(max_len, cfg.window) if cfg.window else max_len
    shape = (stacks, batch, eff, hkv, hd)
    state["k"] = torch.zeros(shape, dtype=dt, device=dev)
    state["v"] = torch.zeros(shape, dtype=dt, device=dev)
    return state


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


def _cache_update_chunk(cache: torch.Tensor, new: torch.Tensor,
                        posmat: torch.Tensor, valid: torch.Tensor) -> None:
    """Write a chunk of C tokens' K/V into a (B, S, Hkv, hd) cache, in
    place: token i of row b lands at ``posmat[b, i]`` where ``valid``.

    JAX routes invalid entries past the sequence axis and drops them.
    Here they are clamped to ``S - 1`` and scatter back the value they
    already hold.  That is safe because no clamped entry shares a target
    with a live one: unclamped invalid entries are padding at positions
    past the row's live ones (or rows that write nothing), and a live
    write never lands on ``S - 1`` — a request writes cache positions
    ``0 .. total_len - 2 <= max_len - 2``.
    """
    s = cache.shape[1]
    tgt = posmat.clamp(0, s - 1).long()[:, :, None, None].expand(
        *posmat.shape, *cache.shape[2:])
    val = torch.where(valid[:, :, None, None], new.to(cache.dtype),
                      cache.gather(1, tgt))
    cache.scatter_(1, tgt, val)


def _pager(state) -> PG.PagerState:
    return PG.PagerState(state["page_free"], state["page_top"],
                         state["page_rc"])


def _paged_commit(state, pstate: PG.PagerState, bt: torch.Tensor):
    return {**state, "page_free": pstate.free, "page_top": pstate.top,
            "page_rc": pstate.rc, "block_table": bt}


def _ffn(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """A layer's MLP or MoE block on (B, d) (decode: the MoE block sees
    (B, 1, d)) or (B, C, d)."""
    if "moe" not in p:
        return C.mlp_block(cfg, p["mlp"], x)
    if x.dim() == 2:
        return C.moe_block(cfg, p["moe"], x[:, None])[:, 0]
    return C.moe_block(cfg, p["moe"], x)


def _remat(fn, on: bool):
    """``fn`` under non-reentrant ``checkpoint`` when ``on``.  The
    recomputation runs in the backward, which autograd runs on a thread of
    its own for CUDA tensors, where the caller's thread-local
    ``use_backend`` is not in force: so the backend in force at the call
    is taken along and set again around the recomputation (else a
    reference-backend forward would be recomputed through the kernels).
    No RNG state is stashed: the forward draws no random numbers."""
    if not on:
        return fn

    def run(*args):
        backend = current_backend()

        def body(*a):
            with use_backend(backend):
                return fn(*a)

        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return run


def _trunk(cfg: ArchConfig, params, x: torch.Tensor, attn, mamba, *,
           remat: bool = False):
    """The layer stack of every family: ``attn(p, x, stack)`` and
    ``mamba(p, x, layer)`` are the caller's blocks (``stack`` indexes the
    KV caches: the layer for dense and moe, the group for hybrid).
    ``remat`` checkpoints every layer and every hybrid group, as
    ``repro.models.lm.forward`` does (``lm.py:135-149``)."""
    if cfg.family == "ssm":
        layer_fn = _remat(lambda x, p, layer: mamba(p["mamba"], x, layer),
                          remat)
        for layer, p in enumerate(params["layers"]):
            x = layer_fn(x, p, layer)
    elif cfg.family in ("dense", "moe"):
        layer_fn = _remat(
            lambda x, p, layer: _ffn(cfg, p, attn(p["attn"], x, layer)),
            remat)
        for layer, p in enumerate(params["layers"]):
            x = layer_fn(x, p, layer)
    else:
        layer_fn = _remat(lambda x, p, layer: mamba(p["mamba"], x, layer),
                          remat)

        def group_fn(x, group, g):
            for i, p in enumerate(group):
                x = layer_fn(x, p, g * cfg.attn_every + i)
            x = attn(params["shared_attn"], x, g)
            return C.mlp_block(cfg, params["shared_mlp"], x)

        group_fn = _remat(group_fn, remat)
        for g, group in enumerate(params["groups"]):
            x = group_fn(x, group, g)
    return x


def _recurrent(state, block):
    """A ``mamba(p, x, layer)`` for ``_trunk`` that runs ``block(p, x,
    ssm, conv)`` on the layer's carried states: the block writes the new
    SSD state over the old one (the scan's ``out``), and the new conv
    window is copied back into the stack."""
    def mamba(p, x, layer):
        x, _, s_conv = block(p, x, state["ssm"][layer], state["conv"][layer])
        state["conv"][layer].copy_(s_conv)
        return x
    return mamba


def decode_step(
    cfg: ArchConfig, params, state, token: torch.Tensor,   # (B,) int
    *, active: Optional[torch.Tensor] = None,               # (B,) bool
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token for every sequence in the batch; returns (logits, state).

    ``state["pos"]`` may be a scalar (all rows in lockstep) or a (B,) vector
    (rows at independent depths).  ``active`` (per-row ``pos`` only) masks
    rows that are between requests: their caches and recurrent states are
    not written, no pages are allocated, and their ``pos`` does not
    advance.  A ``block_table`` key in the state selects the paged layout
    (pages are mapped on write, positions are absolute and windows are
    masked in attention); the caches and states are updated in place.
    """
    pos = state["pos"]
    paged = "block_table" in state
    quant = paged and "ksc" in state          # int8 pools with scales
    x = params["embed"].index_select(0, token).to(cfg.dtype_())   # (B, d)
    b = x.shape[0]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    if cfg.family != "ssm":
        idx = pos if paged else _cache_index(cfg, pos)
        if cfg.window and not paged:
            cache_len = torch.clamp(pos + 1, max=cfg.window)
        else:
            cache_len = pos + 1
        rope_pos = pos[..., None] if pos.dim() == 1 else pos[None]
        if paged:
            pstate, bt = PG.alloc_on_write(
                _pager(state), state["block_table"], idx, active,
                page_size=state["kp"].shape[2])
            state = _paged_commit(state, pstate, bt)
        # inactive rows are routed to slot -1, which _cache_update drops
        if active is not None and not paged and idx.dim() == 1:
            w_idx = torch.where(active, idx, -1)
        else:
            w_idx = idx
        # one rotation for all layers (JAX recomputes it inside the scan)
        cos, sin = C.rope_freqs(cfg, rope_pos)

    def attn(a, x, stack):
        xn = C.norm(cfg, a["ln"], x)
        q = C.dense(xn, a["wq"], a.get("bq")).reshape(b, 1, cfg.n_heads, hd)
        k_new = C.dense(xn, a["wk"], a.get("bk")).reshape(b, 1, hkv, hd)
        v_new = C.dense(xn, a["wv"], a.get("bv")).reshape(b, hkv, hd)
        q = C.apply_rope(q, cos, sin).reshape(b, cfg.n_heads, hd)
        k_new = C.apply_rope(k_new, cos, sin).reshape(b, hkv, hd)
        if quant:
            ck, cv = state["kp"][stack], state["vp"][stack]
            ksc, vsc = state["ksc"][stack], state["vsc"][stack]
            PG.write_page_quant(ck, ksc, k_new, bt, idx, active)
            PG.write_page_quant(cv, vsc, v_new, bt, idx, active)
            o = ops.attention_decode(q, ck, cv, cache_len, block_table=bt,
                                     kv_scales=(ksc, vsc),
                                     window=cfg.window)
        elif paged:
            ck, cv = state["kp"][stack], state["vp"][stack]
            PG.write_page(ck, k_new, bt, idx, active)
            PG.write_page(cv, v_new, bt, idx, active)
            o = ops.attention_decode(q, ck, cv, cache_len, block_table=bt,
                                     window=cfg.window)
        else:
            ck, cv = state["k"][stack], state["v"][stack]
            _cache_update(ck, k_new, w_idx)
            _cache_update(cv, v_new, w_idx)
            o = ops.attention_decode(q, ck, cv, cache_len)
        return x + C.dense(o.reshape(b, -1), a["wo"])

    # inactive rows carry their recurrent states through bit for bit
    val = active[:, None] if active is not None else None
    x = _trunk(cfg, params, x, attn, _recurrent(
        state, lambda p, x, s1, s2: C.mamba_decode_block(
            cfg, p, x, s1, s2, valid=val, ssm_out=s1)))

    x = C.norm(cfg, params["ln_f"], x)
    logits = lm_logits(cfg, params, x)
    if active is not None and pos.dim() == 1:
        new_pos = pos + active.to(torch.int32)
    else:
        new_pos = pos + 1
    return logits, {**state, "pos": new_pos}


def prefill_chunk(
    cfg: ArchConfig, params, state, toks: torch.Tensor,   # (B, C) int
    width,                                               # () or (B,) int
    *, active: Optional[torch.Tensor] = None,             # (B,) bool
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Ingest up to C prompt tokens per row in one step.

    Row b's real tokens are ``toks[b, :width[b]]`` at absolute positions
    ``pos[b] .. pos[b]+width[b]-1``; the rest of the chunk is padding and
    never reaches a real cache slot or page, nor the recurrent states
    (its ``dt`` is zeroed).  Returns logits at each row's *last real*
    position — what a ``decode_step`` fed that position would return — and
    the state with ``pos`` advanced by ``width`` for active rows.  The
    chunk's projections run as B*C-row GEMMs, attention as one (C, hd)
    query block per row and each Mamba block as one SSD scan seeded with
    the carried state; the final norm and the LM head run on the B
    gathered last positions only.  Requires ``per_row_pos`` state;
    sliding-window archs need the paged layout (the contiguous ring cache
    recycles slots the in-chunk queries still read).
    """
    pos = state["pos"]
    if pos.dim() != 1:
        raise ValueError("prefill_chunk needs per_row_pos=True decode state")
    paged = "block_table" in state
    quant = paged and "ksc" in state
    b, c = toks.shape
    if cfg.window and not paged and cfg.family != "ssm":
        raise NotImplementedError(
            "chunked prefill with a sliding window needs layout='paged': "
            "the contiguous ring cache overwrites slots the in-chunk "
            "queries still read"
        )
    dev = toks.device
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)
    width = torch.as_tensor(width, device=dev).to(torch.int32).reshape(
        -1).expand(b).clamp(1, c)
    x = params["embed"].index_select(0, toks.reshape(-1)).reshape(
        b, c, -1).to(cfg.dtype_())                        # (B, C, d)
    offs = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    posmat = pos[:, None] + offs                          # (B, C) absolute
    valid = active[:, None] & (offs < width[:, None])     # real tokens
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    if cfg.family != "ssm":
        if paged:
            # map every block the chunk touches up front (admission-time
            # reservation guarantees the pops succeed)
            pstate, bt = PG.alloc_range(
                _pager(state), state["block_table"], pos, pos + width - 1,
                active, page_size=state["kp"].shape[2], max_chunk=c)
            state = _paged_commit(state, pstate, bt)
        cos, sin = C.rope_freqs(cfg, posmat)              # (B, C, hd/2)

    def attn(a, x, stack):
        xn = C.norm(cfg, a["ln"], x)
        q = C.dense(xn, a["wq"], a.get("bq")).reshape(b, c, cfg.n_heads, hd)
        k_new = C.dense(xn, a["wk"], a.get("bk")).reshape(b, c, hkv, hd)
        v_new = C.dense(xn, a["wv"], a.get("bv")).reshape(b, c, hkv, hd)
        q = C.apply_rope(q, cos, sin)
        k_new = C.apply_rope(k_new, cos, sin)
        if quant:
            ck, cv = state["kp"][stack], state["vp"][stack]
            ksc, vsc = state["ksc"][stack], state["vsc"][stack]
            PG.write_page_chunk_quant(ck, ksc, k_new, bt, pos, width, active)
            PG.write_page_chunk_quant(cv, vsc, v_new, bt, pos, width, active)
            o = ops.attention_prefill_chunk(q, ck, cv, pos, width,
                                            block_table=bt,
                                            kv_scales=(ksc, vsc),
                                            window=cfg.window)
        elif paged:
            ck, cv = state["kp"][stack], state["vp"][stack]
            PG.write_page_chunk(ck, k_new, bt, pos, width, active)
            PG.write_page_chunk(cv, v_new, bt, pos, width, active)
            o = ops.attention_prefill_chunk(q, ck, cv, pos, width,
                                            block_table=bt,
                                            window=cfg.window)
        else:
            ck, cv = state["k"][stack], state["v"][stack]
            _cache_update_chunk(ck, k_new, posmat, valid)
            _cache_update_chunk(cv, v_new, posmat, valid)
            o = ops.attention_prefill_chunk(q, ck, cv, pos, width)
        return x + C.dense(o.reshape(b, c, -1), a["wo"])

    x = _trunk(cfg, params, x, attn, _recurrent(
        state, lambda p, x, s1, s2: C.mamba_prefill_block(
            cfg, p, x, s1, s2, valid, ssm_out=s1)))

    # the last real position of each row, gathered *before* the final norm
    # and the head (both are position-wise), so the head runs at M = B
    last = x.gather(1, (width.long() - 1)[:, None, None].expand(
        b, 1, x.shape[-1]))[:, 0]
    logits = lm_logits(cfg, params, C.norm(cfg, params["ln_f"], last))
    return logits, {**state, "pos": pos + torch.where(active, width, 0)}


def reset_decode_rows(
    cfg: ArchConfig, state: Dict[str, torch.Tensor],
    mask: torch.Tensor,                                   # (B,) bool
    start=0,                                              # () or (B,) int
) -> Dict[str, torch.Tensor]:
    """Reset the rows selected by ``mask`` and put their decode clock at
    ``start`` — the serving engine's slot refill and release.  Contiguous
    caches and the recurrent ``ssm``/``conv`` states are zeroed in place;
    under the paged layout the rows *release* their pages (the pool is
    never zeroed: a recycled page is written by its next owner before any
    masked-in read can see it, and a page's scales are reset by the write
    of its slot 0).  Requires per-row ``pos`` state."""
    if state["pos"].dim() != 1:
        raise ValueError(
            "reset_decode_rows needs per_row_pos=True decode state"
        )
    paged_keys = {"kp", "vp", "ksc", "vsc", "block_table", "page_free",
                  "page_top", "page_rc"}
    unknown = set(state) - {"pos", "k", "v", "ssm", "conv"} - paged_keys
    if unknown:
        # a silently skipped cache key would leak the previous request's
        # state into the slot's next occupant
        raise ValueError(
            f"reset_decode_rows: unhandled decode-state keys {sorted(unknown)}"
        )
    out = {**state, "pos": torch.where(mask, start, state["pos"])}
    if "block_table" in state:
        pstate, bt = PG.release_rows(_pager(state), state["block_table"],
                                     mask)
        out = _paged_commit(out, pstate, bt)
    for key in ("k", "v", "ssm", "conv"):
        if key in state:
            t = state[key]                    # (stacks, B, ...)
            t.masked_fill_(mask.view(1, -1, *[1] * (t.dim() - 2)), 0)
    return out
