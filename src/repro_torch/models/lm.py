"""Decoder-only LM: the dense, moe, ssm (Mamba-2), hybrid (Zamba2) and
vlm (Llama-3.2-Vision) families, contiguous or paged KV cache, the paged
pool in the model's dtype, bf16 or int8 (the port's ``repro.models.lm``).

Public functions mirror the JAX module: ``init_params``, ``forward``,
``train_loss``, ``prefill``, ``init_decode_state``, ``decode_step``,
``prefill_chunk``, ``reset_decode_rows``, ``restore_snapshots``,
``spill_rows``, ``restore_rows``, ``prefill_vlm_cross_cache`` and
``lm_logits``.  Where JAX scans over stacked layer params, the port keeps
lists of per-layer dicts and loops in Python: ``params["layers"]``
(dense, moe, ssm) or ``params["groups"]``, ``g`` lists of ``attn_every``
Mamba layers each followed by the shared attention and MLP block
(hybrid), or of ``cross_attn_every - 1`` dense layers each followed by
the group's cross-attention layer ``params["cross"][g]`` (vlm).  vlm
runs the contiguous slab only, and has no chunked prefill, as in JAX.
JAX's functions are pure; the port updates the KV caches and page pools
**in place** (``decode_step``, ``prefill_chunk`` and ``reset_decode_rows``
write into ``state["k"]``/``state["v"]`` or ``state["kp"]``/``state["vp"]`` (and an
int8 pool's scales ``state["ksc"]``/``state["vsc"]``) and return a dict
that shares them), which saves a full rewrite of the cache on every
step; the recurrent ``ssm``/``conv`` states are written layer by layer
into their stacks the same way.  The small allocator tensors (block
table, free list, refcounts) are replaced, as in JAX.

Prefix sharing follows the JAX module: under ``cow`` the paged steps run
copy-on-write before their writes (``_paged_cow``), and the recurrent
families' snapshot store (``init_decode_state(snapshots=True)``) records
each row's full-depth SSM and conv state at every page boundary a step
ends on (``_snap_capture``, under ``snap_every``); ``restore_snapshots``
loads a donor's boundary state into an admitted row.  The snapshot pools
carry a trailing sentinel slot, as the page pools do.

Preemption follows the JAX module too: ``init_decode_state(host_spill=
True)`` adds the host tier behind the page pools (and, for the hybrid
family's snapshot store, behind the snapshot pools); ``spill_rows`` moves
victim rows' pages and snapshot slots there and ``restore_rows`` brings
them back.  On the card the host tier's payloads are pinned host memory,
moved by the page-copy kernel (``kernels/page_copy.py``); its bookkeeping
stays on the device.
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


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
KV_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: this module serves "
            f"{', '.join(FAMILIES)} (encdec is models/encdec.py)"
        )


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random params with ``repro.models.lm.init_params``'s shapes and
    scales, drawn from ``gen`` on its device.  ``params["layers"]`` is a
    list of ``{"attn": ..., "mlp": ...}`` (dense), ``{"attn": ...,
    "moe": ...}`` (moe) or ``{"mamba": ...}`` (ssm) dicts; hybrid has
    ``params["groups"]``, ``g`` lists of ``attn_every`` ``{"mamba": ...}``
    dicts, and the unstacked ``shared_attn`` and ``shared_mlp``; vlm has
    ``params["groups"]``, ``g`` lists of ``cross_attn_every - 1``
    ``{"attn": ..., "mlp": ...}`` dicts, and ``params["cross"]``, ``g``
    ``{"attn": ..., "mlp": ...}`` dicts whose attention is a gated cross
    block (JAX stacks the layers)."""
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
    elif cfg.family == "vlm":
        n_groups = _vlm_groups(cfg)
        params["groups"] = [
            [{"attn": C.init_attention(cfg, gen), "mlp": C.init_mlp(cfg, gen)}
             for _ in range(cfg.cross_attn_every - 1)]
            for _ in range(n_groups)
        ]
        params["cross"] = [
            {"attn": C.init_attention(cfg, gen, cross=True),
             "mlp": C.init_mlp(cfg, gen)}
            for _ in range(n_groups)
        ]
    else:
        params["groups"] = [
            [{"mamba": C.init_mamba(cfg, gen)}
             for _ in range(cfg.attn_every)]
            for _ in range(cfg.n_layers // cfg.attn_every)
        ]
        params["shared_attn"] = C.init_attention(cfg, gen)
        params["shared_mlp"] = C.init_mlp(cfg, gen)
    return params


def _vlm_groups(cfg: ArchConfig) -> int:
    """The vlm's group count, ``n_layers // cross_attn_every``; a depth
    that is no multiple of ``cross_attn_every`` raises (JAX floors it)."""
    if cfg.n_layers % cfg.cross_attn_every:
        raise ValueError(
            f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
            f"cross_attn_every {cfg.cross_attn_every}")
    return cfg.n_layers // cfg.cross_attn_every


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            vision: Optional[torch.Tensor] = None,
            remat: bool = True) -> torch.Tensor:
    """Teacher-forced forward over tokens (B, S) from empty caches: the
    final-normed hidden states (B, S, d) (``repro.models.lm.forward``).
    vlm needs ``vision`` (B, P, d), the patch embeddings its cross blocks
    attend to.  With grad mode on and ``remat``, each layer (and, hybrid
    and vlm, each group too) runs under ``torch.utils.checkpoint``, as JAX
    checkpoints them: only the layer inputs are kept, and the backward
    runs each layer's forward again.  Nothing here writes in place into a
    tensor autograd saved (the caches of the serving functions are not
    touched)."""
    check_family(cfg)
    if cfg.family == "vlm" and vision is None:
        raise ValueError("vlm needs vision embeddings")
    x = params["embed"][tokens].to(cfg.dtype_())
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def cross(cp, x, _):
        x = C.attention_block(cfg, cp["attn"], x, kv_src=vision,
                              causal=False)
        return C.mlp_block(cfg, cp["mlp"], x)

    x = _trunk(
        cfg, params, x,
        lambda p, x, _: C.attention_block(cfg, p, x, positions=positions,
                                          window=cfg.window),
        lambda p, x, _: C.mamba_block(cfg, p, x),
        cross=cross, remat=remat and torch.is_grad_enabled())
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
    the first S tokens (vlm: beside ``batch["vision"]``), the head, and the
    f32 NLL of the last S."""
    tokens = batch["tokens"]
    h = forward(cfg, params, tokens[:, :-1], vision=batch.get("vision"))
    return _xent(lm_logits(cfg, params, h), tokens[:, 1:])


def prefill(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            vision: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The last position's logits (B, V) of the teacher-forced forward
    (``repro.models.lm.prefill``: caches are not filled)."""
    h = forward(cfg, params, tokens, vision=vision, remat=False)
    return lm_logits(cfg, params, h[:, -1])


def lm_logits(cfg: ArchConfig, params, h: torch.Tensor) -> torch.Tensor:
    # the tied head is the (d, vocab) transposed *view* of the embedding;
    # the gemm kernel reads it by its strides, so nothing is copied
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return C.dense(h, w)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, *,
                      per_row_pos: bool = False,
                      layout: str = "contiguous", page_size: int = 16,
                      n_pages: Optional[int] = None, kv_dtype: str = "f32",
                      snapshots: bool = False, host_spill: bool = False,
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
    (a ``CacheConfig``) supplies layout, page size, pool size,
    ``kv_dtype``, ``snapshots`` and ``host_spill``.  vlm has the
    contiguous slab only (a paged layout raises, as in JAX): ``k``/``v``
    ``(g, cross_attn_every - 1, B, max_len, Hkv, hd)``, a cache per self-
    attention layer of each group, and the cross K/V ``xk``/``xv``
    ``(g, B, n_vision_tokens, Hkv, hd)``, zero until
    ``prefill_vlm_cross_cache`` fills them.
    ``per_row_pos=True`` keeps ``pos`` as a (B,) vector so rows may sit at
    different depths (continuous batching).  ``snapshots`` (recurrent
    families, paged layout) adds the page-boundary snapshot store, sized
    at the worst case, ``batch * ceil(max_len / page_size)`` slots plus
    the sentinel: ``snap_ssm`` ``(slots + 1, layers, H, P, N)`` f32,
    ``snap_conv`` ``(slots + 1, layers, K-1, d_inner)``, the slot table
    ``snap_table`` ``(B, ceil(max_len / page_size))`` (column ``j`` maps
    boundary ``j + 1``) and its allocator ``snap_free``/``snap_top``/
    ``snap_rc``; the other families ignore it, as in JAX.  ``host_spill``
    (paged families with KV pages, as in JAX) adds the host tier behind
    preemption, sized at the worst case, ``batch * ceil(max_len /
    page_size)`` slots plus the sentinel: ``hkp``/``hvp`` mirror the page
    pools (``hksc``/``hvsc`` the int8 pools' scales), with the slot table
    ``host_table`` and its allocator ``host_free``/``host_top``/
    ``host_rc``; the hybrid family's snapshot store gets ``hsnap_ssm``/
    ``hsnap_conv``, ``hsnap_table`` and ``hsnap_free``/``hsnap_top``/
    ``hsnap_rc``.  The payloads are pinned host memory when the state is
    on the card, the tables and allocators device tensors; pure ssm has
    no pages to relieve and ignores the flag."""
    check_family(cfg)
    if cache is not None:
        layout, page_size, n_pages = cache.layout, cache.page_size, \
            cache.n_pages
        kv_dtype, snapshots = cache.kv_dtype, cache.snapshots
        host_spill = bool(cache.host_spill)
    if layout not in ("contiguous", "paged"):
        raise ValueError(f"unknown KV-cache layout {layout!r}")
    if cfg.family == "vlm" and layout == "paged":
        raise NotImplementedError(
            "paged KV layout: vlm's grouped self-attention cache is not "
            "paged (serving engine families are dense/moe/ssm/hybrid)")
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
        if snapshots and layout != "paged":
            raise ValueError(
                "recurrent-state snapshots use page-boundary granularity — "
                "layout='paged' required"
            )
        state["ssm"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
             cfg.ssm_state), dtype=torch.float32, device=dev)
        state["conv"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dt,
            device=dev)
        if snapshots:
            # every row can snapshot every boundary it can reach, so the
            # slot allocator never runs dry mid-request
            n_bound = -(-max_len // page_size)
            n_slots = batch * n_bound
            ss = PG.init_pager(n_slots, dev)
            state.update({
                "snap_ssm": torch.zeros(
                    (n_slots + 1, cfg.n_layers, cfg.ssm_heads,
                     cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32,
                    device=dev),
                "snap_conv": torch.zeros(
                    (n_slots + 1, cfg.n_layers, cfg.ssm_conv - 1,
                     cfg.d_inner), dtype=dt, device=dev),
                "snap_table": PG.init_block_table(batch, n_bound, dev),
                "snap_free": ss.free, "snap_top": ss.top, "snap_rc": ss.rc,
            })
            if host_spill and layout == "paged" and cfg.family == "hybrid":
                # the snapshot store's host tier, at the device store's
                # worst case
                hs = PG.init_pager(n_slots, dev)
                state.update({
                    "hsnap_ssm": _host_zeros(state["snap_ssm"], dev),
                    "hsnap_conv": _host_zeros(state["snap_conv"], dev),
                    "hsnap_table": PG.init_block_table(batch, n_bound, dev),
                    "hsnap_free": hs.free, "hsnap_top": hs.top,
                    "hsnap_rc": hs.rc,
                })
    if cfg.family == "ssm":
        return state
    if cfg.family == "vlm":
        g = _vlm_groups(cfg)
        shape = (g, cfg.cross_attn_every - 1, batch, max_len, hkv, hd)
        xshape = (g, batch, cfg.n_vision_tokens, hkv, hd)
        for key, shp in (("k", shape), ("v", shape), ("xk", xshape),
                         ("xv", xshape)):
            state[key] = torch.zeros(shp, dtype=dt, device=dev)
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
        if host_spill:
            # worst case (every row fully resident, all spilled at once),
            # so a spill's pops never run dry; int8 pools spill their
            # payload and scales as they are
            n_h = batch * max_blocks
            hs = PG.init_pager(n_h, dev)
            state.update({"h" + key: _host_zeros(state[key], dev, n_h + 1)
                          for key in ("kp", "vp", "ksc", "vsc")
                          if key in state})
            state.update({
                "host_table": PG.init_block_table(batch, max_blocks, dev),
                "host_free": hs.free, "host_top": hs.top, "host_rc": hs.rc,
            })
        return state
    # sliding-window archs only ever need `window` cache slots (ring buffer)
    eff = min(max_len, cfg.window) if cfg.window else max_len
    shape = (stacks, batch, eff, hkv, hd)
    state["k"] = torch.zeros(shape, dtype=dt, device=dev)
    state["v"] = torch.zeros(shape, dtype=dt, device=dev)
    return state


def _host_zeros(like: torch.Tensor, dev: torch.device,
                pages: Optional[int] = None) -> torch.Tensor:
    """A host-tier pool shaped as ``like`` (with ``pages`` entries on its
    page axis: 1 for the (stacks, pages, ...) KV and scale pools, 0 for
    the snapshot pools), zeroed: pinned host memory when the state is on
    the card, which the page-copy kernel reads and writes through its
    device address; on ``dev`` otherwise."""
    shape = list(like.shape)
    if pages is not None:
        shape[1] = pages
    if dev.type == "cuda":
        return torch.zeros(shape, dtype=like.dtype, pin_memory=True)
    return torch.zeros(shape, dtype=like.dtype, device=dev)


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


def _self_qkv(cfg: ArchConfig, a, x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor):
    """A self-attention block's q (B, T, H, hd) and new k, v (B, T, Hkv,
    hd) from its input x (B, T, d): normed with the block's ``ln``,
    projected, q and k rotated by ``cos``/``sin``."""
    b, t = x.shape[:2]
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    xn = C.norm(cfg, a["ln"], x)
    q = C.dense(xn, a["wq"], a.get("bq")).reshape(b, t, cfg.n_heads, hd)
    k = C.dense(xn, a["wk"], a.get("bk")).reshape(b, t, hkv, hd)
    v = C.dense(xn, a["wv"], a.get("bv")).reshape(b, t, hkv, hd)
    return C.apply_rope(q, cos, sin), C.apply_rope(k, cos, sin), v


def _decode_attn_slab(cfg: ArchConfig, a, x: torch.Tensor, ck, cv, cos,
                      sin, w_idx: torch.Tensor,
                      cache_len: torch.Tensor) -> torch.Tensor:
    """One token a row (B, d) through a self-attention block over a
    contiguous cache ``ck``/``cv`` (B, S, Hkv, hd): the new K/V written in
    place at ``w_idx`` (-1 drops a row), then the decode kernel over
    ``cache_len`` keys.  Returns x plus the block's output."""
    q, k, v = (t[:, 0] for t in _self_qkv(cfg, a, x[:, None], cos, sin))
    _cache_update(ck, k, w_idx)
    _cache_update(cv, v, w_idx)
    o = ops.attention_decode(q, ck, cv, cache_len)
    return x + C.dense(o.reshape(x.shape[0], -1), a["wo"])


def _chunk_attn_slab(cfg: ArchConfig, a, x: torch.Tensor, ck, cv, cos, sin,
                     posmat: torch.Tensor, valid: torch.Tensor,
                     pos: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """A chunk (B, C, d) through a self-attention block over a contiguous
    cache ``ck``/``cv``: the ``valid`` tokens' K/V written in place at
    ``posmat``, then the chunk kernel from ``pos`` over ``width`` real
    tokens a row.  Returns x plus the block's output."""
    q, k, v = _self_qkv(cfg, a, x, cos, sin)
    _cache_update_chunk(ck, k, posmat, valid)
    _cache_update_chunk(cv, v, posmat, valid)
    o = ops.attention_prefill_chunk(q, ck, cv, pos, width)
    return x + C.dense(o.reshape(*x.shape[:2], -1), a["wo"])


# the hybrid_ssm drafter's private recurrent state
# (``serving/drafter.py``): ``drf_ssm``/``drf_conv`` (layers, B, ...) and
# its ingestion clock ``drf_pos`` (B,)
_DRAFT = ("drf_ssm", "drf_conv", "drf_pos")

# the table of each tier's allocator (``<tier>_free``/``_top``/``_rc``):
# the device pages, the snapshot slots, and their host tiers
_TABLES = {"page": "block_table", "host": "host_table",
           "snap": "snap_table", "hsnap": "hsnap_table"}


def _tier(state, tier: str):
    """``(PagerState, table)`` of a tier of ``_TABLES``."""
    return (PG.PagerState(state[tier + "_free"], state[tier + "_top"],
                          state[tier + "_rc"]), state[_TABLES[tier]])


def _commit_tier(state, tier: str, pstate: PG.PagerState,
                 table: torch.Tensor):
    return {**state, tier + "_free": pstate.free, tier + "_top": pstate.top,
            tier + "_rc": pstate.rc, _TABLES[tier]: table}


def _paged_cow(state, wpos, active, *, cow: bool):
    """The allocator and block table every paged write starts from: with
    ``cow`` (an engine that can share pages), after copy-on-write of the
    page each row writes at ``wpos``, whose written slots (and, int8, its
    scales) are copied into the private page in place.  Returns
    ``(PagerState, block_table)``."""
    pstate, bt = _tier(state, "page")
    if cow:
        pstate, bt, src, dst, lim, _ = PG.cow_on_write(
            pstate, bt, wpos, active, page_size=state["kp"].shape[2])
        for key in ("kp", "vp"):
            PG.copy_page_prefix(state[key], src, dst, lim)
        if "ksc" in state:
            # the copied prefix keeps dequantizing with its donor's scales;
            # the next write max-merges (and requantizes) from there
            for key in ("ksc", "vsc"):
                PG.copy_page_scale(state[key], src, dst)
    return pstate, bt


def _snap_capture(state, pos_after: torch.Tensor, active: torch.Tensor,
                  snap_every: int):
    """Snapshot the full-depth SSM and conv state of every active row
    whose step ended exactly at a boundary (``pos_after`` a positive
    multiple of ``snap_every``): allocate the slot of boundary
    ``pos_after / snap_every - 1`` (boundary space is block space with
    page size 1) and copy the row's states into the pools, in place.  A
    slot still shared with a peer (rc > 1) is never overwritten.  Rows
    that capture nothing write the sentinel slot."""
    at = active & (pos_after > 0) & (pos_after % snap_every == 0)
    bound = pos_after // snap_every - 1
    sstate, stbl = PG.alloc_on_write(*_tier(state, "snap"), bound, at,
                                     page_size=1)
    n_slots = state["snap_ssm"].shape[0] - 1
    nb = stbl.shape[1]
    slot = stbl.gather(1, bound.long().clamp(0, nb - 1)[:, None])[:, 0]
    ok = at & (bound >= 0) & (bound < nb) & (slot >= 0)
    ok &= sstate.rc.index_select(0, slot.long().clamp(0, n_slots)) <= 1
    tgt = torch.where(ok, slot.long(), n_slots)
    state["snap_ssm"].index_copy_(0, tgt, state["ssm"].transpose(0, 1))
    state["snap_conv"].index_copy_(
        0, tgt, state["conv"].transpose(0, 1).to(state["snap_conv"].dtype))
    return _commit_tier(state, "snap", sstate, stbl)


def restore_snapshots(state, mask: torch.Tensor, src, nblk):
    """Prefix-sharing admission of recurrent state: map the donor rows'
    first ``nblk`` snapshot slots into the masked rows' tables
    (``share_prefix`` on boundary space: the refcounts keep them past the
    donor's release) and load slot ``nblk - 1``, the donor's state after
    its first ``nblk`` pages, into the rows' SSM and conv states in
    place, so prefill resumes at the first unshared token.  ``nblk == 0``
    rows are untouched."""
    sstate, stbl = PG.share_prefix(*_tier(state, "snap"), src, nblk, mask)
    b, nb = stbl.shape
    nblk_b = torch.as_tensor(nblk, device=stbl.device).to(
        torch.int64).reshape(-1).expand(b)
    slot = stbl.gather(1, (nblk_b - 1).clamp(0, nb - 1)[:, None])[:, 0]
    ok = mask & (nblk_b > 0) & (slot >= 0)
    n_slots = state["snap_ssm"].shape[0] - 1
    sl = slot.long().clamp(0, n_slots)
    for key, snap in (("ssm", "snap_ssm"), ("conv", "snap_conv")):
        live = state[key]                                # (L, B, ...)
        got = state[snap].index_select(0, sl).transpose(0, 1)
        live.copy_(torch.where(ok.view(1, -1, *[1] * (live.dim() - 2)),
                               got.to(live.dtype), live))
    return _commit_tier(state, "snap", sstate, stbl)


# (device pool, host pool) pairs moved by a spill or restore: the page
# pools and an int8 pool's scales along the page axis (1), the snapshot
# pools along the slot axis (0)
_TIER_POOLS = (("kp", "hkp"), ("vp", "hvp"), ("ksc", "hksc"), ("vsc", "hvsc"))
_SNAP_TIER_POOLS = (("snap_ssm", "hsnap_ssm"), ("snap_conv", "hsnap_conv"))


def _move_rows(state, mask: torch.Tensor, fn, to_host: bool):
    """``spill_rows`` (``fn = PG.spill_rows``, ``to_host``) or its mirror:
    the bookkeeping of both spaces, then one ``copy_pages`` a pool."""
    if "host_table" not in state:
        raise ValueError(
            f"{'spill' if to_host else 'restore'}_rows needs "
            "init_decode_state(host_spill=True) paged state")
    out = state
    for dev_tier, host_tier, pools, axis in (
            ("page", "host", _TIER_POOLS, 1),
            ("snap", "hsnap", _SNAP_TIER_POOLS, 0)):
        if host_tier + "_table" not in state:
            continue
        pstate, table = _tier(state, dev_tier)
        hstate, htable = _tier(state, host_tier)
        pstate, table, hstate, htable, src, dst = fn(pstate, table, hstate,
                                                     htable, mask)
        for dev_key, host_key in pools:
            if host_key in state:
                a, b = ((state[host_key], state[dev_key]) if to_host
                        else (state[dev_key], state[host_key]))
                PG.copy_pages(a, b, src, dst, axis=axis)
        out = _commit_tier(_commit_tier(out, dev_tier, pstate, table),
                           host_tier, hstate, htable)
    return out


def spill_rows(state, mask: torch.Tensor):
    """Preemption: move the masked rows' KV pages, and with a host
    snapshot tier their boundary snapshot slots, to the host tier
    (``pager.spill_rows`` on each space, then ``copy_pages`` for each of
    its pools: one page-copy launch a pool on the card).  The rows' lane
    state (``pos``, the live ssm/conv carries) stays in place: a spilled
    row keeps its slot and idles with ``active=False``.  Needs
    ``init_decode_state(host_spill=True)``."""
    return _move_rows(state, mask, PG.spill_rows, to_host=True)


def restore_rows(state, mask: torch.Tensor):
    """The mirror of ``spill_rows``: fresh device pages (and snapshot
    slots) for the masked rows' host-table entries, the content copied
    back, the host slots released.  The caller's reservation ledger must
    already cover the rows' worst-case pages."""
    return _move_rows(state, mask, PG.restore_rows, to_host=False)


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
           cross=None, remat: bool = False):
    """The layer stack of every family: ``attn(p, x, stack)``,
    ``mamba(p, x, layer)`` and (vlm) ``cross(cp, x, group)`` are the
    caller's blocks (``stack`` indexes the KV caches: the layer for dense
    and moe, the group for hybrid, the (group, layer) pair for vlm;
    ``cross`` runs a vlm group's cross-attention layer, attention and
    MLP).  ``remat`` checkpoints every layer and every hybrid or vlm
    group, as ``repro.models.lm.forward`` does (``lm.py:135-176``)."""
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
    elif cfg.family == "vlm":
        layer_fn = _remat(
            lambda x, p, stack: _ffn(cfg, p, attn(p["attn"], x, stack)),
            remat)

        def group_fn(x, group, g):
            for i, p in enumerate(group):
                x = layer_fn(x, p, (g, i))
            return cross(params["cross"][g], x, g)

        group_fn = _remat(group_fn, remat)
        for g, group in enumerate(params["groups"]):
            x = group_fn(x, group, g)
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
    cow: bool = False, snap_every: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token for every sequence in the batch; returns (logits, state).

    ``state["pos"]`` may be a scalar (all rows in lockstep) or a (B,) vector
    (rows at independent depths).  ``active`` (per-row ``pos`` only) masks
    rows that are between requests: their caches and recurrent states are
    not written, no pages are allocated, and their ``pos`` does not
    advance.  A ``block_table`` key in the state selects the paged layout
    (pages are mapped on write, positions are absolute and windows are
    masked in attention); the caches and states are updated in place.
    ``cow`` runs copy-on-write before the paged write (engines that can
    share pages); ``snap_every`` captures each row's state when the step
    ends on a page boundary (a snapshot store and per-row ``pos``).
    """
    pos = state["pos"]
    paged = "block_table" in state
    quant = paged and "ksc" in state          # int8 pools with scales
    x = params["embed"].index_select(0, token).to(cfg.dtype_())   # (B, d)
    b = x.shape[0]
    if cfg.family != "ssm":
        idx = pos if paged else _cache_index(cfg, pos)
        if cfg.window and not paged:
            cache_len = torch.clamp(pos + 1, max=cfg.window)
        else:
            cache_len = pos + 1
        rope_pos = pos[..., None] if pos.dim() == 1 else pos[None]
        if paged:
            pstate, bt = _paged_cow(state, idx, active, cow=cow)
            pstate, bt = PG.alloc_on_write(pstate, bt, idx, active,
                                           page_size=state["kp"].shape[2])
            state = _commit_tier(state, "page", pstate, bt)
        # inactive rows are routed to slot -1, which _cache_update drops
        if active is not None and not paged and idx.dim() == 1:
            w_idx = torch.where(active, idx, -1)
        else:
            w_idx = idx
        # one rotation for all layers (JAX recomputes it inside the scan)
        cos, sin = C.rope_freqs(cfg, rope_pos)

    def attn(a, x, stack):
        if not paged:
            return _decode_attn_slab(cfg, a, x, state["k"][stack],
                                     state["v"][stack], cos, sin, w_idx,
                                     cache_len)
        q, k_new, v_new = (t[:, 0] for t in _self_qkv(cfg, a, x[:, None],
                                                      cos, sin))
        ck, cv = state["kp"][stack], state["vp"][stack]
        if quant:
            ksc, vsc = state["ksc"][stack], state["vsc"][stack]
            PG.write_page_quant(ck, ksc, k_new, bt, idx, active)
            PG.write_page_quant(cv, vsc, v_new, bt, idx, active)
            o = ops.attention_decode(q, ck, cv, cache_len, block_table=bt,
                                     kv_scales=(ksc, vsc),
                                     window=cfg.window)
        else:
            PG.write_page(ck, k_new, bt, idx, active)
            PG.write_page(cv, v_new, bt, idx, active)
            o = ops.attention_decode(q, ck, cv, cache_len, block_table=bt,
                                     window=cfg.window)
        return x + C.dense(o.reshape(b, -1), a["wo"])

    if cfg.family == "vlm":
        # the cross-attention reads every vision key: a scalar length
        n_vis = torch.full((), state["xk"].shape[2], dtype=torch.int32,
                           device=x.device)

    def cross(cp, x, g):
        x = C.cross_decode(cfg, cp["attn"], x, state["xk"][g],
                           state["xv"][g], n_vis)
        return C.mlp_block(cfg, cp["mlp"], x)

    # inactive rows carry their recurrent states through bit for bit
    val = active[:, None] if active is not None else None
    x = _trunk(cfg, params, x, attn, _recurrent(
        state, lambda p, x, s1, s2: C.mamba_decode_block(
            cfg, p, x, s1, s2, valid=val, ssm_out=s1)), cross=cross)

    x = C.norm(cfg, params["ln_f"], x)
    logits = lm_logits(cfg, params, x)
    if active is not None and pos.dim() == 1:
        new_pos = pos + active.to(torch.int32)
    else:
        new_pos = pos + 1
    state = {**state, "pos": new_pos}
    if snap_every and "snap_table" in state and pos.dim() == 1:
        act = (active if active is not None
               else torch.ones_like(pos, dtype=torch.bool))
        state = _snap_capture(state, new_pos, act, snap_every)
    return logits, state


def prefill_chunk(
    cfg: ArchConfig, params, state, toks: torch.Tensor,   # (B, C) int
    width,                                               # () or (B,) int
    *, active: Optional[torch.Tensor] = None,             # (B,) bool
    cow: bool = False, snap_every: int = 0, logits_all: bool = False,
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
    recycles slots the in-chunk queries still read).  ``cow`` and
    ``snap_every`` as in ``decode_step``: shared blocks are a page-aligned
    prefix, so only the chunk's first position can land in one, and a
    chunk that crosses a boundary without ending on it records nothing
    for it (the engine clips chunks to end on boundaries).
    ``logits_all`` (speculative decoding's verifier) applies the final norm
    and the head at every chunk position and returns (B, C, V) logits;
    padding positions carry garbage the caller masks by width.
    """
    if cfg.family == "vlm":
        raise NotImplementedError(
            "prefill_chunk: unsupported family 'vlm' (JAX has no vlm "
            "chunked prefill)")
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
    if cfg.family != "ssm":
        if paged:
            # map every block the chunk touches up front (admission-time
            # reservation guarantees the pops succeed)
            pstate, bt = _paged_cow(state, pos, active, cow=cow)
            pstate, bt = PG.alloc_range(
                pstate, bt, pos, pos + width - 1, active,
                page_size=state["kp"].shape[2], max_chunk=c)
            state = _commit_tier(state, "page", pstate, bt)
        cos, sin = C.rope_freqs(cfg, posmat)              # (B, C, hd/2)

    def attn(a, x, stack):
        if not paged:
            return _chunk_attn_slab(cfg, a, x, state["k"][stack],
                                    state["v"][stack], cos, sin, posmat,
                                    valid, pos, width)
        q, k_new, v_new = _self_qkv(cfg, a, x, cos, sin)
        ck, cv = state["kp"][stack], state["vp"][stack]
        if quant:
            ksc, vsc = state["ksc"][stack], state["vsc"][stack]
            PG.write_page_chunk_quant(ck, ksc, k_new, bt, pos, width, active)
            PG.write_page_chunk_quant(cv, vsc, v_new, bt, pos, width, active)
            o = ops.attention_prefill_chunk(q, ck, cv, pos, width,
                                            block_table=bt,
                                            kv_scales=(ksc, vsc),
                                            window=cfg.window)
        else:
            PG.write_page_chunk(ck, k_new, bt, pos, width, active)
            PG.write_page_chunk(cv, v_new, bt, pos, width, active)
            o = ops.attention_prefill_chunk(q, ck, cv, pos, width,
                                            block_table=bt,
                                            window=cfg.window)
        return x + C.dense(o.reshape(b, c, -1), a["wo"])

    x = _trunk(cfg, params, x, attn, _recurrent(
        state, lambda p, x, s1, s2: C.mamba_prefill_block(
            cfg, p, x, s1, s2, valid, ssm_out=s1)))

    if logits_all:
        logits = lm_logits(cfg, params, C.norm(cfg, params["ln_f"], x))
    else:
        # the last real position of each row, gathered *before* the final
        # norm and the head (both are position-wise), so the head runs at
        # M = B
        last = x.gather(1, (width.long() - 1)[:, None, None].expand(
            b, 1, x.shape[-1]))[:, 0]
        logits = lm_logits(cfg, params, C.norm(cfg, params["ln_f"], last))
    state = {**state, "pos": pos + torch.where(active, width, 0)}
    if snap_every and "snap_table" in state:
        state = _snap_capture(state, state["pos"], active, snap_every)
    return logits, state



def init_scratch(cfg: ArchConfig, state, chunk: int):
    """The buffers of ``score_chunk``, allocated once (an engine's life):
    the recurrent families' ``ssm``/``conv`` shaped as the state's, and,
    for the hybrid family's KV, room for every page (with the sentinel)
    or slab slot a chunk of width ``chunk`` can write: the pages of
    ``(chunk - 1) // page_size + 2`` blocks a row, with their int8 scales,
    or ``chunk`` slots a row."""
    scratch = {key: torch.empty_like(state[key]) for key in ("ssm", "conv")
               if key in state}
    b = state["pos"].shape[0]
    if "block_table" in state:
        n = b * ((chunk - 1) // state["kp"].shape[2] + 2) + 1
        for key in ("kp", "vp", "ksc", "vsc"):
            if key in state:
                shape = list(state[key].shape)
                shape[1] = n
                scratch[key] = state[key].new_empty(shape)
    else:
        for key in ("k", "v"):
            if key in state:
                shape = list(state[key].shape)
                shape[2] = chunk
                scratch[key] = state[key].new_empty(shape)
    return scratch


def score_chunk(
    cfg: ArchConfig, params, state, toks: torch.Tensor,   # (B, C) int
    width, *, active: torch.Tensor, scratch,
) -> torch.Tensor:
    """``prefill_chunk(logits_all=True)`` as a discarded pass: the (B, C, V)
    logits, with every tensor of ``state`` left byte-identical.  The port
    writes its state in place, so the recurrent families run the chunk on
    ``scratch``'s copies of ``ssm``/``conv``, and the hybrid family's KV
    writes are undone: the pages the chunk can touch (every block from
    ``pos // page_size`` on that its writes and int8 requantization reach,
    mapped after the chunk's own allocation, unmapped ones as the
    sentinel, plus the sentinel itself) and their scales, or the slab's
    slots, are saved before the pass and written back after.  The
    allocator is functional, so its returned state is simply dropped.  No
    copy-on-write and no snapshot capture, as JAX's discarded pass."""
    b, c = toks.shape
    pos = state["pos"]
    dev = toks.device
    saved = []
    if "block_table" in state:
        page = state["kp"].shape[2]
        w = torch.as_tensor(width, device=dev).to(torch.int32).reshape(
            -1).expand(b).clamp(1, c)
        _, bt = PG.alloc_range(*_tier(state, "page"), pos, pos + w - 1,
                               active, page_size=page, max_chunk=c)
        n_pages, max_blocks = state["kp"].shape[1] - 1, bt.shape[1]
        blk = (pos.long() // page)[:, None] + torch.arange(
            (c - 1) // page + 2, device=dev)[None, :]
        ids = bt.gather(1, blk.clamp(max=max_blocks - 1)).long()
        ids = torch.where((blk < max_blocks) & (ids >= 0), ids, n_pages)
        ids = torch.cat([ids.reshape(-1), ids.new_full((1,), n_pages)])
        for key in ("kp", "vp", "ksc", "vsc"):
            if key in state:
                torch.index_select(state[key], 1, ids, out=scratch[key])
                saved.append((key, ids))
    elif "k" in state:
        s_len = state["k"].shape[2]
        slots = (pos.long()[:, None] + torch.arange(c, device=dev)[None, :]
                 ).clamp(0, s_len - 1)
        for key in ("k", "v"):
            t = state[key]
            idx = slots[None, :, :, None, None].expand(
                t.shape[0], b, c, *t.shape[3:])
            torch.gather(t, 2, idx, out=scratch[key])
            saved.append((key, idx))
    run = dict(state)
    for key in ("ssm", "conv"):
        if key in state:
            scratch[key].copy_(state[key])
            run[key] = scratch[key]
    logits, _ = prefill_chunk(cfg, params, run, toks, width, active=active,
                              logits_all=True)
    for key, idx in saved:
        if key in ("k", "v"):
            state[key].scatter_(2, idx, scratch[key])
        else:
            state[key].index_copy_(1, idx, scratch[key])
    return logits

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
    of its slot 0); snapshot slots are released with their rows the same
    way (slots a sharer still maps stay), and so are the host tier's
    slots of a row drained while spilled.  The hybrid_ssm drafter's
    private state (``drf_ssm``/``drf_conv``, zeroed; its clock
    ``drf_pos``, set to ``start``) resets with the row, as in JAX, and so
    do vlm's cross K/V ``xk``/``xv`` (zeroed; its self-attention caches
    have the batch on axis 2).  Requires per-row ``pos`` state."""
    if state["pos"].dim() != 1:
        raise ValueError(
            "reset_decode_rows needs per_row_pos=True decode state"
        )
    known = {"pos", "k", "v", "xk", "xv", "ssm", "conv", *_TABLES.values(),
             *_DRAFT}
    known |= {key for pair in _TIER_POOLS + _SNAP_TIER_POOLS for key in pair}
    known |= {t + f for t in _TABLES for f in ("_free", "_top", "_rc")}
    unknown = set(state) - known
    if unknown:
        # a silently skipped cache key would leak the previous request's
        # state into the slot's next occupant
        raise ValueError(
            f"reset_decode_rows: unhandled decode-state keys {sorted(unknown)}"
        )
    out = {**state, "pos": torch.where(mask, start, state["pos"])}
    if "drf_pos" in state:
        out["drf_pos"] = torch.where(mask, start, state["drf_pos"])
    # pages and snapshot slots are released in every tier: a row drained
    # while spilled returns its host slots (host copies are private, rc 1)
    for tier in _TABLES:
        if tier + "_free" in state:
            pstate, table = PG.release_rows(*_tier(state, tier), mask)
            out = _commit_tier(out, tier, pstate, table)
    for key in ("k", "v", "xk", "xv", "ssm", "conv", "drf_ssm",
                "drf_conv"):
        if key in state:
            t = state[key]                    # (stacks, B, ...)
            # vlm's self-attention caches are (groups, per, B, ...)
            axis = 2 if cfg.family == "vlm" and key in ("k", "v") else 1
            t.masked_fill_(mask.view(*[1] * axis, -1,
                                     *[1] * (t.dim() - axis - 1)), 0)
    return out


def prefill_vlm_cross_cache(cfg: ArchConfig, params, vision: torch.Tensor,
                            state):
    """Fill vlm's cross K/V from the vision embeddings (B, P, d), in
    place: each group's memory normed with its cross block's ``ln`` and
    projected (``repro.models.lm.prefill_vlm_cross_cache``)."""
    for g, cp in enumerate(params["cross"]):
        k, v = C.cross_kv(cfg, cp["attn"], vision)
        state["xk"][g].copy_(k)
        state["xv"][g].copy_(v)
    return {**state}
