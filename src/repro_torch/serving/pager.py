"""Device-side page allocator for the paged KV-cache layout (the port's
subset of ``repro.serving.pager``: allocation, release and the paged K/V
writes, plain and int8; sharing, copy-on-write (with ``copy_page_scale``)
and spill come with later slices).

Layout contract (the JAX package's, plus one trash page):

  * page pool      ``(layers, n_pages + 1, page_size, Hkv, hd)``.  Pages
    ``0 .. n_pages-1`` are real; page ``n_pages`` is the **sentinel**.
  * block table    ``(B, max_blocks)`` int32.  Token at absolute position
    ``p`` of row ``b`` lives in page ``block_table[b, p // page_size]`` at
    slot ``p % page_size``; ``-1`` marks an unmapped block.
  * allocator      ``free`` ``(n_pages + 1,)`` int32 — ``free[:top]`` are
    free page ids; ``top`` ``()`` int32; ``rc`` ``(n_pages + 1,)`` int32 —
    block-table refs per page.  Entry ``n_pages`` of ``free`` and ``rc``
    is the sentinel's.

**Write-drop convention.**  The reference routes every masked write to an
out-of-bounds index with ``mode="drop"``.  PyTorch has no drop mode (an
out-of-range index raises, ``-1`` wraps), and a gather-where-scatter into a
clamped index is wrong for a shared pool: an inactive row clamped onto a
live row's page would write the old value back in the same scatter as the
live row's real write.  So every dropped write goes to the sentinel: the
trailing pool page, ``free[n_pages]`` or ``rc[n_pages]``.  The sentinel is
never on the free list and never in a block table, so no reader sees it;
what lands there is garbage.  Comparisons with the reference use
``[:n_pages]``.

**Quantized pools** (``kv_dtype="int8"``): the payload pool is int8 and a
scale pool ``(layers, n_pages + 1, Hkv)`` f32 rides beside it, one
symmetric scale per (page, kv head), its trailing entry the sentinel's.
A page's scale is reset by the write that lands its slot 0 and
max-merged by every later one; when it grows, the page's written slots
are requantized in the same whole-page write (``write_page_quant``).  A
dropped payload write drops its scale write too (both go to the
sentinel), so the two pools never disagree about a real page.

Every function is pure tensor work with fixed shapes — no ``.item()``, no
boolean-mask indexing, no ``nonzero``, no Python branch on a tensor — so
the engine's prefill and decode loops never synchronise with the host.
Pop order is the reference's exactly: rows needing a page are ranked by
batch index and pop ``free[top - 1 - rank]``; ``alloc_range`` runs the
same ladder of single-block rungs.  The allocator state is returned anew
(it is tiny); the pools are written in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class PagerState(NamedTuple):
    """Free-list stack + per-page refcounts (device tensors)."""

    free: torch.Tensor  # (n_pages + 1,) int32: free[:top] are free page ids
    top: torch.Tensor   # ()            int32: number of free pages
    rc: torch.Tensor    # (n_pages + 1,) int32: block-table refs per page


def init_pager(n_pages: int, device: torch.device) -> PagerState:
    return PagerState(
        free=torch.arange(n_pages + 1, dtype=torch.int32, device=device),
        top=torch.tensor(n_pages, dtype=torch.int32, device=device),
        rc=torch.zeros((n_pages + 1,), dtype=torch.int32, device=device),
    )


def init_block_table(batch: int, max_blocks: int,
                     device: torch.device) -> torch.Tensor:
    return torch.full((batch, max_blocks), -1, dtype=torch.int32,
                      device=device)


def pages_needed(total_len: int, page_size: int) -> int:
    """Pages a request reserves at admission (host-side accounting): it
    writes cache positions ``0 .. total_len - 2`` (the last feed only
    predicts), i.e. ``ceil((total_len - 1) / page_size)`` blocks."""
    return max(1, -(-(total_len - 1) // page_size))


def _per_row(x, b: int, device: torch.device) -> torch.Tensor:
    """() or (B,) int -> (B,) int64 on ``device``."""
    return torch.as_tensor(x, device=device).to(torch.int64).reshape(
        -1).expand(b)


def _push_freed(free: torch.Tensor, top: torch.Tensor,
                freed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Push the real pages selected by the (n_pages,) bool mask onto the
    stack in ascending page id; unselected pages write the sentinel."""
    n_pages = free.shape[0] - 1
    page_ids = torch.arange(n_pages, dtype=torch.int32, device=free.device)
    rank = torch.cumsum(freed, 0) - 1          # distinct for freed pages
    dst = torch.where(freed, top + rank, n_pages)
    free = free.index_put((dst,), page_ids)
    return free, top + freed.sum(dtype=torch.int32)


def alloc_on_write(
    pager: PagerState,
    block_table: torch.Tensor,             # (B, max_blocks) int32
    idx,                                   # () or (B,) int: position written
    active: Optional[torch.Tensor] = None,  # (B,) bool; None = all rows
    *,
    page_size: int,
) -> Tuple[PagerState, torch.Tensor]:
    """Map the block covering ``idx`` for every row that needs one.

    Rows needing a page are ranked by batch index and pop
    ``free[top-1-rank]``.  A row whose block is already mapped, out of
    range, or inactive is untouched; if the free list runs dry the rest
    stay unmapped (admission-time reservation prevents this)."""
    b, max_blocks = block_table.shape
    dev = block_table.device
    n_pages = pager.free.shape[0] - 1
    idx_b = _per_row(idx, b, dev)
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)
    blk = idx_b // page_size
    in_range = blk < max_blocks
    blk_c = blk.clamp(0, max_blocks - 1)
    cur = block_table.gather(1, blk_c[:, None])[:, 0]
    need = active & in_range & (cur < 0)
    rank = torch.cumsum(need, 0) - 1             # rank among needy rows
    grant = need & (rank < pager.top)
    src = (pager.top - 1 - rank).clamp(0, max(n_pages - 1, 0))
    page = torch.where(grant, pager.free.index_select(0, src), cur)
    col = torch.arange(max_blocks, device=dev)
    block_table = torch.where(
        grant[:, None] & (col[None, :] == blk_c[:, None]), page[:, None],
        block_table,
    )
    top = pager.top - grant.sum(dtype=torch.int32)
    rc = pager.rc.index_put(
        (torch.where(grant, page.long(), n_pages),),
        torch.ones((), dtype=torch.int32, device=dev),
    )
    return PagerState(pager.free, top, rc), block_table


def alloc_range(
    pager: PagerState,
    block_table: torch.Tensor,             # (B, max_blocks) int32
    start,                                 # () or (B,): first position
    end,                                   # () or (B,): last position
    active: Optional[torch.Tensor] = None,
    *,
    page_size: int,
    max_chunk: int,
) -> Tuple[PagerState, torch.Tensor]:
    """Map every block covering positions ``start .. end`` (inclusive): a
    fixed ladder of ``(max_chunk - 1) // page_size + 2`` single-block
    rungs, rung ``k`` targeting block ``start // page_size + k`` and
    masked for rows whose range ends in an earlier block."""
    b = block_table.shape[0]
    dev = block_table.device
    start_b = _per_row(start, b, dev)
    end_b = _per_row(end, b, dev)
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)
    start_blk = start_b // page_size
    end_blk = end_b // page_size
    for k in range((max_chunk - 1) // page_size + 2):
        blk = start_blk + k
        idx = torch.maximum(start_b, blk * page_size)
        pager, block_table = alloc_on_write(
            pager, block_table, torch.minimum(idx, end_b),
            active & (blk <= end_blk), page_size=page_size,
        )
    return pager, block_table


def release_rows(
    pager: PagerState,
    block_table: torch.Tensor,   # (B, max_blocks) int32
    mask: torch.Tensor,          # (B,) bool: rows whose pages return
) -> Tuple[PagerState, torch.Tensor]:
    """Drop the masked rows' refs on every page they map, push the pages
    whose refcount reaches 0 back onto the stack, and unmap the rows.
    Duplicate pages decrement once per reference (``index_add_``).
    Releasing an empty row is a no-op."""
    n_pages = pager.free.shape[0] - 1
    give = mask[:, None] & (block_table >= 0)
    pages = torch.where(give, block_table.long(), n_pages).reshape(-1)
    dec = torch.zeros_like(pager.rc).index_add_(
        0, pages, torch.ones_like(pages, dtype=pager.rc.dtype))
    rc = pager.rc - dec
    freed = ((pager.rc > 0) & (rc <= 0) & (dec > 0))[:n_pages]
    rc = rc.clamp(min=0)
    free, top = _push_freed(pager.free, pager.top, freed)
    block_table = torch.where(mask[:, None], -1, block_table)
    return PagerState(free, top, rc), block_table


def write_page(
    pool: torch.Tensor,          # (n_pages + 1, page_size, Hkv, hd)
    new: torch.Tensor,           # (B, Hkv, hd): one token per row
    block_table: torch.Tensor,   # (B, max_blocks) int32
    idx,                         # () or (B,): absolute position
    active: Optional[torch.Tensor] = None,
) -> None:
    """Write one token's K or V through the block table, in place.  Rows
    that are inactive, out of range or unmapped write the sentinel page."""
    sentinel, page_size = pool.shape[0] - 1, pool.shape[1]
    b, max_blocks = block_table.shape
    idx_b = _per_row(idx, b, pool.device)
    blk = idx_b // page_size
    page = block_table.gather(1, blk.clamp(0, max_blocks - 1)[:, None])[:, 0]
    ok = (blk < max_blocks) & (page >= 0)
    if active is not None:
        ok &= active
    page = torch.where(ok, page.long(), sentinel)
    pool.index_put_((page, idx_b % page_size), new.to(pool.dtype))


def write_page_chunk(
    pool: torch.Tensor,          # (n_pages + 1, page_size, Hkv, hd)
    new: torch.Tensor,           # (B, C, Hkv, hd): C tokens per row
    block_table: torch.Tensor,   # (B, max_blocks) int32
    start,                       # () or (B,): position of chunk token 0
    width,                       # () or (B,): real tokens (1..C)
    active: Optional[torch.Tensor] = None,
) -> None:
    """Write a chunk of C tokens' K or V through the block table, in
    place: token ``i`` of row ``b`` lands at ``(bt[b, (start+i)//P],
    (start+i) % P)``.  Chunk padding (``i >= width``), inactive rows,
    out-of-range and unmapped blocks write the sentinel page.  Live
    targets are distinct (positions differ within a row; a page belongs
    to one row), so no live slot is written twice."""
    sentinel, page_size = pool.shape[0] - 1, pool.shape[1]
    b, max_blocks = block_table.shape
    c = new.shape[1]
    dev = pool.device
    start_b = _per_row(start, b, dev)
    w_b = _per_row(width, b, dev)
    i = torch.arange(c, device=dev)[None, :]
    posmat = start_b[:, None] + i                               # (B, C)
    blk = posmat // page_size
    page = block_table.gather(1, blk.clamp(0, max_blocks - 1))  # (B, C)
    ok = (i < w_b[:, None]) & (blk < max_blocks) & (page >= 0)
    if active is not None:
        ok &= active[:, None]
    page = torch.where(ok, page.long(), sentinel)
    pool.index_put_((page, posmat % page_size), new.to(pool.dtype))


# ---------------------------------------------------------------------------
# Quantized writes (kv_dtype="int8"): int8 payload + per-(page, head) f32
# scales, with the JAX package's arithmetic step for step
# ---------------------------------------------------------------------------

_QMAX = 127.0


def _quant_safe(scale: torch.Tensor) -> torch.Tensor:
    """Divide-safe scale: a zero scale encodes an all-zero payload, so any
    positive stand-in quantizes it to exact zeros."""
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def _requant(pool: torch.Tensor, scale: torch.Tensor, tgt: torch.Tensor,
             s_cand: torch.Tensor, fresh: torch.Tensor):
    """The target pages' merged scales (reset where ``fresh``, else the
    running max) and their contents requantized to them: ``(s_new,
    merged)``, merged (B, page, Hkv, hd) f32 before the new tokens land.
    A fresh page's stale payload rescales to zero."""
    s_old = scale[tgt]                                   # (B, Hkv)
    s_new = torch.where(fresh, s_cand, torch.maximum(s_old, s_cand))
    ratio = torch.where(fresh, 0.0, s_old / _quant_safe(s_new))
    merged = torch.round(pool[tgt].float() * ratio[:, None, :, None])
    return s_new, merged


def write_page_quant(
    pool: torch.Tensor,          # (n_pages + 1, page_size, Hkv, hd) int8
    scale: torch.Tensor,         # (n_pages + 1, Hkv) f32
    new: torch.Tensor,           # (B, Hkv, hd): one token per row
    block_table: torch.Tensor,   # (B, max_blocks) int32
    idx,                         # () or (B,): absolute position
    active: Optional[torch.Tensor] = None,
) -> None:
    """``write_page`` for the int8 pool, in place: the target page's
    scale is reset at slot 0 and max-merged after, its written slots are
    requantized when the scale grows, and the new token is quantized by
    division, ``round(x / s)`` clipped to +-127.  Rows that are inactive,
    out of range or unmapped write the sentinel page and its scale."""
    sentinel, page_size = pool.shape[0] - 1, pool.shape[1]
    b, max_blocks = block_table.shape
    dev = pool.device
    idx_b = _per_row(idx, b, dev)
    blk = idx_b // page_size
    page = block_table.gather(1, blk.clamp(0, max_blocks - 1)[:, None])[:, 0]
    ok = (blk < max_blocks) & (page >= 0)
    if active is not None:
        ok &= active
    tgt = torch.where(ok, page.long(), sentinel)
    slot = idx_b % page_size

    newf = new.float()                                   # (B, Hkv, hd)
    s_cand = newf.abs().amax(dim=-1) / _QMAX             # (B, Hkv)
    s_new, merged = _requant(pool, scale, tgt, s_cand,
                             (slot == 0)[:, None])
    q_tok = torch.round(newf / _quant_safe(s_new)[:, :, None])
    sl = torch.arange(page_size, device=dev)[None, :, None, None]
    merged = torch.where(sl == slot[:, None, None, None], q_tok[:, None],
                         merged).clamp(-_QMAX, _QMAX)
    pool.index_put_((tgt,), merged.to(pool.dtype))
    scale.index_put_((tgt,), s_new)


def write_page_chunk_quant(
    pool: torch.Tensor,          # (n_pages + 1, page_size, Hkv, hd) int8
    scale: torch.Tensor,         # (n_pages + 1, Hkv) f32
    new: torch.Tensor,           # (B, C, Hkv, hd): C tokens per row
    block_table: torch.Tensor,   # (B, max_blocks) int32
    start,                       # () or (B,): position of chunk token 0
    width,                       # () or (B,): real tokens (1..C)
    active: Optional[torch.Tensor] = None,
) -> None:
    """``write_page_chunk`` for the int8 pool, in place.  The scale must
    be merged once per page the chunk touches, so this runs the
    ``(C-1)//page_size + 2``-rung ladder of ``alloc_range``: rung ``k``
    quantizes the tokens landing in block ``start//page_size + k``
    against that page's merged scale (reset when the rung covers the
    page's slot 0, i.e. ``blk * page_size >= start``).  A slot of the page
    takes chunk token ``blk * page_size + slot - start`` where that is a
    real token of the chunk, and keeps its requantized content otherwise
    (a mask, never a wrapped index).  Rungs touch disjoint pages per row;
    masked rungs write the sentinel page and its scale."""
    sentinel, page_size = pool.shape[0] - 1, pool.shape[1]
    b, max_blocks = block_table.shape
    c = new.shape[1]
    dev = pool.device
    start_b = _per_row(start, b, dev)
    w_b = _per_row(width, b, dev)
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)
    i = torch.arange(c, device=dev)[None, :]
    posmat = start_b[:, None] + i                        # (B, C)
    end_blk = (start_b + w_b.clamp(min=1) - 1) // page_size
    start_blk = start_b // page_size
    newf = new.float()                                   # (B, C, Hkv, hd)
    absf = newf.abs()
    sl = torch.arange(page_size, device=dev)[None, :]
    for k in range((c - 1) // page_size + 2):
        blk = start_blk + k
        on = active & (w_b > 0) & (blk <= end_blk) & (blk < max_blocks)
        page = block_table.gather(
            1, blk.clamp(0, max_blocks - 1)[:, None])[:, 0]
        on &= page >= 0
        tgt = torch.where(on, page.long(), sentinel)
        in_rung = (posmat // page_size == blk[:, None]) & (i < w_b[:, None])
        amax = torch.where(in_rung[:, :, None, None], absf, 0.0).amax(
            dim=(1, 3))                                  # (B, Hkv)
        s_new, merged = _requant(pool, scale, tgt, amax / _QMAX,
                                 (blk * page_size >= start_b)[:, None])
        q_tok = torch.round(newf / _quant_safe(s_new)[:, None, :, None])
        # chunk token of each slot of the page; a real one lands there
        ci = blk[:, None] * page_size + sl - start_b[:, None]   # (B, page)
        land = (ci >= 0) & (ci < w_b[:, None]) & (ci < c)
        tok = q_tok.gather(1, ci.clamp(0, c - 1)[:, :, None, None].expand(
            -1, -1, *q_tok.shape[2:]))
        merged = torch.where(land[:, :, None, None], tok,
                             merged).clamp(-_QMAX, _QMAX)
        pool.index_put_((tgt,), merged.to(pool.dtype))
        scale.index_put_((tgt,), s_new)
