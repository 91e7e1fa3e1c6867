"""Device-side page allocator for the paged KV-cache layout (the port's
subset of ``repro.serving.pager``: allocation, release, the paged K/V
writes, plain and int8, prefix sharing with copy-on-write, the host tier
behind preemption, and ``release_tail``, speculative decoding's
rollback).

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

**Prefix sharing** (JAX's contract): ``share_prefix`` maps a donor row's
leading blocks into an admitted row and bumps their refcounts; a page
with ``rc > 1`` is read-only, so ``cow_on_write`` moves a row about to
write one onto a fresh page (dropping its ref; a ref that reaches 0
sends the page back to the free list) and ``copy_page_prefix`` /
``copy_page_scale`` move the written slots and an int8 page's scales
across.  CoW pops rank before the step's allocation pops, rows by batch
index.  Rows that do not move carry the sentinel as source and target,
so their copies land in the sentinel page.  The same functions manage
the recurrent families' snapshot slots with ``page_size=1``
(``lm.init_decode_state(snapshots=True)``).

**Two tiers** (JAX's contract, the memory-pressure escape valve): the
host tier is a second pool with its own per-row table and its own
refcounted free list, sized at the worst case (``batch * max_blocks``
slots, plus the sentinel), so a spill never finds it dry.
``spill_rows`` pops one host slot per mapped block of each victim row
(rows and blocks in flattened row-major order), records it in the host
table with ``rc`` 1 (host copies are private, even of a page a
prefix-sharing peer still maps) and releases the device pages;
``restore_rows`` is its mirror.  Both return the ``(src, dst)`` id
vectors of the move, the sentinel where a block did not move, for
``copy_pages`` (``kernels/page_copy.py``): whole pages between the two
pools, axis 1 for KV and scale pools, axis 0 for snapshot pools.  On the
card the host pools are pinned host memory and the copy is one kernel a
pool; the bookkeeping stays on the device, so neither call reads an id on
the host.  The snapshot store's host tier (hybrid family) is the same
machinery on boundary space.

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

from repro_torch.kernels.page_copy import copy_pages  # noqa: F401


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



def release_tail(
    pager: PagerState,
    block_table: torch.Tensor,   # (B, max_blocks) int32
    frontier,                    # () or (B,): highest live position + 1
    mask: torch.Tensor,          # (B,) bool: rows to roll back
    *,
    page_size: int,
) -> Tuple[PagerState, torch.Tensor]:
    """Release the masked rows' blocks strictly beyond the one covering
    position ``frontier - 1`` (speculative decoding's rollback: a verify
    step maps pages for its whole drafted chunk, and a row that accepts
    fewer tokens gives the tail back).  The refcount discipline of
    ``release_rows``: each dropped entry decrements its page once, a page
    reaching 0 goes back on the stack in ascending id, and a row whose
    tail is empty is a no-op.  Dropped entries' decrements land on the
    sentinel's count."""
    b, max_blocks = block_table.shape
    dev = block_table.device
    n_pages = pager.free.shape[0] - 1
    keep = (_per_row(frontier, b, dev).clamp(min=1) - 1) // page_size
    col = torch.arange(max_blocks, device=dev)[None, :]
    give = mask[:, None] & (block_table >= 0) & (col > keep[:, None])
    pages = torch.where(give, block_table.long(), n_pages).reshape(-1)
    dec = torch.zeros_like(pager.rc).index_add_(
        0, pages, torch.ones_like(pages, dtype=pager.rc.dtype))
    rc = pager.rc - dec
    freed = ((pager.rc > 0) & (rc <= 0) & (dec > 0))[:n_pages]
    rc = rc.clamp(min=0)
    free, top = _push_freed(pager.free, pager.top, freed)
    return PagerState(free, top, rc), torch.where(give, -1, block_table)

def share_prefix(
    pager: PagerState,
    block_table: torch.Tensor,   # (B, max_blocks) int32
    src,                         # (B,) int: donor row per admitted row
    nblk,                        # (B,) int: leading blocks to share
    mask: torch.Tensor,          # (B,) bool: rows being admitted
) -> Tuple[PagerState, torch.Tensor]:
    """Map the donor rows' first ``nblk`` blocks into the masked rows and
    bump the shared pages' refcounts (duplicates accumulate: two rows
    sharing one donor page raise it by two).  ``nblk == 0`` rows are
    untouched, unmapped donor entries skipped; the bumps of skipped
    entries land on the sentinel's count."""
    b, max_blocks = block_table.shape
    dev = block_table.device
    n_pages = pager.free.shape[0] - 1
    donor = block_table.index_select(0, _per_row(src, b, dev).clamp(0, b - 1))
    col = torch.arange(max_blocks, device=dev)[None, :]
    take = (mask[:, None] & (col < _per_row(nblk, b, dev)[:, None])
            & (donor >= 0))
    block_table = torch.where(take, donor, block_table)
    pages = torch.where(take, donor.long(), n_pages).reshape(-1)
    rc = pager.rc.index_add(0, pages, torch.ones_like(pages,
                                                      dtype=pager.rc.dtype))
    return PagerState(pager.free, pager.top, rc), block_table


def spill_rows(
    pager: PagerState,
    table: torch.Tensor,         # (B, max_blocks) int32: device-tier table
    hpager: PagerState,          # host-tier allocator (n_slots + 1 entries)
    htable: torch.Tensor,        # (B, max_blocks) int32: host-tier table
    mask: torch.Tensor,          # (B,) bool: victim rows
):
    """Move the masked rows' mapped blocks to the host tier (preemption):
    pop a host slot for every mapped block (rows and blocks ranked in
    flattened row-major order, popping ``free[top - 1 - rank]``), record
    it in the host table with ``rc`` 1 (a private copy, even of a page a
    prefix-sharing peer still maps), then release the device pages
    (``release_rows``: a page a peer still references stays resident).
    Returns ``(pager, table, hpager, htable, src, dst)``: ``src`` /
    ``dst`` are the flattened ``(B * max_blocks,)`` int64 ids of the move
    (device page to read, host slot to fill), the sentinels where a block
    did not move; ``copy_pages`` moves the data (the release touches only
    bookkeeping, so copying after it is safe).  A dry pop skips the block
    (worst-case sizing rules it out); its rc write lands on the
    sentinel's entry."""
    b, max_blocks = table.shape
    n_pages = pager.free.shape[0] - 1
    n_slots = hpager.free.shape[0] - 1
    give = mask[:, None] & (table >= 0) & (htable < 0)
    flat = give.reshape(-1)
    rank = torch.cumsum(flat, 0) - 1
    grant = flat & (rank < hpager.top)
    sidx = (hpager.top - 1 - rank).clamp(0, max(n_slots - 1, 0))
    slot = torch.where(grant, hpager.free.index_select(0, sidx), n_slots)
    h_top = hpager.top - grant.sum(dtype=torch.int32)
    h_rc = hpager.rc.index_put(
        (slot.long(),), torch.ones((), dtype=hpager.rc.dtype,
                                   device=slot.device))
    htable = torch.where(grant.reshape(b, max_blocks),
                         slot.reshape(b, max_blocks), htable)
    src = torch.where(grant, table.reshape(-1).long(), n_pages)
    pager, table = release_rows(pager, table, mask)
    return (pager, table, PagerState(hpager.free, h_top, h_rc), htable, src,
            slot.long())


def restore_rows(
    pager: PagerState,
    table: torch.Tensor,         # (B, max_blocks) int32: device-tier table
    hpager: PagerState,          # host-tier allocator (n_slots + 1 entries)
    htable: torch.Tensor,        # (B, max_blocks) int32: host-tier table
    mask: torch.Tensor,          # (B,) bool: rows to bring back
):
    """The mirror of ``spill_rows``: pop a device page for every host-table
    entry of the masked rows (the same flattened ranking), set its rc to
    1 (a restored row owns its pages even where it used to share), then
    release the host slots.  Returns ``(pager, table, hpager, htable,
    src, dst)`` with ``src`` the host slots to read and ``dst`` the fresh
    device pages to fill, the sentinels where a block did not move.  The
    engine's reservation ledger re-reserves the row's worst case before
    this runs, so the device pops do not run dry."""
    b, max_blocks = table.shape
    n_pages = pager.free.shape[0] - 1
    n_slots = hpager.free.shape[0] - 1
    take = mask[:, None] & (htable >= 0) & (table < 0)
    flat = take.reshape(-1)
    rank = torch.cumsum(flat, 0) - 1
    grant = flat & (rank < pager.top)
    pidx = (pager.top - 1 - rank).clamp(0, max(n_pages - 1, 0))
    page = torch.where(grant, pager.free.index_select(0, pidx), n_pages)
    top = pager.top - grant.sum(dtype=torch.int32)
    rc = pager.rc.index_put(
        (page.long(),), torch.ones((), dtype=pager.rc.dtype,
                                   device=page.device))
    table = torch.where(grant.reshape(b, max_blocks),
                        page.reshape(b, max_blocks), table)
    src = torch.where(grant, htable.reshape(-1).long(), n_slots)
    hpager, htable = release_rows(hpager, htable, mask)
    return (PagerState(pager.free, top, rc), table, hpager, htable, src,
            page.long())


def cow_on_write(
    pager: PagerState,
    block_table: torch.Tensor,             # (B, max_blocks) int32
    idx,                                   # () or (B,): position written
    active: Optional[torch.Tensor] = None,  # (B,) bool; None = all rows
    *,
    page_size: int,
):
    """Un-share the page each active row is about to write: a row whose
    target block maps a page with ``rc > 1`` pops a fresh page (rows
    ranked by batch index, as ``alloc_on_write``), swaps its block-table
    entry, sets the fresh page's refcount to 1 and drops its ref on the
    shared page; a ref that reaches 0 (every holder moved at once) pushes
    the page back.  Returns ``(pager, block_table, src, dst, limit,
    moved)``: copy slots ``[0, limit)`` of page ``src`` into ``dst``
    (``copy_page_prefix``) before the write; rows that did not move have
    the sentinel in ``src`` and ``dst``.  A dry pop leaves the row on the
    shared page (admission reserves one spare page per fully shared
    prompt, so it does not happen)."""
    b, max_blocks = block_table.shape
    dev = block_table.device
    n_pages = pager.free.shape[0] - 1
    idx_b = _per_row(idx, b, dev)
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)
    blk = idx_b // page_size
    blk_c = blk.clamp(0, max_blocks - 1)
    cur = block_table.gather(1, blk_c[:, None])[:, 0]
    shared = (active & (blk < max_blocks) & (cur >= 0)
              & (pager.rc.index_select(0, cur.long().clamp(0, n_pages))
                 > 1))
    rank = torch.cumsum(shared, 0) - 1
    grant = shared & (rank < pager.top)
    slot = (pager.top - 1 - rank).clamp(0, max(n_pages - 1, 0))
    fresh = torch.where(grant, pager.free.index_select(0, slot), cur)
    col = torch.arange(max_blocks, device=dev)
    block_table = torch.where(
        grant[:, None] & (col[None, :] == blk_c[:, None]), fresh[:, None],
        block_table,
    )
    top = pager.top - grant.sum(dtype=torch.int32)
    old = torch.where(grant, cur.long(), n_pages)
    dec = torch.zeros_like(pager.rc).index_add_(
        0, old, torch.ones_like(old, dtype=pager.rc.dtype))
    rc = pager.rc - dec
    orphaned = ((pager.rc > 0) & (rc <= 0) & (dec > 0))[:n_pages]
    dst = torch.where(grant, fresh.long(), n_pages)
    rc = rc.clamp(min=0).index_put(
        (dst,), torch.ones((), dtype=rc.dtype, device=dev))
    free, top = _push_freed(pager.free, top, orphaned)
    return (PagerState(free, top, rc), block_table, old, dst,
            idx_b % page_size, grant)


def copy_page_prefix(
    pool: torch.Tensor,   # (stacks, n_pages + 1, page_size, Hkv, hd)
    src: torch.Tensor,    # (B,) page ids (the sentinel: row did not move)
    dst: torch.Tensor,    # (B,) page ids (the sentinel: row did not move)
    limit: torch.Tensor,  # (B,): copy slots [0, limit)
) -> None:
    """The CoW data move, in place: each moved row's written slot prefix
    from its old page to its fresh one across every layer slab; slots at
    and above ``limit`` are zeroed (garbage by the sequential-write
    contract, never read).  Rows that did not move copy the sentinel page
    onto itself."""
    page_size = pool.shape[2]
    content = pool.index_select(1, src)          # (stacks, B, S, ...)
    keep = (torch.arange(page_size, device=pool.device)[None, :]
            < limit[:, None])
    content = torch.where(keep[None, :, :, None, None], content,
                          torch.zeros((), dtype=pool.dtype,
                                      device=pool.device))
    pool.index_copy_(1, dst, content)


def copy_page_scale(
    scales: torch.Tensor,  # (stacks, n_pages + 1, Hkv) f32
    src: torch.Tensor,     # (B,) page ids (the sentinel: row did not move)
    dst: torch.Tensor,     # (B,) page ids (the sentinel: row did not move)
) -> None:
    """The CoW scale move, in place: the fresh page inherits its donor's
    per-(page, head) scales, so the prefix ``copy_page_prefix`` moved
    dequantizes bit for bit."""
    scales.index_copy_(1, dst, scales.index_select(1, src))


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
