"""Attention — Hopper kernels for decode and chunked prefill over the
contiguous slab or the paged pool (of the model's dtype, bf16 under an f32
model, or int8 with per-(page, head) scales), and for the full forward.

Replaces ``repro/kernels/flash_attention.py``'s ``flash_decode_pallas``,
``flash_decode_paged_pallas``, ``flash_decode_paged_quant_pallas``,
``flash_prefill_chunk_pallas``, ``flash_prefill_chunk_paged_pallas``,
``flash_prefill_chunk_paged_quant_pallas``, ``flash_attention_pallas`` and
``flash_attention_bwd_pallas``.  The first seven launch one kernel template
(``csrc/flash_attention.cu``) wherever no redesigned route below takes
them: one block per (row, kv head, tile of 8 query rows) walks the valid
key range in tiles with an f32 online softmax, the GQA group folded into
the block's rows.  The caches and pools are read in
place by their strides (the TPU wrappers transposed them on every call);
the paged kernels resolve each key's page from the block table inside the
block.  Keys past a row's position, before its window or in unmapped
pages are masked, tiles with no live key are skipped, and a row with no
valid key returns zeros.  The forward is the chunk walk with query ``i``
at position ``i`` over ``k``/``v`` themselves, causal or not, and also
writes the log-sum-exp of each query row's scaled scores.  K/V tiles are
upcast to f32 as they are loaded; an int8 pool's scale for the key's
(page, head) is multiplied in right there, so scores and the softmax stay
f32.  Bound by bytes (each live K/V element read once per query-row
tile).

The kernel trusts the block table: every entry is -1 or a page of the
pool (the pager never maps the sentinel page).

The training backward recomputes p from the forward's lse in two passes,
dq over query tiles and dk/dv over key tiles.  ``bwd_plan`` picks its
kernels from the dtype, head dim and strides: in bf16 at head dims that
are multiples of 16 up to 128 the tensor-core kernels of
``csrc/flash_attention_bwd_tc.cu`` (64-row tiles on mma.sync, the GQA
group's dk/dv partials summed in order by a third kernel); in f32, or at
any other bf16 shape, the scalar kernels of ``csrc/flash_attention_bwd.cu``
(IEEE f32, the GQA group summed inside the block).  ``dq_key_tiles`` and
``dkv_query_tiles`` are the tile walks of the tensor-core kernels.

Seven kernels also have redesigned routes beside the template, each picked
by a pure-Python planner from dtype, head dim and alignment (never by
trying a kernel).  The forward: ``fwd_plan`` sends bf16 at head dims that
are multiples of 16 up to 128 to ``csrc/flash_attention_tc.cu`` (64 query
rows a block on mma.sync, the key tiles of ``dq_key_tiles``, P rounded to
bf16 before PV, as the backward does); f32 and every other shape keep the
template's forward mode (IEEE f32).  The three decodes (the contiguous
slab, the pool of the model's dtype, the int8 pool): ``decode_plan`` sends
bf16 queries at those head dims, over bf16 or int8 K/V whose strides and
bases the 16-byte copies can follow, to ``csrc/flash_decode_split.cu``:
the keys split into ``decode_splits`` runs of block-table entries (or of
32-key tiles of the slab), fixed from shapes only, so no host sync, one
block per (row, kv head, split) writing an f32 partial (m, l, acc), and a
second kernel merging the partials in split order; f32 queries (phase
5's token identity and JAX's f32 parity rest on the template's order),
the bf16 pool under them included, keep the template.  The three chunked
prefills (the contiguous slab, the bf16 pool, the int8 pool):
``chunk_plan`` sends bf16 queries at those head dims and alignments to
``csrc/flash_chunk_tc.cu``, templated over storage and addressing as the
split decode is: a warp a q head's 16 chunk tokens on mma.sync,
``chunk_rows`` such items of one (row, kv head) a block sharing its
32-key K/V tiles (a pool's keys resolving their pages one by one), an
int8 tile widened to bf16 exactly with the page scales on S's and P's
columns in f32, P rounded to bf16 before PV, and the key tiles split
into ``chunk_splits`` runs (shapes only) merged in split order as the
decodes' partials are; f32 queries, over a bf16 pool too, keep the
template.  Each routed wrapper counts its launches per route in
``routes`` beside ``launches``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import DTYPES, INT8

MAX_HEAD_DIM = 128

# the tensor-core backward's tile: query rows of the dq kernel's block,
# keys of the dk/dv kernel's (csrc/flash_attention_bwd_tc.cu kT); the
# tensor-core forward's blocks and key tiles are the dq kernel's
BWD_TILE = 64
BWD_ROUTES = ("tc", "scalar")
FWD_ROUTES = ("tc", "scalar")
DECODE_ROUTES = ("split", "template")
# the blocks the split decode's splits aim for.  Swept on the H100
# (chip_smoke.py phase 3): qwen2.5-3b's 8 (row, kv head) pairs run fastest
# in 8 splits, mixtral-8x7b's 32 in 4 and zamba2-2.7b's 128 unsplit (a
# second split costs the combine's launch more than it saves), which a
# target just under the 132 SMs gives
DECODE_BLOCKS = 128
# the split decode's key tile, and the page it cuts the contiguous slab into
SPLIT_TILE = 32
CHUNK_ROUTES = ("tc", "template")
# the tensor-core chunk kernel (csrc/flash_chunk_tc.cu): keys a tile,
# query rows an item (a q head's 16 chunk tokens), the items a block folds
# at most, and the blocks its splits aim for.  Swept on the H100
# (chip_smoke.py phase 3, "chunk sweep"): qwen2.5-3b's and mixtral-8x7b's
# groups run fastest with a split a 32-key tile, zamba2-2.7b's 128 blocks
# unsplit; a cap of 4 items is within 4% of the best cap at each (the
# source's note gives the times)
CHUNK_TILE = 32
CHUNK_ROWS = 16
CHUNK_WARPS = 4
CHUNK_BLOCKS = 128


def _tc_shape(dtype: torch.dtype, d: int, aligned: bool) -> bool:
    return (dtype == torch.bfloat16 and d % 16 == 0
            and 16 <= d <= MAX_HEAD_DIM and aligned)


def bwd_plan(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The backward's route: "tc" (the tensor-core kernels) for bf16 with
    a head dim that is a multiple of 16 up to 128 and operands the 16-byte
    copies can follow (``aligned``: 16-byte aligned bases, unit stride on
    D, every other stride a multiple of 8); "scalar" (IEEE f32 arithmetic)
    for f32 and every other shape."""
    return "tc" if _tc_shape(dtype, d, aligned) else "scalar"


def fwd_plan(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The forward's route, by ``bwd_plan``'s rule: "tc"
    (``csrc/flash_attention_tc.cu``) for bf16 at a head dim that is a
    multiple of 16 up to 128 with ``aligned`` operands; "scalar" (the
    template's forward mode, IEEE f32) for f32 and every other shape."""
    return "tc" if _tc_shape(dtype, d, aligned) else "scalar"


def decode_plan(dtype: torch.dtype, kv_dtype: torch.dtype, d: int,
                aligned: bool) -> str:
    """The decodes' route: "split" (``csrc/flash_decode_split.cu``) for
    bf16 queries at a head dim that is a multiple of 16 up to 128 over
    int8 or bf16 K/V the 16-byte copies can follow (``aligned``: 16-byte
    aligned bases, the strides of all but the head dim multiples of 16
    bytes: 16 int8, 8 bf16 elements); "template" for f32 queries (their
    token identity rests on the template's summation order), over a bf16
    pool too, and every other shape."""
    return ("split" if kv_dtype in (torch.int8, torch.bfloat16)
            and _tc_shape(dtype, d, aligned) else "template")


def decode_splits(b: int, hkv: int, max_blocks: int,
                  page: int) -> Tuple[int, int]:
    """(n_split, pages_per_split) of the split decode, from shapes only
    (never the lengths: no host sync): enough splits of the ``max_blocks``
    pages that the ``b * hkv * n_split`` blocks come near
    ``DECODE_BLOCKS``, and no split empty.  Split ``i`` owns pages
    ``[i * pps, min((i + 1) * pps, max_blocks))``: block-table entries of
    a pool, or on the contiguous slab the ``ceil(Smax / SPLIT_TILE)``
    tiles of ``SPLIT_TILE`` keys (``page = SPLIT_TILE``, the last tile
    ragged).  ``page`` does not move the split (a split's pages are walked
    in 32-key tiles whatever their size)."""
    want = max(1, -(-DECODE_BLOCKS // max(b * hkv, 1)))
    pps = max(1, -(-max_blocks // want))
    return max(1, -(-max_blocks // pps)), pps


def chunk_plan(dtype: torch.dtype, kv_dtype: torch.dtype, d: int,
               aligned: bool, paged: bool) -> str:
    """The chunked prefills' route: "tc" (``csrc/flash_chunk_tc.cu``) for
    bf16 queries at a head dim that is a multiple of 16 up to 128 over the
    bf16 slab, or a bf16 or int8 pool, whose bases and strides the 16-byte
    copies can follow (``aligned``: q's and the K/V's, as
    ``decode_plan``); "template" for f32 queries (their token identity
    rests on the template's summation order), over a bf16 pool too, and
    every other shape."""
    store = kv_dtype in ((torch.bfloat16, torch.int8) if paged
                         else (torch.bfloat16,))
    return "tc" if store and _tc_shape(dtype, d, aligned) else "template"


def chunk_rows(g: int, c: int) -> Tuple[int, int]:
    """(warps, row blocks) of the tensor-core chunk kernel for a GQA group
    of ``g`` and a chunk of ``c`` tokens: its ``g * ceil(c / 16)`` items
    (a q head's 16 tokens each) of a (row, kv head) in blocks of up to
    ``CHUNK_WARPS``, never more warps than items."""
    items = g * -(-c // CHUNK_ROWS)
    warps = max(1, min(CHUNK_WARPS, items))
    return warps, -(-items // warps)


def chunk_splits(b: int, hkv: int, row_blocks: int,
                 n_keys: int) -> Tuple[int, int]:
    """(n_split, tiles_per_split) of the tensor-core chunk kernel, from
    shapes only (never ``start``/``width``: no host sync): the
    ``ceil(n_keys / CHUNK_TILE)`` key tiles (``n_keys``: the slab's Smax,
    or a pool's ``max_blocks * page``) cut into enough runs that the
    ``b * hkv * row_blocks * n_split`` blocks come near ``CHUNK_BLOCKS``,
    and no run empty.  Split ``i`` owns tiles ``[i * tps, min((i + 1) *
    tps, n_tiles))``."""
    n_tiles = -(-n_keys // CHUNK_TILE)
    want = max(1, -(-CHUNK_BLOCKS // max(b * hkv * row_blocks, 1)))
    tps = max(1, -(-n_tiles // want))
    return max(1, -(-n_tiles // tps)), tps


def dq_key_tiles(q0: int, sq: int, sk: int, causal: bool,
                 window: Optional[int], tile: int = BWD_TILE) -> range:
    """The first keys of the key tiles that the query tile starting at
    ``q0`` walks (query ``i`` at position ``i``): up to its last row under
    a causal mask, from its first row's window on; pairs inside a tile
    that the mask hides are masked there."""
    hi = min(sk, q0 + tile, sq) if causal else sk
    lo = max(0, q0 - window + 1) if window is not None else 0
    return range((lo // tile) * tile, hi, tile)


def dkv_query_tiles(k0: int, sq: int, sk: int, causal: bool,
                    window: Optional[int], tile: int = BWD_TILE) -> range:
    """The first query rows of the query tiles that the key tile starting
    at ``k0`` walks: from its first key under a causal mask, up to the
    last query whose window reaches its last key."""
    lo = k0 if causal else 0
    hi = min(sq, k0 + tile - 1 + window) if window is not None else sq
    return range((lo // tile) * tile, hi, tile)

Scales = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _check(name: str, q4: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scales: Scales = None, paged: bool = False) -> None:
    """What every kernel of the template takes: (B, C, Hq, D) queries
    against 4-d keys and values of the same head dim, Hq a multiple of
    their heads, D <= 128 with unit stride, one device.  K/V share one
    storage dtype: the query's; on a ``paged`` pool also bf16 under f32
    queries, or (with ``scales``, f32 (P, Hkv) pools) int8; nothing
    else."""
    d, hq = q4.shape[3], q4.shape[2]
    if k.dim() != 4 or v.shape != k.shape or k.shape[3] != d \
            or hq % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q4.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM} not "
                         "supported")
    if scales is not None and not paged:
        raise ValueError(f"{name}: scales need a block table")
    if scales is None:
        kv_ok = k.dtype == q4.dtype or (paged and q4.dtype == torch.float32
                                        and k.dtype == torch.bfloat16)
    else:
        kv_ok = k.dtype == torch.int8
    if q4.dtype not in DTYPES or v.dtype != k.dtype or not kv_ok:
        raise TypeError(f"{name}: dtypes {q4.dtype}, {k.dtype}, {v.dtype}"
                        f"{' with' if scales is not None else ' without'} "
                        "scales")
    if q4.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{name}: head dim needs unit stride")
    if k.device != q4.device or v.device != q4.device:
        raise ValueError(f"{name}: q, k and v on different devices")
    if scales is not None:
        ksc, vsc = scales
        want = (k.shape[0], k.shape[2])
        if (ksc.dtype != torch.float32 or vsc.dtype != torch.float32
                or tuple(ksc.shape) != want or tuple(vsc.shape) != want
                or ksc.stride() != vsc.stride()
                or ksc.device != q4.device or vsc.device != q4.device):
            raise ValueError(
                f"{name}: scales {tuple(ksc.shape)} {ksc.dtype}, "
                f"{tuple(vsc.shape)} {vsc.dtype} need two f32 {want} pools "
                "of one layout on q's device")


def _check_table(name: str, block_table: torch.Tensor, b: int,
                 device: torch.device) -> None:
    if (block_table.dtype != torch.int32 or block_table.dim() != 2
            or block_table.shape[0] != b or block_table.stride(1) != 1
            or block_table.device != device):
        raise ValueError(
            f"{name}: block table {tuple(block_table.shape)} "
            f"{block_table.dtype} on {block_table.device} needs (B, "
            "max_blocks) int32 with unit column stride on q's device")


def _launch(name: str, q4: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out4: torch.Tensor, pos0: torch.Tensor,
            width: Optional[torch.Tensor],
            block_table: Optional[torch.Tensor], window: Optional[int],
            scale: Optional[float], scales: Scales = None) -> None:
    """Check and launch ``repro_attention``.  ``q4``/``out4`` are
    (B, C, Hq, D) views; ``k``/``v`` the (B, Smax, Hkv, D) cache or the
    (P, page, Hkv, D) pool (with ``block_table``; an int8 pool also with
    its (P, Hkv) ``scales``)."""
    _build.guard_grad(name, q4, k, v)
    _check(name, q4, k, v, scales, paged=block_table is not None)
    b, c, hq, d = q4.shape
    if block_table is None:
        n_keys, page, bt, bt_sb = k.shape[1], 1, None, 0
    else:
        _check_table(name, block_table, b, q4.device)
        page = k.shape[1]
        n_keys = block_table.shape[1] * page
        bt, bt_sb = block_table.data_ptr(), block_table.stride(0)
    if out4.numel() == 0:
        return
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if scales is None:
        ksc = vsc = None
        sc_sp = sc_sh = 0
        kv_dtype = DTYPES[k.dtype]
    else:
        ksc, vsc = scales[0].data_ptr(), scales[1].data_ptr()
        sc_sp, sc_sh = scales[0].stride()
        kv_dtype = INT8
    rc = _build.lib().repro_attention(
        q4.data_ptr(), k.data_ptr(), v.data_ptr(), out4.data_ptr(),
        pos0.data_ptr(), None if width is None else width.data_ptr(), bt,
        ksc, vsc, b, k.shape[2], hq // k.shape[2], c, d, n_keys, page, bt_sb,
        q4.stride(0), q4.stride(1), q4.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out4.stride(0), out4.stride(1), out4.stride(2), sc_sp, sc_sh,
        -1 if window is None else int(window), float(scale),
        DTYPES[q4.dtype], kv_dtype,
        torch.cuda.current_stream(q4.device).cuda_stream,
    )
    _build.check(rc, name)


def _decode(name, q, k, v, cache_len, block_table, window, scale,
            scales=None):
    if q.dim() != 3:
        raise ValueError(f"{name}: q {tuple(q.shape)} is not (B, Hq, D)")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(name, q.unsqueeze(1), k, v, out.unsqueeze(1),
            ref._rows(cache_len, q.shape[0], q.device).contiguous(), None,
            block_table, window, scale, scales)
    return out


def _decode_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``decode_plan``'s route for q against these K/V (16-byte copies:
    strides of ``16 // element size`` elements)."""
    return decode_plan(q.dtype, k.dtype, q.shape[-1], _build.aligned16(
        k, v, elems=16 // k.element_size()))


def _decode_split(name, q, k, v, cache_len, block_table, window, scale,
                  scales=None):
    """Check and launch ``repro_flash_decode_split``: q (B, Hq, D) bf16
    against the (B, Smax, Hkv, D) slab or, through the block table, the
    (P, page, Hkv, D) pool (an int8 one with its (P, Hkv) ``scales``); the
    splits of ``decode_splits``, and their f32 partials in scratch when
    there are several."""
    _build.guard_grad(name, q, k, v)
    if q.dim() != 3:
        raise ValueError(f"{name}: q {tuple(q.shape)} is not (B, Hq, D)")
    paged = block_table is not None
    _check(name, q.unsqueeze(1), k, v, scales, paged=paged)
    b, hq, d = q.shape
    hkv = k.shape[2]
    if paged:
        _check_table(name, block_table, b, q.device)
        page, max_blocks = k.shape[1], block_table.shape[1]
        n_keys, bt = max_blocks * page, block_table.data_ptr()
        bt_sb = block_table.stride(0)
    else:
        if k.shape[0] != b:
            raise ValueError(f"{name}: cache {tuple(k.shape)} for q "
                             f"{tuple(q.shape)}")
        page, n_keys, bt, bt_sb = SPLIT_TILE, k.shape[1], None, 0
        max_blocks = -(-n_keys // page)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    n_split, pps = decode_splits(b, hkv, max_blocks, page)
    part = (None, None, None)
    if n_split > 1:
        # one f32 scratch allocation, held until the launch is enqueued
        # (the wrapper's host time is on the serving step's path): acc
        # (B, Hq, n_split, D), then m and l (B, Hq, n_split)
        rows = b * hq * n_split
        scratch = torch.empty(rows * (d + 2), dtype=torch.float32,
                              device=q.device)
        base = scratch.data_ptr()
        part = (base + 4 * rows * d, base + 4 * rows * (d + 1), base)
    if scales is None:
        ksc = vsc = None
        sc_sp = sc_sh = 0
    else:
        ksc, vsc = scales[0].data_ptr(), scales[1].data_ptr()
        sc_sp, sc_sh = scales[0].stride()
    lens = ref._rows(cache_len, b, q.device).contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rc = _build.lib().repro_flash_decode_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ksc, vsc, lens.data_ptr(),
        bt, out.data_ptr(), *part,
        b, hkv, hq // hkv, d, n_keys, page, max_blocks, pps, n_split, bt_sb,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), sc_sp, sc_sh, out.stride(0),
        out.stride(1), -1 if window is None else int(window), float(scale),
        INT8 if scales is not None else DTYPES[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, name)
    return out


def _routed_decode(fn, q, k, v, cache_len, block_table, window, scale,
                   scales=None):
    """The decode of wrapper ``fn`` on the route ``decode_plan`` picks,
    counted in ``fn.launches`` and ``fn.routes``."""
    route = _decode_route(q, k, v)
    launch = _decode_split if route == "split" else _decode
    out = launch(fn.__name__, q, k, v, cache_len, block_table, window,
                 scale, scales)
    fn.launches += 1
    fn.routes[route] += 1
    return out


def _chunk(name, q, k, v, start, width, block_table, window, scale,
           scales=None):
    if q.dim() != 4:
        raise ValueError(f"{name}: q {tuple(q.shape)} is not (B, C, Hq, D)")
    b = q.shape[0]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(name, q, k, v, out, ref._rows(start, b, q.device).contiguous(),
            ref._rows(width, b, q.device).contiguous(), block_table, window,
            scale, scales)
    return out


def _chunk_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 paged: bool) -> str:
    """``chunk_plan``'s route for q against these K/V (16-byte copies of
    q and of the K/V: strides of ``16 // element size`` elements)."""
    aligned = (_build.aligned16(q, elems=16 // q.element_size())
               and _build.aligned16(k, v, elems=16 // k.element_size()))
    return chunk_plan(q.dtype, k.dtype, q.shape[-1], aligned, paged)


def _chunk_tc(name, q, k, v, start, width, block_table, window, scale,
              scales=None):
    """Check and launch ``repro_flash_chunk_tc``: q (B, C, Hq, D) bf16
    against the (B, Smax, Hkv, D) slab or, through the block table, the
    (P, page, Hkv, D) bf16 pool or int8 pool with its (P, Hkv)
    ``scales``; the rows of ``chunk_rows``, the splits of
    ``chunk_splits``, and their f32 partials in scratch when there are
    several."""
    _build.guard_grad(name, q, k, v)
    if q.dim() != 4:
        raise ValueError(f"{name}: q {tuple(q.shape)} is not (B, C, Hq, D)")
    paged = block_table is not None
    _check(name, q, k, v, scales, paged=paged)
    b, c, hq, d = q.shape
    hkv = k.shape[2]
    if paged:
        _check_table(name, block_table, b, q.device)
        page, n_keys = k.shape[1], block_table.shape[1] * k.shape[1]
        bt, bt_sb = block_table.data_ptr(), block_table.stride(0)
    else:
        if k.shape[0] != b:
            raise ValueError(f"{name}: cache {tuple(k.shape)} for q "
                             f"{tuple(q.shape)}")
        page, n_keys, bt, bt_sb = 1, k.shape[1], None, 0
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    warps, n_rb = chunk_rows(hq // hkv, c)
    n_split, tps = chunk_splits(b, hkv, n_rb, n_keys)
    part = (None, None, None)
    if n_split > 1:
        # one f32 scratch allocation, held until the launch is enqueued:
        # acc (B, C, Hq, n_split, D), then m and l (B, C, Hq, n_split)
        rows = b * c * hq * n_split
        scratch = torch.empty(rows * (d + 2), dtype=torch.float32,
                              device=q.device)
        base = scratch.data_ptr()
        part = (base + 4 * rows * d, base + 4 * rows * (d + 1), base)
    if scales is None:
        ksc = vsc = None
        sc_sp = sc_sh = 0
    else:
        ksc, vsc = scales[0].data_ptr(), scales[1].data_ptr()
        sc_sp, sc_sh = scales[0].stride()
    starts = ref._rows(start, b, q.device).contiguous()
    widths = ref._rows(width, b, q.device).contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rc = _build.lib().repro_flash_chunk_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ksc, vsc,
        starts.data_ptr(), widths.data_ptr(), bt, out.data_ptr(), *part,
        b, hkv, hq // hkv, c, d, n_keys, page, warps, tps, n_split, bt_sb,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2), sc_sp, sc_sh,
        out.stride(0), out.stride(1), out.stride(2),
        -1 if window is None else int(window), float(scale),
        INT8 if scales is not None else DTYPES[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, name)
    return out


def _routed_chunk(fn, q, k, v, start, width, block_table, window, scale,
                  scales=None):
    """The chunked prefill of wrapper ``fn`` on the route ``chunk_plan``
    picks, counted in ``fn.launches`` and ``fn.routes``."""
    route = _chunk_route(q, k, v, block_table is not None)
    launch = _chunk_tc if route == "tc" else _chunk
    out = launch(fn.__name__, q, k, v, start, width, block_table, window,
                 scale, scales)
    fn.launches += 1
    fn.routes[route] += 1
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len, *,
                 window: Optional[int] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Hq,D) against a (B,Smax,Hkv,D) cache; ``cache_len`` () or (B,);
    on the kernel ``decode_plan`` picks.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if not q.is_cuda:
        return ref.attention_decode(q, k_cache, v_cache, cache_len,
                                    window=window, scale=scale)
    return _routed_decode(flash_decode, q, k_cache, v_cache, cache_len,
                          None, window, scale)


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, cache_len,
                       block_table: torch.Tensor, *,
                       window: Optional[int] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Hq,D) against a (P,page,Hkv,D) pool (of q's dtype, or bf16
    under f32 queries) through a (B,max_blocks) int32 block table, on the
    kernel ``decode_plan`` picks.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if not q.is_cuda:
        return ref.attention_decode_paged(q, k_pages, v_pages, cache_len,
                                          block_table, window=window,
                                          scale=scale)
    return _routed_decode(flash_decode_paged, q, k_pages, v_pages,
                          cache_len, block_table, window, scale)


def flash_decode_paged_quant(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, cache_len,
                             block_table: torch.Tensor, *,
                             window: Optional[int] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Hq,D) against an int8 (P,page,Hkv,D) pool with f32 (P,Hkv)
    per-(page, head) scales, through the block table; output in
    ``q.dtype``, on the kernel ``decode_plan`` picks.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if not q.is_cuda:
        return ref.attention_decode_paged_quant(
            q, k_pages, v_pages, k_scale, v_scale, cache_len, block_table,
            window=window, scale=scale)
    return _routed_decode(flash_decode_paged_quant, q, k_pages, v_pages,
                          cache_len, block_table, window, scale,
                          (k_scale, v_scale))


def flash_prefill_chunk(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, start, width, *,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q (B,C,Hq,D) against a (B,Smax,Hkv,D) cache holding the chunk's
    K/V; ``start``/``width`` () or (B,); on the kernel ``chunk_plan``
    picks.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if not q.is_cuda:
        return ref.attention_prefill_chunk(q, k_cache, v_cache, start,
                                           width, window=window, scale=scale)
    return _routed_chunk(flash_prefill_chunk, q, k_cache, v_cache, start,
                         width, None, window, scale)


def flash_prefill_chunk_paged(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, start, width,
                              block_table: torch.Tensor, *,
                              window: Optional[int] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """q (B,C,Hq,D) against a (P,page,Hkv,D) pool through the block table;
    every block covering ``start .. start+width-1`` must be mapped; on
    the kernel ``chunk_plan`` picks.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if not q.is_cuda:
        return ref.attention_prefill_chunk_paged(
            q, k_pages, v_pages, start, width, block_table, window=window,
            scale=scale)
    return _routed_chunk(flash_prefill_chunk_paged, q, k_pages, v_pages,
                         start, width, block_table, window, scale)


def flash_prefill_chunk_paged_quant(q: torch.Tensor, k_pages: torch.Tensor,
                                    v_pages: torch.Tensor,
                                    k_scale: torch.Tensor,
                                    v_scale: torch.Tensor, start, width,
                                    block_table: torch.Tensor, *,
                                    window: Optional[int] = None,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """q (B,C,Hq,D) against an int8 pool with its f32 (P,Hkv) scales
    through the block table; every block covering ``start ..
    start+width-1`` must be mapped; on the kernel ``chunk_plan`` picks.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if not q.is_cuda:
        return ref.attention_prefill_chunk_paged_quant(
            q, k_pages, v_pages, k_scale, v_scale, start, width,
            block_table, window=window, scale=scale)
    return _routed_chunk(flash_prefill_chunk_paged_quant, q, k_pages,
                         v_pages, start, width, block_table, window, scale,
                         (k_scale, v_scale))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,Sq,Hq,D) against k/v (B,Sk,Hkv,D) -> (out (B,Sq,Hq,D) in
    ``q.dtype``, lse (B,Hq,Sq) f32); query ``i`` sits at position ``i``,
    on the kernel ``fwd_plan`` picks.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if not q.is_cuda:
        return ref.mha_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
    name = "flash_attention"
    _build.guard_grad(name, q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}")
    _check(name, q, k, v)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    route = fwd_plan(q.dtype, d, _build.aligned16(q, k, v))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, hkv, hq // hkv, sq, sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            lse.stride(0), lse.stride(1), int(causal),
            -1 if window is None else int(window), float(scale))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "tc":
        rc = _build.lib().repro_flash_attention_tc(*args, stream)
    else:
        rc = _build.lib().repro_flash_attention(*args, DTYPES[q.dtype],
                                                stream)
    _build.check(rc, name)
    flash_attention.launches += 1
    flash_attention.routes[route] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``flash_attention`` from its ``out`` and ``lse``
    and the output gradient ``do`` (B,Sq,Hq,D) -> (dq (B,Sq,Hq,D), dk, dv
    (B,Sk,Hkv,D)) in the dtype of q: a dq pass that also writes dd =
    rowsum(do * out), then a dk/dv pass, on the kernels ``bwd_plan``
    picks.  CPU tensors take the plain version; CUDA tensors launch the
    kernels or raise."""
    if not q.is_cuda:
        return ref.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                       window=window, scale=scale)
    name = "flash_attention_bwd"
    _build.guard_grad(name, q, k, v, out, lse, do)
    if q.dim() != 4 or k.dim() != 4 or k.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}")
    _check(name, q, k, v)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)}, do "
                         f"{tuple(do.shape)} for q {tuple(q.shape)}")
    if out.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"{name}: out {out.dtype}, do {do.dtype} for q "
                        f"{q.dtype}")
    if out.stride(3) != 1 or do.stride(3) != 1:
        raise ValueError(f"{name}: out and do need unit stride on the head "
                         "dim")
    if (lse.shape != (b, hq, sq) or lse.dtype != torch.float32
            or lse.stride(2) != 1):
        raise ValueError(f"{name}: lse {tuple(lse.shape)} {lse.dtype} needs "
                         f"({b}, {hq}, {sq}) float32 with unit stride in Sq")
    if any(t.device != q.device for t in (out, lse, do)):
        raise ValueError(f"{name}: operands on different devices")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dd = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    route = bwd_plan(q.dtype, d, _build.aligned16(q, k, v, out, do))
    args = (b, hkv, hq // hkv, sq, sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            do.stride(0), do.stride(1), do.stride(2),
            dq.stride(0), dq.stride(1), dq.stride(2),
            dk.stride(0), dk.stride(1), dk.stride(2),
            lse.stride(0), lse.stride(1), int(causal),
            -1 if window is None else int(window), float(scale))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "tc":
        # the GQA group's f32 dk/dv partials, one per q head
        part = ((None, None) if hq == hkv else
                tuple(torch.empty((b, sk, hq, d), dtype=torch.float32,
                                  device=q.device) for _ in range(2)))
        rc = _build.lib().repro_flash_attention_bwd_tc(
            *ptrs, *(None if t is None else t.data_ptr() for t in part),
            *args, stream)
    else:
        rc = _build.lib().repro_flash_attention_bwd(
            *ptrs, *args, DTYPES[q.dtype], stream)
    _build.check(rc, name)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.routes[route] += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
# launches per route, beside the total
flash_attention.routes = dict.fromkeys(FWD_ROUTES, 0)
flash_attention_bwd.routes = dict.fromkeys(BWD_ROUTES, 0)
flash_decode.launches = 0
flash_decode_paged.launches = 0
flash_decode_paged_quant.launches = 0
flash_decode.routes = dict.fromkeys(DECODE_ROUTES, 0)
flash_decode_paged.routes = dict.fromkeys(DECODE_ROUTES, 0)
flash_decode_paged_quant.routes = dict.fromkeys(DECODE_ROUTES, 0)
flash_prefill_chunk.launches = 0
flash_prefill_chunk_paged.launches = 0
flash_prefill_chunk_paged_quant.launches = 0
flash_prefill_chunk.routes = dict.fromkeys(CHUNK_ROUTES, 0)
flash_prefill_chunk_paged.routes = dict.fromkeys(CHUNK_ROUTES, 0)
flash_prefill_chunk_paged_quant.routes = dict.fromkeys(CHUNK_ROUTES, 0)
