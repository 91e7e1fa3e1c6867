"""The chunked prefills' route on the CPU, and a plain emulation of what
the tensor-core chunk kernel computes, against the JAX package.

``kernels/flash_attention.py`` picks the route in pure Python, and the
card's kernels follow it: ``chunk_plan`` (bf16 queries at head dims that
are multiples of 16 up to 128 over the bf16 slab, a bf16 pool or an int8
pool the 16-byte copies can follow -> ``csrc/flash_chunk_tc.cu``; f32
queries, over a bf16 pool too, and every other shape -> the template),
``chunk_rows`` (the
16-row items a block folds) and ``chunk_splits`` (runs of 32-key tiles,
from shapes only).  Held here: the routes; rows and splits that cover
every item and every key tile once and in order; the C signature of every
launcher against its ctypes one; and an emulation in plain PyTorch of the
kernel's arithmetic (the block's tile walk, the splits and their ordered
combine, int8 widened exactly with the key scales on S's columns and the
value scales on P's columns in f32, P rounded to bf16 before PV) against
``flash_prefill_chunk_pallas``, ``flash_prefill_chunk_paged_pallas`` and
``flash_prefill_chunk_paged_quant_pallas`` in interpret mode on the same
numpy inputs, within one bf16 ulp of the
largest output: the forward's emulation tolerance, since P rounded to
bf16 moves each term by at most half an ulp and the rest is f32 order.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clear_tuning  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_prefill_chunk_pallas,
    flash_prefill_chunk_paged_pallas,
    flash_prefill_chunk_paged_quant_pallas,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    CHUNK_BLOCKS,
    CHUNK_ROWS,
    CHUNK_TILE,
    _chunk_route,
    chunk_plan,
    chunk_rows,
    chunk_splits,
)

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
NEG = -1e30


# (query dtype, K/V dtype, D, aligned, paged, route): the slab, the bf16
# pool and the int8 pool in bf16 on tc; f32 queries (over a bf16 pool
# too), int8 without a table and every shape off the rule on the template
@pytest.mark.parametrize("dtype,kv,d,aligned,paged,route", [
    (BF16, BF16, 128, True, False, "tc"), (BF16, BF16, 80, True, False, "tc"),
    (BF16, I8, 128, True, True, "tc"), (BF16, I8, 64, True, True, "tc"),
    (BF16, BF16, 128, True, True, "tc"), (BF16, BF16, 80, True, True, "tc"),
    (BF16, BF16, 128, False, True, "template"),
    (BF16, BF16, 72, True, True, "template"),
    (BF16, I8, 128, True, False, "template"),
    (F32, F32, 128, True, False, "template"),
    (F32, I8, 128, True, True, "template"),
    (F32, BF16, 128, True, True, "template"),
    (BF16, BF16, 72, True, False, "template"),
    (BF16, I8, 144, True, True, "template"),
    (BF16, BF16, 128, False, False, "template"),
    (BF16, I8, 80, False, True, "template")])
def test_chunk_plan(dtype, kv, d, aligned, paged, route):
    assert chunk_plan(dtype, kv, d, aligned, paged) == route


def test_chunk_route_of_slabs_and_pools():
    """What the wrappers hand the planner: q and a bf16 slab or pool need
    strides of 8 elements, an int8 pool of 16."""
    q = torch.zeros((4, 16, 16, 80), dtype=BF16)
    slab = torch.zeros((4, 128, 2, 80), dtype=BF16)
    pool = torch.zeros((9, 16, 2, 80), dtype=I8)
    assert _chunk_route(q, slab, slab, False) == "tc"
    assert _chunk_route(q, pool, pool, True) == "tc"
    assert _chunk_route(q, slab, slab, True) == "tc"   # a bf16 pool
    odd_pool = torch.zeros((9, 16, 2, 84), dtype=BF16)[..., :80]
    assert _chunk_route(q, odd_pool, odd_pool, True) == "template"
    assert _chunk_route(q.float(), slab, slab, True) == "template"
    odd = torch.zeros((4, 16, 16, 84), dtype=BF16)[..., :80]
    assert _chunk_route(odd, slab, slab, False) == "template"   # q's 84
    assert _chunk_route(q.float(), pool, pool, True) == "template"


# (G, C): the served groups (qwen 8, zamba2 1, mixtral 4, glm4 16,
# deepseek 7, a group of 32) at chunk 16, and ragged chunks
@pytest.mark.parametrize("g,c", [(8, 16), (1, 16), (4, 16), (16, 16),
                                 (7, 16), (32, 16), (3, 20), (1, 1),
                                 (5, 33)])
def test_chunk_rows_cover_every_item_once(g, c):
    warps, n_rb = chunk_rows(g, c)
    items = g * -(-c // CHUNK_ROWS)
    assert 1 <= warps <= min(8, items)
    assert (n_rb - 1) * warps < items <= n_rb * warps   # no empty block


# (B, Hkv, G, n_keys): qwen2.5-3b, zamba2-2.7b and mixtral-8x7b's served
# shapes (128 keys: the slab or 8 pages of 16), --check's slab, ragged
# and empty key ranges
@pytest.mark.parametrize("b,hkv,g,n_keys", [
    (4, 2, 8, 128), (4, 32, 1, 128), (4, 8, 4, 128), (4, 1, 32, 128),
    (2, 2, 8, 192), (1, 1, 1, 4097), (3, 5, 2, 33), (4, 2, 8, 0),
    (1, 1, 1, 1)])
def test_chunk_splits_cover_every_tile_in_order(b, hkv, g, n_keys):
    _, n_rb = chunk_rows(g, 16)
    n, tps = chunk_splits(b, hkv, n_rb, n_keys)
    n_tiles = -(-n_keys // CHUNK_TILE)
    tiles = [j for i in range(n) for j in range(i * tps,
                                                min((i + 1) * tps, n_tiles))]
    assert tiles == list(range(n_tiles))
    assert n >= 1 and (n - 1) * tps < max(n_tiles, 1)   # no empty split


def test_chunk_splits_at_the_served_shapes():
    # 128 keys (4 tiles) a row: qwen2.5-3b's group of 8 in two blocks of 4
    # q heads and mixtral-8x7b's 4 in one, each split a tile; zamba2-2.7b's
    # 128 blocks of one item unsplit
    assert chunk_rows(8, 16) == (4, 2)
    assert chunk_rows(1, 16) == (1, 1)
    assert chunk_rows(4, 16) == (4, 1)
    assert chunk_splits(4, 2, 2, 128) == (4, 1)
    assert chunk_splits(4, 32, 1, 128) == (1, 4)
    assert chunk_splits(4, 8, 1, 128) == (4, 1)
    # a long row: splits bounded near the target
    n, tps = chunk_splits(4, 2, 2, 4096)
    assert 4 * 2 * 2 * n <= 2 * CHUNK_BLOCKS and n * tps >= 128


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


def _externs():
    src = "\n".join(p.read_text() for p in _build.sources())
    for name, params in re.findall(
            r'extern "C" int (repro_\w+)\(([^)]*)\)', src):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            kinds.append(_CTYPES["void*" if "*" in p else
                                 " ".join(p.split()[:-1])])
        yield name, kinds


def test_every_launcher_matches_its_ctypes_signature():
    """ctypes passes what ``_SIGNATURES`` says: a launcher whose C
    parameters differ would read its arguments shifted on the card."""
    found = dict(_externs())
    assert "repro_flash_chunk_tc" in found
    assert found.keys() == _build._SIGNATURES.keys()
    for name, kinds in found.items():
        assert kinds == _build._SIGNATURES[name], name


def _chunk_tc_emulation(q, k, v, start, width, bt, window, scale, warps,
                        n_split, tps, scales=None):
    """The tensor-core chunk kernel's arithmetic in plain PyTorch: per
    (row, kv head, block of ``warps`` 16-row items, split), the split's
    32-key tiles between the block's lowest window start and highest
    position; per item, S = Q K^T times the key scales in f32, the mask
    (position, window, unmapped page, past the keys), the online softmax
    in f32, P times the value scales rounded to bf16 before PV; an f32
    partial (m, l, acc) a split, merged in split order (one split: acc /
    l).  ``bt`` None: ``k``/``v`` are the (B, Smax, Hkv, D) slab."""
    b, c, hq, d = q.shape
    hkv = k.shape[2]
    g, t = hq // hkv, CHUNK_TILE
    n_items = g * -(-c // CHUNK_ROWS)
    n_rb = -(-n_items // warps)
    if bt is None:
        n_keys = k.shape[1]
    else:
        page = k.shape[1]
        n_keys = bt.shape[1] * page
    pos = torch.arange(n_split * tps * t)
    out = torch.zeros((b, c, hq, d))
    for bi in range(b):
        st, wd = int(start[bi]), int(width[bi])

        def qpos(tok):
            return st + min(min(tok, c - 1), wd - 1)

        valid = pos < n_keys
        if bt is None:
            at = (bi, pos.clamp(max=n_keys - 1))
        else:
            blk = bt[bi, (pos // page).clamp(max=bt.shape[1] - 1)]
            valid &= blk >= 0
            at = (blk.clamp(min=0), pos % page)
        for h in range(hkv):
            kk = torch.where(valid[:, None], k[at + (h,)].float(), 0.0)
            vv = torch.where(valid[:, None], v[at + (h,)].float(), 0.0)
            ks = vs = torch.ones(len(pos))
            if scales is not None:
                ks = torch.where(valid, scales[0][at[0], h], 1.0)
                vs = torch.where(valid, scales[1][at[0], h], 1.0)
            for rb in range(n_rb):
                items = range(rb * warps, min((rb + 1) * warps, n_items))
                q_lo = qpos(items[0] // g * CHUNK_ROWS)
                q_hi = qpos(min((items[-1] // g + 1) * CHUNK_ROWS, c) - 1)
                lo = max(0, q_lo - window + 1) if window is not None else 0
                hi = min(n_keys, q_hi + 1)
                for item in items:
                    ct, gg = divmod(item, g)
                    toks = range(ct * CHUNK_ROWS,
                                 min((ct + 1) * CHUNK_ROWS, c))
                    qp = torch.tensor([qpos(i) for i in toks])[:, None]
                    qr = q[bi, list(toks), h * g + gg].float()
                    parts = []
                    for sp in range(n_split):
                        m = torch.full((len(toks),), NEG)
                        l = torch.zeros(len(toks))
                        acc = torch.zeros((len(toks), d))
                        j_lo = max(sp * tps, lo // t)
                        j_hi = (min((sp + 1) * tps, -(-hi // t))
                                if lo < hi else 0)
                        for j in range(j_lo, j_hi):
                            ky = slice(j * t, (j + 1) * t)
                            kp = pos[ky][None, :]
                            vis = valid[ky][None, :] & (kp <= qp)
                            if window is not None:
                                vis &= kp > qp - window
                            s = (qr @ kk[ky].T) * ks[ky] * scale
                            s = torch.where(vis, s, NEG)
                            m_new = torch.maximum(m, s.max(-1).values)
                            p = torch.where(vis, torch.exp(s - m_new[:, None]),
                                            0.0)
                            alpha = torch.exp(m - m_new)
                            l = l * alpha + p.sum(-1)
                            pv = (p * vs[ky]).to(BF16).float()
                            acc = acc * alpha[:, None] + pv @ vv[ky]
                            m = m_new
                        parts.append((m, l, acc))
                    if n_split == 1:
                        m, l, acc = parts[0]
                        o = acc / torch.where(l == 0, 1.0, l)[:, None]
                    else:
                        live = torch.stack([p_[1] for p_ in parts]) > 0
                        big = torch.where(
                            live, torch.stack([p_[0] for p_ in parts]),
                            NEG).max(0).values
                        L = torch.zeros(len(toks))
                        O = torch.zeros((len(toks), d))
                        for i, (m, l, acc) in enumerate(parts):  # in order
                            w = torch.where(live[i], torch.exp(m - big), 0.0)
                            L = L + l * w
                            O = O + acc * w[:, None]
                        o = torch.where(L[:, None] > 0,
                                        O / torch.where(L == 0, 1.0, L)[:, None],
                                        0.0)
                    out[bi, list(toks), h * g + gg] = o
    return out


def _bf16_valued(rng, shape):
    """Standard normal values rounded to bf16 and held in f32, as the
    kernel reads bf16 queries and a bf16 slab."""
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(BF16).float().numpy()


def _assert_within_one_ulp(got, want):
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= 2 ** -7 * np.abs(want).max()


def _plan(b, hkv, g, c, n_keys, forced):
    """The kernel's (warps, n_split, tiles_per_split): the planner's at
    the shape, or ``forced`` (warps, (n_split, tps))."""
    if forced is None:
        warps, n_rb = chunk_rows(g, c)
        return (warps,) + chunk_splits(b, hkv, n_rb, n_keys)
    return (forced[0],) + forced[1]


# (Hq, Hkv, D, C, Smax, window, forced (warps, (n_split, tps))): G 1, 4
# and 2, D 64 and 80, a short window, two token tiles of a 20-token
# chunk, splits and one-warp blocks forced
SLAB_CASES = [(2, 2, 64, 16, 80, None, None), (4, 1, 80, 16, 96, 7, None),
              (4, 2, 64, 20, 64, None, (1, (2, 1))),
              (4, 1, 64, 16, 72, 20, (3, (3, 1)))]


@pytest.mark.parametrize("hq,hkv,d,c,smax,window,forced", SLAB_CASES)
def test_chunk_emulation_of_the_slab_matches_jax(hq, hkv, d, c, smax, window,
                                                  forced):
    clear_tuning()
    b = 4
    rng = np.random.default_rng(hq * 7 + d + c + smax)
    # a first chunk, a width-1 row, a partial chunk (padding rows) and a
    # chunk at the slab's end
    width = np.array([c, 1, c // 2 + 1, c], np.int32)
    start = np.array([0, 21, 30, smax - c], np.int32)
    q = _bf16_valued(rng, (b, c, hq, d))
    kc, vc = (_bf16_valued(rng, (b, smax, hkv, d)) for _ in range(2))
    warps, n_split, tps = _plan(b, hkv, hq // hkv, c, smax, forced)
    got = _chunk_tc_emulation(
        *(torch.from_numpy(x) for x in (q, kc, vc, start, width)), None,
        window, 1.0 / math.sqrt(d), warps, n_split, tps)
    want = np.asarray(flash_prefill_chunk_pallas(
        *(jnp.asarray(x) for x in (q, kc, vc, start, width)), window=window,
        interpret=True))
    _assert_within_one_ulp(got, want)


# (Hq, Hkv, D, page, max_blocks, window, forced): G 2, 1 and 4, D 64 and
# 80, chunks crossing pages of 4 and 16, a short window, forced splits
POOL_CASES = [(4, 2, 64, 4, 12, None, None), (2, 2, 80, 16, 4, 9, None),
              (4, 1, 64, 8, 8, None, (2, (4, 1))),
              (8, 2, 64, 4, 16, 6, (4, (2, 1)))]


def _pool_rows(rng, b, c, page, max_blocks):
    """(start, width, block table, pages) of ``b`` rows over a shuffled
    pool: a chunk crossing a page, a width-1 row, a partial chunk at the
    table's end whose row has its first page unmapped (released), and a
    row whose pages are all unmapped (zeros)."""
    n_keys = max_blocks * page
    start = np.array([page - 3, 2 * page + 1, n_keys - c, 0], np.int32)
    width = np.array([c, 1, c // 2 + 3, 5], np.int32)
    n_pages = b * max_blocks
    ids = rng.permutation(n_pages).astype(np.int32)
    bt = np.full((b, max_blocks), -1, np.int32)
    for i in range(b - 1):
        nb = -(-int(start[i] + width[i]) // page)
        bt[i, :nb] = ids[i * max_blocks: i * max_blocks + nb]
    bt[2, 0] = -1
    return start, width, bt, n_pages


@pytest.mark.parametrize("hq,hkv,d,page,max_blocks,window,forced",
                         POOL_CASES)
def test_chunk_emulation_of_the_int8_pool_matches_jax(hq, hkv, d, page,
                                                      max_blocks, window,
                                                      forced):
    clear_tuning()
    b, c = 4, 16
    n_keys = max_blocks * page
    rng = np.random.default_rng(hq * 5 + d + page + max_blocks)
    start, width, bt, n_pages = _pool_rows(rng, b, c, page, max_blocks)
    kq, vq = (rng.integers(-127, 128, (n_pages, page, hkv, d)).astype(np.int8)
              for _ in range(2))
    ksc, vsc = (rng.uniform(0.01, 0.1, (n_pages, hkv)).astype(np.float32)
                for _ in range(2))
    q = _bf16_valued(rng, (b, c, hq, d))
    warps, n_split, tps = _plan(b, hkv, hq // hkv, c, n_keys, forced)
    got = _chunk_tc_emulation(
        *(torch.from_numpy(x) for x in (q, kq, vq, start, width, bt)),
        window, 1.0 / math.sqrt(d), warps, n_split, tps,
        scales=(torch.from_numpy(ksc), torch.from_numpy(vsc)))
    want = np.asarray(flash_prefill_chunk_paged_quant_pallas(
        *(jnp.asarray(x) for x in (q, kq, vq, ksc, vsc, start, width, bt)),
        window=window, interpret=True))
    assert not got[-1].any() and not want[-1].any()   # all unmapped: zeros
    _assert_within_one_ulp(got, want)


@pytest.mark.parametrize("hq,hkv,d,page,max_blocks,window,forced",
                         POOL_CASES)
def test_chunk_emulation_of_the_bf16_pool_matches_jax(hq, hkv, d, page,
                                                      max_blocks, window,
                                                      forced):
    """The kernel's bf16-pool instance: the same walk with no scales (the
    key and value scales 1), pages of 4 and 8 spanning one 32-key tile,
    against ``flash_prefill_chunk_paged_pallas``."""
    clear_tuning()
    b, c = 4, 16
    n_keys = max_blocks * page
    rng = np.random.default_rng(hq * 3 + d + page + max_blocks)
    start, width, bt, n_pages = _pool_rows(rng, b, c, page, max_blocks)
    kp, vp = (_bf16_valued(rng, (n_pages, page, hkv, d)) for _ in range(2))
    q = _bf16_valued(rng, (b, c, hq, d))
    warps, n_split, tps = _plan(b, hkv, hq // hkv, c, n_keys, forced)
    got = _chunk_tc_emulation(
        *(torch.from_numpy(x) for x in (q, kp, vp, start, width, bt)),
        window, 1.0 / math.sqrt(d), warps, n_split, tps)
    want = np.asarray(flash_prefill_chunk_paged_pallas(
        *(jnp.asarray(x) for x in (q, kp, vp, start, width, bt)),
        window=window, interpret=True))
    assert not got[-1].any() and not want[-1].any()   # all unmapped: zeros
    _assert_within_one_ulp(got, want)
