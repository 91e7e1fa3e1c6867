"""The attention forward's and the decodes' routes on the CPU, and plain
emulations of what their redesigned kernels compute, against the JAX
package.

``kernels/flash_attention.py`` picks each route in pure Python, and the
card's kernels follow it: ``fwd_plan`` (bf16 at head dims that are
multiples of 16 up to 128 with aligned operands -> the tensor-core forward
of ``csrc/flash_attention_tc.cu``; f32 and every other shape -> the
template's IEEE forward), ``decode_plan`` (bf16 queries over int8 or bf16
K/V the 16-byte copies can follow -> the split decode of
``csrc/flash_decode_split.cu``, for the contiguous slab, the bf16 pool and
the int8 pool; f32 queries, over a bf16 pool too, and every other shape
-> the template) and ``decode_splits`` (the split decode's runs of
block-table entries, or of 32-key tiles of the slab, from shapes only).
Held here: the routes; splits that cover every block-table entry, and
every key of the slab, once and in order, with enough blocks at
qwen2.5-3b's serving shape and a bounded count at zamba2-2.7b's; and
emulations in plain PyTorch against JAX's Pallas kernels in interpret
mode on the same numpy inputs -- the tensor-core forward (64-row query
tiles over ``dq_key_tiles``, 64-key tiles, the online softmax in f32, P
rounded to bf16 before PV) against ``flash_attention_pallas`` within one
bf16 ulp of the largest output and lse within 1e-5, and the split decode
(f32 partials per split, merged in split order) against
``flash_decode_paged_quant_pallas``, ``flash_decode_pallas`` and
``flash_decode_paged_pallas`` within 1e-5 on f32 queries.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clear_tuning  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_pallas,
    flash_decode_pallas,
    flash_decode_paged_pallas,
    flash_decode_paged_quant_pallas,
)
from repro_torch.kernels._build import aligned16 as _aligned  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BWD_TILE,
    DECODE_BLOCKS,
    SPLIT_TILE,
    _decode_route,
    decode_plan,
    decode_splits,
    dq_key_tiles,
    fwd_plan,
)

BF16, F32 = torch.bfloat16, torch.float32
NEG = -1e30


@pytest.mark.parametrize("dtype,d,aligned,fwd,dec", [
    (BF16, 64, True, "tc", "split"), (BF16, 80, True, "tc", "split"),
    (BF16, 128, True, "tc", "split"), (BF16, 72, True, "scalar", "template"),
    (BF16, 128, False, "scalar", "template"),
    (BF16, 144, True, "scalar", "template"),
    (F32, 128, True, "scalar", "template"),
    (F32, 80, True, "scalar", "template")])
def test_fwd_and_decode_plan(dtype, d, aligned, fwd, dec):
    assert fwd_plan(dtype, d, aligned) == fwd
    assert decode_plan(dtype, torch.int8, d, aligned) == dec


def test_alignment_of_operands_and_pools():
    """What the wrappers hand the planners: bf16 operands need 16-byte
    bases and strides of 8 elements, an int8 pool strides of 16 bytes."""
    qkv = torch.zeros((2, 5, 3 * 128), dtype=BF16)
    q = qkv[..., :128].unflatten(-1, (1, 128))         # a projection's slice
    assert _aligned(q)
    odd = torch.zeros((2, 5, 2, 68), dtype=BF16)[..., :64]
    assert not _aligned(odd)                           # row stride 68
    pool = torch.zeros((9, 4, 2, 80), dtype=torch.int8)
    assert _aligned(pool, elems=16)
    assert not _aligned(torch.zeros((9, 4, 2, 72), dtype=torch.int8),
                        elems=16)                      # head stride 72


# (query dtype, K/V dtype, D, aligned, route): bf16 K/V (the slab and the
# bf16 pool) as the int8 pool; f32 queries, over a bf16 pool too, and
# every shape off the rule on the template
@pytest.mark.parametrize("dtype,kv,d,aligned,route", [
    (BF16, BF16, 128, True, "split"), (BF16, BF16, 80, True, "split"),
    (BF16, BF16, 64, True, "split"), (F32, F32, 128, True, "template"),
    (F32, BF16, 128, True, "template"), (F32, BF16, 80, True, "template"),
    (BF16, BF16, 72, True, "template"), (BF16, BF16, 144, True, "template"),
    (BF16, BF16, 128, False, "template"), (BF16, F32, 128, True, "template")])
def test_decode_plan_by_storage(dtype, kv, d, aligned, route):
    assert decode_plan(dtype, kv, d, aligned) == route


def test_decode_route_of_caches_and_pools():
    """What the decode wrappers hand the planner: a bf16 slab or pool
    needs strides of 8 elements, an int8 pool of 16; f32 queries take the
    template over any of them."""
    q = torch.zeros((4, 16, 80), dtype=BF16)
    slab = torch.zeros((4, 128, 2, 80), dtype=BF16)
    assert _decode_route(q, slab, slab) == "split"
    assert _decode_route(q, slab[1:], slab[1:]) == "split"   # a row's offset
    odd = torch.zeros((4, 128, 2, 84), dtype=BF16)[..., :80]
    assert _decode_route(q, odd, odd) == "template"          # head stride 84
    pool = torch.zeros((9, 16, 2, 80), dtype=torch.int8)
    assert _decode_route(q, pool, pool) == "split"
    assert _decode_route(q.float(), slab, slab) == "template"
    assert _decode_route(q.float(), pool, pool) == "template"


def _cover(max_blocks, n, pps):
    return [e for i in range(n)
            for e in range(i * pps, min((i + 1) * pps, max_blocks))]


# (B, Hkv, max_blocks, page): qwen2.5-3b, zamba2-2.7b and mixtral-8x7b at
# the served batch and 128-token rows of 16-token pages; ragged tables
SPLIT_SHAPES = [(4, 2, 8, 16), (4, 32, 8, 16), (4, 8, 8, 16),
                (4, 2, 7, 16), (1, 1, 257, 16), (3, 5, 13, 4),
                (2, 2, 1, 16), (8, 2, 100, 1), (4, 2, 0, 16)]


@pytest.mark.parametrize("b,hkv,max_blocks,page", SPLIT_SHAPES)
def test_decode_splits_cover_the_table_in_order(b, hkv, max_blocks, page):
    n, pps = decode_splits(b, hkv, max_blocks, page)
    assert n >= 1 and pps >= 1
    assert _cover(max_blocks, n, pps) == list(range(max_blocks))
    assert (n - 1) * pps < max(max_blocks, 1)          # no empty split


def test_decode_splits_at_the_served_shapes():
    # qwen2.5-3b: at least 48 blocks; zamba2-2.7b: bounded near one wave
    n, _ = decode_splits(4, 2, 8, 16)
    assert 4 * 2 * n >= 48
    n, _ = decode_splits(4, 32, 8, 16)
    assert 4 * 32 * n <= 2 * DECODE_BLOCKS


# (B, Hkv, Smax): qwen2.5-3b's and zamba2-2.7b's served slab, --check's
# (B 2, Smax = 160 + 32), and slabs off the 32-key tile
SLAB_SHAPES = [(4, 2, 128), (4, 32, 128), (2, 2, 192), (4, 2, 100),
               (1, 1, 1), (3, 5, 31), (1, 1, 4097), (4, 2, 0)]


@pytest.mark.parametrize("b,hkv,smax", SLAB_SHAPES)
def test_decode_splits_cover_the_slab_in_order(b, hkv, smax):
    n_tiles = -(-smax // SPLIT_TILE)
    n, pps = decode_splits(b, hkv, n_tiles, SPLIT_TILE)
    run = pps * SPLIT_TILE
    keys = [s for i in range(n)
            for s in range(i * run, min((i + 1) * run, smax))]
    assert keys == list(range(smax))
    assert (n - 1) * run < max(smax, 1)                 # no empty split


def test_decode_splits_of_the_slab_at_the_served_shapes():
    # qwen2.5-3b's slab: a split a tile (32 blocks); --check's: 6 splits
    assert decode_splits(4, 2, 4, SPLIT_TILE) == (4, 1)
    assert decode_splits(2, 2, 6, SPLIT_TILE) == (6, 1)
    n, _ = decode_splits(4, 32, 4, SPLIT_TILE)
    assert 4 * 32 * n <= 2 * DECODE_BLOCKS


def _visible(sq, sk, causal, window):
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        vis &= kp <= qp
    if window is not None:
        vis &= kp > qp - window
    return vis


def _fwd_tc_emulation(q, k, v, causal, window, scale):
    """The tensor-core forward's arithmetic in plain PyTorch, block by
    block: 64 query rows over the key tiles of ``dq_key_tiles``, 64 keys a
    tile, the online softmax in f32, P rounded to bf16 before PV, l summed
    from the f32 P; out = acc / l, lse = m + log(l), l == 0 taken as 1."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g, t = hq // hkv, BWD_TILE
    vis = _visible(sq, sk, causal, window)
    out = torch.zeros_like(q)
    lse = torch.zeros((b, hq, sq))
    for bi in range(b):
        for h in range(hq):
            hk = h // g
            for q0 in range(0, sq, t):
                qs = slice(q0, min(q0 + t, sq))
                n = qs.stop - q0
                m, l = torch.full((n,), NEG), torch.zeros(n)
                acc = torch.zeros((n, d))
                for k0 in dq_key_tiles(q0, sq, sk, causal, window):
                    ks = slice(k0, min(k0 + t, sk))
                    s = (q[bi, qs, h] @ k[bi, ks, hk].T) * scale
                    s = torch.where(vis[qs, ks], s, NEG)
                    m_new = torch.maximum(m, s.max(-1).values)
                    p = torch.where(vis[qs, ks],
                                    torch.exp(s - m_new[:, None]), 0.0)
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + \
                        p.to(BF16).float() @ v[bi, ks, hk]
                    m = m_new
                l_safe = torch.where(l == 0, 1.0, l)
                out[bi, qs, h] = acc / l_safe[:, None]
                lse[bi, h, qs] = m + torch.log(l_safe)
    return out, lse


# (B, Sq, Sk, Hq, Hkv, D, causal, window): S off the 64-row tile, G 1, 2
# and 4, windowed, and non-causal with Sk > Sq
FWD_CASES = [(1, 100, 100, 4, 2, 32, True, None),
             (1, 130, 130, 4, 1, 16, True, 40),
             (1, 70, 150, 2, 2, 32, False, None),
             (2, 65, 65, 4, 4, 16, True, 20)]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window", FWD_CASES)
def test_fwd_tile_emulation_matches_jax(b, sq, sk, hq, hkv, d, causal,
                                        window):
    clear_tuning()
    rng = np.random.default_rng(sq * 3 + sk + d)
    # bf16-valued inputs, as the kernel reads them
    q = torch.from_numpy(rng.standard_normal(
        (b, sq, hq, d)).astype(np.float32)).to(BF16).float()
    k, v = (torch.from_numpy(rng.standard_normal(
        (b, sk, hkv, d)).astype(np.float32)).to(BF16).float()
        for _ in range(2))
    out, lse = _fwd_tc_emulation(q, k, v, causal, window,
                                 1.0 / math.sqrt(d))
    w_out, w_lse = (np.asarray(x) for x in flash_attention_pallas(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal,
        window=window, interpret=True))
    # P rounded to bf16 before PV: within one bf16 ulp of the largest output
    assert np.abs(out.numpy() - w_out).max() <= 2 ** -7 * np.abs(w_out).max()
    np.testing.assert_allclose(lse.numpy(), w_lse, rtol=0, atol=1e-5)


def _split_decode_emulation(q, k, v, lens, bt, window, scale, n_split, pps,
                            scales=None, tile=SPLIT_TILE):
    """The split decode's arithmetic in plain PyTorch: per (row, kv head,
    split), the split's keys in tiles of ``tile`` positions (keys past the
    length or the slab, before the window or in unmapped pages masked; an
    int8 page's ``scales`` applied after the upcast), an f32 partial (m,
    l, acc); then the partials merged in split order, or, with one split,
    acc / l.  ``bt`` None: ``k``/``v`` are the (B, Smax, Hkv, D) slab, its
    splits runs of ``tile``-key pages (the last one ragged)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    kf, vf = k.float(), v.float()
    if scales is not None:
        kf = kf * scales[0][:, None, :, None]
        vf = vf * scales[1][:, None, :, None]
    if bt is None:
        page, n_keys = tile, k.shape[1]
    else:
        page = k.shape[1]
        n_keys = bt.shape[1] * page
    out = torch.zeros((b, hq, d))
    for bi in range(b):
        n = int(lens[bi])
        lo = max(0, n - window) if window is not None else 0
        for h in range(hkv):
            qg = q[bi, h * g:(h + 1) * g].float()
            parts = []
            for sp in range(n_split):
                s_lo = sp * pps * page
                s_hi = min(s_lo + pps * page, n_keys)
                k_lo, k_hi = max(s_lo, lo), min(s_hi, n)
                m, l = torch.full((g,), NEG), torch.zeros(g)
                acc = torch.zeros((g, d))
                t0 = s_lo + ((k_lo - s_lo) // tile) * tile
                for t0 in range(t0, k_hi if k_lo < k_hi else t0, tile):
                    pos = torch.arange(t0, t0 + tile)
                    valid = (pos >= k_lo) & (pos < k_hi)
                    if bt is None:
                        at = (bi, pos.clamp(max=n_keys - 1), h)
                    else:
                        blk = bt[bi, (pos // page).clamp(max=bt.shape[1] - 1)]
                        valid &= blk >= 0
                        at = (blk.clamp(min=0), pos % page, h)
                    if not valid.any():
                        continue
                    kk = torch.where(valid[:, None], kf[at], 0.0)
                    vv = torch.where(valid[:, None], vf[at], 0.0)
                    s = (qg @ kk.T) * scale
                    m_new = torch.maximum(
                        m, torch.where(valid, s, NEG).max(-1).values)
                    p = torch.where(valid, torch.exp(s - m_new[:, None]), 0.0)
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ vv
                    m = m_new
                parts.append((m, l, acc))
            if n_split == 1:
                m, l, acc = parts[0]
                o = acc / torch.where(l == 0, 1.0, l)[:, None]
            else:
                ms = torch.stack([p_[0] for p_ in parts])    # (n, g)
                ls = torch.stack([p_[1] for p_ in parts])
                live = ls > 0
                big = torch.where(live, ms, NEG).max(0).values
                L, O = torch.zeros(g), torch.zeros((g, d))
                for i, (m, l, acc) in enumerate(parts):   # split order
                    w = torch.where(live[i], torch.exp(m - big), 0.0)
                    L = L + torch.where(live[i], l * w, 0.0)
                    O = O + torch.where(live[i][:, None], acc * w[:, None],
                                        0.0)
                o = torch.where(L[:, None] > 0,
                                O / torch.where(L == 0, 1.0, L)[:, None], 0.0)
            out[bi, h * g:(h + 1) * g] = o
    return out


# (Hq, Hkv, D, page, max_blocks, window, (n_split, pages_per_split)): the
# planner's split at the shape (None) and forced ones, a ragged last split
DECODE_CASES = [(4, 2, 32, 4, 6, None, None), (4, 2, 32, 4, 6, None, (6, 1)),
                (4, 2, 32, 4, 6, 7, (3, 2)), (2, 2, 16, 4, 7, None, (3, 3)),
                (8, 2, 16, 8, 4, 5, (1, 4))]


def _paged_inputs(rng, b, hkv, d, page, max_blocks):
    """A shuffled pool and table with ragged lengths: 1, exactly a page,
    the table's span, one between, and a row whose pages are all
    unmapped."""
    n_pages = b * max_blocks
    lens = np.array([1, page, max_blocks * page, page * max_blocks // 2 + 1,
                     3 * page], np.int32)
    ids = rng.permutation(n_pages).astype(np.int32)
    bt = np.full((b, max_blocks), -1, np.int32)
    at = 0
    for i, n in enumerate(lens[:-1]):
        nb = -(-int(n) // page)
        bt[i, :nb] = ids[at:at + nb]
        at += nb
    return n_pages, lens, bt


def _bf16_valued(rng, shape):
    """Standard normal values rounded to bf16 and held in f32, as the
    kernel reads a bf16 cache."""
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(BF16).float().numpy()


def _assert_close(got, want):
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("hq,hkv,d,page,max_blocks,window,split",
                         DECODE_CASES)
def test_split_decode_emulation_matches_jax(hq, hkv, d, page, max_blocks,
                                            window, split):
    clear_tuning()
    b = 5
    rng = np.random.default_rng(hq * 7 + d + page + max_blocks)
    n_pages, lens, bt = _paged_inputs(rng, b, hkv, d, page, max_blocks)
    kq, vq = (rng.integers(-127, 128, (n_pages, page, hkv, d)).astype(np.int8)
              for _ in range(2))
    ksc, vsc = (rng.uniform(0.01, 0.1, (n_pages, hkv)).astype(np.float32)
                for _ in range(2))
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    n_split, pps = split or decode_splits(b, hkv, max_blocks, page)
    got = _split_decode_emulation(
        *(torch.from_numpy(x) for x in (q, kq, vq, lens, bt)),
        window, 1.0 / math.sqrt(d), n_split, pps,
        scales=(torch.from_numpy(ksc), torch.from_numpy(vsc)))
    want = np.asarray(flash_decode_paged_quant_pallas(
        *(jnp.asarray(x) for x in (q, kq, vq, ksc, vsc, lens, bt)),
        window=window, interpret=True))
    assert not got[-1].any() and not want[-1].any()   # all unmapped: zeros
    _assert_close(got, want)


@pytest.mark.parametrize("hq,hkv,d,page,max_blocks,window,split",
                         DECODE_CASES)
def test_split_decode_emulation_of_the_bf16_pool_matches_jax(
        hq, hkv, d, page, max_blocks, window, split):
    clear_tuning()
    b = 5
    rng = np.random.default_rng(hq * 5 + d + page + max_blocks)
    n_pages, lens, bt = _paged_inputs(rng, b, hkv, d, page, max_blocks)
    kp, vp = (_bf16_valued(rng, (n_pages, page, hkv, d)) for _ in range(2))
    q = _bf16_valued(rng, (b, hq, d))
    n_split, pps = split or decode_splits(b, hkv, max_blocks, page)
    got = _split_decode_emulation(
        *(torch.from_numpy(x) for x in (q, kp, vp, lens, bt)),
        window, 1.0 / math.sqrt(d), n_split, pps)
    want = np.asarray(flash_decode_paged_pallas(
        *(jnp.asarray(x) for x in (q, kp, vp, lens, bt)), window=window,
        interpret=True))
    assert not got[-1].any() and not want[-1].any()   # all unmapped: zeros
    _assert_close(got, want)


# (Hq, Hkv, D, Smax, window, (n_split, pages_per_split)): the planner's
# split at the shape (None) and forced ones; Smax off the 32-key tile (a
# ragged last tile), ragged last splits, windows
SLAB_CASES = [(4, 2, 32, 96, None, None), (4, 2, 32, 70, None, (3, 1)),
              (4, 2, 32, 70, 9, (2, 2)), (2, 2, 16, 128, 40, None),
              (8, 2, 16, 45, None, (1, 2)), (4, 1, 16, 100, 33, (2, 3))]


@pytest.mark.parametrize("hq,hkv,d,smax,window,split", SLAB_CASES)
def test_split_decode_emulation_of_the_slab_matches_jax(hq, hkv, d, smax,
                                                        window, split):
    clear_tuning()
    b = 5
    rng = np.random.default_rng(hq * 3 + d + smax)
    # ragged lengths: 1, a tile, the slab, one between, and a row with no
    # key (zeros)
    lens = np.array([1, SPLIT_TILE, smax, smax // 2 + 1, 0], np.int32)
    kc, vc = (_bf16_valued(rng, (b, smax, hkv, d)) for _ in range(2))
    q = _bf16_valued(rng, (b, hq, d))
    n_tiles = -(-smax // SPLIT_TILE)
    n_split, pps = split or decode_splits(b, hkv, n_tiles, SPLIT_TILE)
    assert n_split * pps >= n_tiles
    got = _split_decode_emulation(
        *(torch.from_numpy(x) for x in (q, kc, vc, lens)), None,
        window, 1.0 / math.sqrt(d), n_split, pps)
    want = np.asarray(flash_decode_pallas(
        *(jnp.asarray(x) for x in (q, kc, vc, lens)), window=window,
        interpret=True))
    assert not got[-1].any() and not want[-1].any()   # no key: zeros
    _assert_close(got, want)
