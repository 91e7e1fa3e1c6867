"""The Hopper kernels' planners on the CPU, and plain emulations of what
the tensor-core kernels compute, against the JAX package.

The planners are pure Python, and the card's kernels follow them:
``kernels/gemm.py`` (``plan``: the route of a product from its dtype,
shape and alignment; ``split_k``: the K slices of the tensor-core kernel)
and ``kernels/flash_attention.py`` (``bwd_plan``; ``dq_key_tiles`` and
``dkv_query_tiles``: the tile walks of the tensor-core backward).  Held
here: the route and split of every product of a qwen2.5-3b training step
and of both LeNets' forward and train step, and the skinny route of
qwen2.5-3b's f32 decode and prefill products; slices that cover K exactly
in whole K steps (the tensor-core kernel's, and the f32 small-M kernel's
at every LeNet weight gradient); walks that reach every visible (query,
key) pair exactly once; and emulations in plain PyTorch against JAX's
oracles on the same numpy inputs — the split-K sum (f32 partials per
slice, summed in slice order) against ``repro.kernels.ref.gemm`` within
f32 summation order, at the tensor-core kernel's splits and at the f32
small-M kernel's at every LeNet product, and the backward's tile walks (P
and dS rounded to bf16 before the second products, the GQA group's
partials summed after) against JAX's Pallas backward in interpret mode
within one bf16 ulp of the largest gradient, the card's tolerance for the
kernel.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clear_tuning, set_tuning  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_pallas,
)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import gemm as gemm_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BWD_TILE,
    bwd_plan,
    dkv_query_tiles,
    dq_key_tiles,
)
from repro_torch.kernels.gemm import (  # noqa: E402
    N_SMS,
    SMALL_MIN_SLICE_STEPS,
    SMALL_TILE_K,
    SMALL_TILE_N,
    plan,
    small_tile_m,
    split_k,
)

BF16, F32 = torch.bfloat16, torch.float32
D, D_FF, VOCAB, ROWS = 2048, 11008, 151936, 512

# (product, M, N, K, A read along M, B read along K, route, K slices): the
# 15 products of a qwen2.5-3b train step at B 2 x S 256 (chip_smoke.py's
# phase 3 rows): the forward's, each input gradient g @ W^T and each
# weight gradient x^T @ g.  Fewer than 132 output tiles of 128 x 128 split
# K towards two blocks an SM, in slices of at least 8 steps of 32.
QWEN_TRAIN = [
    ("wq,wo", ROWS, D, D, False, False, "tc_splitk", 4),
    ("wk,wv", ROWS, 256, D, False, False, "tc_splitk", 8),
    ("wg,wi", ROWS, D_FF, D, False, False, "tc", 1),
    ("wo", ROWS, D, D_FF, False, False, "tc_splitk", 4),
    ("head (NT)", ROWS, VOCAB, D, False, True, "tc", 1),
    ("da wq,wo", ROWS, D, D, False, True, "tc_splitk", 4),
    ("da wk,wv", ROWS, D, 256, False, True, "tc", 1),
    ("da wg,wi", ROWS, D, D_FF, False, True, "tc_splitk", 4),
    ("da wo", ROWS, D_FF, D, False, True, "tc", 1),
    ("da head", ROWS, D, VOCAB, False, False, "tc_splitk", 4),
    ("db wq,wo", D, D, ROWS, True, False, "tc", 1),
    ("db wk,wv", D, 256, ROWS, True, False, "tc_splitk", 2),
    ("db wg,wi", D, D_FF, ROWS, True, False, "tc", 1),
    ("db wo", D_FF, D, ROWS, True, False, "tc", 1),
    ("db head", D, VOCAB, ROWS, True, False, "tc", 1),
]


@pytest.mark.parametrize("name,m,n,k,a_m,b_k,route,splits", QWEN_TRAIN,
                         ids=[p[0] for p in QWEN_TRAIN])
def test_qwen_train_products_take_the_tensor_cores(name, m, n, k, a_m, b_k,
                                                   route, splits):
    p = plan(m, n, k, BF16, a_m_contiguous=a_m, b_k_contiguous=b_k,
             tc_aligned=True)
    assert (p.route, p.splits) == (route, splits)
    assert p.slice_k % 32 == 0 or p.splits == 1
    # the same product in f32 keeps the scalar tiled kernel (IEEE f32),
    # and so does a bf16 operand the 16-byte copies cannot follow
    assert plan(m, n, k, F32, a_m_contiguous=a_m, b_k_contiguous=b_k,
                tc_aligned=True).route == "tiled"
    assert plan(m, n, k, BF16, a_m_contiguous=a_m, b_k_contiguous=b_k,
                tc_aligned=False).route == "tiled"


# (product, K, N, B read along K): qwen2.5-3b's forward products, as f32
# decode (M = 4) and chunked prefill (M = 64) run them (chip_smoke.py's
# phase 5)
QWEN_DECODE = [("wq,wo", D, D, False), ("wk,wv", D, 256, False),
               ("wg,wi", D, D_FF, False), ("wo", D_FF, D, False),
               ("head (NT)", D, VOCAB, True)]


@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("name,k,n,b_k", QWEN_DECODE,
                         ids=[p[0] for p in QWEN_DECODE])
def test_qwen_f32_decode_products_stay_skinny(name, k, n, b_k, m):
    # the f32 small-M kernel takes none of them: K (B along N) and N (B
    # along K) are all above SMALL_MAX_SPAN
    p = plan(m, n, k, F32, a_m_contiguous=False, b_k_contiguous=b_k,
             tc_aligned=True)
    assert (p.route, p.splits) == ("skinny", 1)


def _lenet_products():
    """(case, M, N, K, A read along M, B read along K, route, K slices) of
    every gemm of both LeNets' f32 forward and train step at batch 64
    (chip_smoke.py's Caffe rows): a convolution's forward w (F, C*K*K) @
    cols, its dw = dy_flat @ cols^T (B read along K) and dcols = w^T @
    dy_flat (A read along M); an inner product's x @ W, da = g @ W^T (B
    read along K) and db = x^T @ g (A read along M).  Every forward,
    weight gradient dw and input gradient da takes the f32 small-M kernel
    (M <= 64), split along K where its 32 or 64 x 64 tiles cannot fill the
    card; dcols and db (M = C*K*K and the inner product's input width) the
    scalar tiled kernel, but for CIFAR ip2's db (M = 64)."""
    n, out = 64, []
    for net, layer, c, h, f, k, pad, dx, splits in (
            ("mnist", "conv1", 1, 28, 20, 5, 0, False, (1, 256)),
            ("mnist", "conv2", 20, 12, 50, 5, 0, True, (4, 32)),
            ("cifar", "conv1", 3, 32, 32, 5, 2, False, (1, 128)),
            ("cifar", "conv2", 32, 15, 32, 5, 2, True, (1, 20)),
            ("cifar", "conv3", 32, 7, 64, 5, 2, True, (5, 20))):
        r, cols = c * k * k, n * (h + 2 * pad - k + 1) ** 2
        fwd, dw = splits
        out.append((f"{net} {layer}", f, cols, r, False, False,
                    "f32_splitk" if fwd > 1 else "f32_small", fwd))
        out.append((f"{net} {layer} dw", f, r, cols, False, True,
                    "f32_splitk", dw))
        if dx:
            out.append((f"{net} {layer} dcols", r, cols, f, True, False,
                        "tiled", 1))
    for net, layer, k, o, splits in (("mnist", "ip1", 800, 500, (10, 8)),
                                     ("mnist", "ip2", 500, 10, (8, 1)),
                                     ("cifar", "ip1", 576, 64, (9, 1)),
                                     ("cifar", "ip2", 64, 10, (1, 1))):
        fwd, da = splits
        out.append((f"{net} {layer}", n, o, k, False, False,
                    "f32_splitk" if fwd > 1 else "f32_small", fwd))
        out.append((f"{net} {layer} da", n, k, o, False, True,
                    "f32_splitk" if da > 1 else "f32_small", da))
        out.append((f"{net} {layer} db", k, o, n, True, False,
                    "f32_small" if k <= 64 else "tiled", 1))
    return out


LENET = _lenet_products()


@pytest.mark.parametrize("name,m,n,k,a_m,b_k,route,splits", LENET,
                         ids=[p[0] for p in LENET])
def test_lenet_products_take_the_f32_small_m_kernel(name, m, n, k, a_m, b_k,
                                                    route, splits):
    p = plan(m, n, k, F32, a_m_contiguous=a_m, b_k_contiguous=b_k,
             tc_aligned=True)
    assert (p.route, p.splits) == (route, splits)
    if route.startswith("f32"):
        assert p.tile_m == (32 if m <= 32 else 64)
        assert p.slice_k % SMALL_TILE_K == 0 or p.splits == 1
    # the skinny kernel, which took every one of them with A read along K
    # before, takes them again only when the small-M kernel is turned off
    # (chip_smoke.py times it so)
    if not a_m:
        saved = gemm_mod.SMALL_MAX_M
        gemm_mod.SMALL_MAX_M = 0
        try:
            assert plan(m, n, k, F32, a_m_contiguous=a_m, b_k_contiguous=b_k,
                        tc_aligned=True).route == (
                "skinny" if m <= 128 else "tiled")
        finally:
            gemm_mod.SMALL_MAX_M = saved


LENET_DW = [p for p in LENET if p[0].endswith(" dw")]


@pytest.mark.parametrize("name,m,n,k", [p[:4] for p in LENET_DW],
                         ids=[p[0] for p in LENET_DW])
def test_small_split_k_slices_cover_k(name, m, n, k):
    splits, slice_k = split_k(m, n, k, small_tile_m(m), SMALL_TILE_N,
                              SMALL_TILE_K, SMALL_MIN_SLICE_STEPS)
    tiles = math.ceil(m / small_tile_m(m)) * math.ceil(n / SMALL_TILE_N)
    assert tiles < N_SMS and splits > 1
    assert slice_k % SMALL_TILE_K == 0
    assert slice_k >= SMALL_MIN_SLICE_STEPS * SMALL_TILE_K
    bounds = [(z * slice_k, min(k, (z + 1) * slice_k)) for z in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)           # no empty slice
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # no more blocks than about two an SM
    assert tiles * splits <= 2 * N_SMS + tiles


def test_skinny_cutoff_per_dtype():
    # f32 keeps its measured cutoff; an A read along M never takes the
    # skinny kernel
    assert gemm_mod.SKINNY_MAX_M[F32] == 128
    cut = gemm_mod.SKINNY_MAX_M[BF16]
    for dtype, c in ((F32, 128), (BF16, cut)):
        if c:
            assert plan(c, 2048, 2048, dtype, a_m_contiguous=False,
                        b_k_contiguous=False,
                        tc_aligned=True).route == "skinny"
            assert plan(c, 2048, 2048, dtype, a_m_contiguous=True,
                        b_k_contiguous=False,
                        tc_aligned=True).route != "skinny"
        assert plan(c + 1, 2048, 2048, dtype, a_m_contiguous=False,
                    b_k_contiguous=False, tc_aligned=True).route != "skinny"


def _shapes():
    rng = np.random.default_rng(0)
    fixed = [(p[1], p[2], p[3]) for p in QWEN_TRAIN] + [
        (520, 1000, 2056), (2056, 1000, 520), (4, 2048, 2048), (1, 2048, 256),
        (64, 151936, 2048), (130, 72, 40), (256, 16, 64), (128, 128, 33),
        (16, 256, 8192)]
    rand = [tuple(int(x) for x in rng.integers(1, hi, 3))
            for hi in (300, 3000, 40000) for _ in range(12)]
    return fixed + rand


@pytest.mark.parametrize("m,n,k", _shapes())
def test_split_k_slices_cover_k(m, n, k):
    splits, slice_k = split_k(m, n, k)
    tiles = math.ceil(m / 128) * math.ceil(n / 128)
    if splits == 1:
        assert slice_k == k
        return
    assert tiles < N_SMS
    assert slice_k % 32 == 0 and slice_k >= 8 * 32
    bounds = [(z * slice_k, min(k, (z + 1) * slice_k)) for z in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)           # no empty slice
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # no more blocks than about two an SM
    assert tiles * splits <= 2 * N_SMS + tiles


def _splitk_emulation(a, b, splits, slice_k):
    """The split-K kernel's arithmetic in plain PyTorch: each slice's f32
    product, then the slices summed in the order 0..splits-1."""
    k = a.shape[1]
    parts = [a[:, z * slice_k:min(k, (z + 1) * slice_k)].float()
             @ b[z * slice_k:min(k, (z + 1) * slice_k)].float()
             for z in range(splits)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


@pytest.mark.parametrize("m,n,k", [(520, 1000, 2056), (40, 72, 1000),
                                   (4, 256, 2048), (130, 200, 4099)])
def test_splitk_emulation_matches_jax(m, n, k):
    splits, slice_k = split_k(m, n, k)
    assert splits > 1
    rng = np.random.default_rng(m + n + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = _splitk_emulation(torch.from_numpy(a), torch.from_numpy(b),
                            splits, slice_k)
    want = np.asarray(jax_ref.gemm(jnp.asarray(a), jnp.asarray(b)))
    # f32 summation order over K terms
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    # and in bf16: the f32 sum rounded once, as the reduce kernel rounds
    ab, bb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got16 = _splitk_emulation(ab, bb, splits, slice_k).to(torch.bfloat16)
    want16 = np.asarray(jax_ref.gemm(jnp.asarray(ab.float().numpy(),
                                                 jnp.bfloat16),
                                     jnp.asarray(bb.float().numpy(),
                                                 jnp.bfloat16)),
                        np.float32)
    err = np.abs(got16.float().numpy() - want16).max()
    assert err <= 2 ** -7 * np.abs(want16).max()


@pytest.mark.parametrize("name,m,n,k,a_m,b_k,route,splits", LENET,
                         ids=[p[0] for p in LENET])
def test_small_splitk_emulation_matches_jax(name, m, n, k, a_m, b_k, route,
                                            splits):
    """The f32 small-M kernel's arithmetic at each LeNet product (each K
    slice's f32 product, then the slices summed in order 0..splits-1, as
    splitk_reduce_f32 sums them) against JAX's gemm on the same inputs;
    the products the tiled kernel takes are held at one slice."""
    p = plan(m, n, k, F32, a_m_contiguous=a_m, b_k_contiguous=b_k,
             tc_aligned=True)
    rng = np.random.default_rng(m * 7 + n * 3 + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = _splitk_emulation(torch.from_numpy(a), torch.from_numpy(b),
                            p.splits, p.slice_k)
    want = np.asarray(jax_ref.gemm(jnp.asarray(a), jnp.asarray(b)))
    # f32 summation order over K terms
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype,d,aligned,route", [
    (BF16, 128, True, "tc"), (BF16, 80, True, "tc"), (BF16, 64, True, "tc"),
    (BF16, 16, True, "tc"), (BF16, 72, True, "scalar"),
    (BF16, 8, True, "scalar"), (BF16, 128, False, "scalar"),
    (F32, 128, True, "scalar"), (F32, 64, True, "scalar")])
def test_bwd_plan(dtype, d, aligned, route):
    assert bwd_plan(dtype, d, aligned) == route


WALKS = [(256, 256, True, None), (200, 200, True, None),
         (200, 264, False, None), (100, 160, True, 48),
         (256, 256, True, 32), (64, 64, True, 1), (130, 70, True, None),
         (70, 130, False, 20), (1, 1, True, None), (65, 300, True, 64)]


def _visible(sq, sk, causal, window):
    qp = np.arange(sq)[:, None]
    kp = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= kp <= qp
    if window is not None:
        vis &= kp > qp - window
    return vis


@pytest.mark.parametrize("sq,sk,causal,window", WALKS)
def test_tile_walks_cover_each_visible_pair_once(sq, sk, causal, window):
    vis = _visible(sq, sk, causal, window)
    t = BWD_TILE
    by_q = np.zeros((sq, sk), int)
    for q0 in range(0, sq, t):
        for k0 in dq_key_tiles(q0, sq, sk, causal, window):
            assert k0 % t == 0 and 0 <= k0 < sk
            by_q[q0:q0 + t, k0:k0 + t] += 1
    by_k = np.zeros((sq, sk), int)
    for k0 in range(0, sk, t):
        for q0 in dkv_query_tiles(k0, sq, sk, causal, window):
            assert q0 % t == 0 and 0 <= q0 < sq
            by_k[q0:q0 + t, k0:k0 + t] += 1
    for walked in (by_q, by_k):
        assert (walked[vis] == 1).all()
        assert walked.max() <= 1


def _bwd_tc_emulation(q, k, v, o, lse, do, causal, window, scale):
    """The tensor-core backward's arithmetic in plain PyTorch, tile by tile
    along its walks: S and dP in f32, P = exp(S * scale - lse) under the
    mask, dS = P * (dP - dd); P and dS rounded to bf16 before dQ, dK, dV;
    each q head's dk/dv partials, then the GQA group summed in order."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g, t = hq // hkv, BWD_TILE
    vis = torch.from_numpy(_visible(sq, sk, causal, window))
    r16 = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    dd = (do * o).sum(-1)                                   # (b, sq, hq)
    dq = torch.zeros_like(q)
    dk_p = torch.zeros((b, sk, hq, d))
    dv_p = torch.zeros((b, sk, hq, d))
    for bi in range(b):
        for h in range(hq):
            hk = h // g
            for q0 in range(0, sq, t):
                qs = slice(q0, min(q0 + t, sq))
                for k0 in dq_key_tiles(q0, sq, sk, causal, window):
                    ks = slice(k0, min(k0 + t, sk))
                    s = q[bi, qs, h] @ k[bi, ks, hk].T
                    p = torch.where(vis[qs, ks], torch.exp(
                        s * scale - lse[bi, h, qs, None]), 0.0)
                    dp = do[bi, qs, h] @ v[bi, ks, hk].T
                    ds = p * (dp - dd[bi, qs, h, None])
                    dq[bi, qs, h] += r16(ds) @ k[bi, ks, hk]
            for k0 in range(0, sk, t):
                ks = slice(k0, min(k0 + t, sk))
                for q0 in dkv_query_tiles(k0, sq, sk, causal, window):
                    qs = slice(q0, min(q0 + t, sq))
                    st = k[bi, ks, hk] @ q[bi, qs, h].T
                    pt = torch.where(vis[qs, ks].T, torch.exp(
                        st * scale - lse[bi, h, None, qs]), 0.0)
                    dpt = v[bi, ks, hk] @ do[bi, qs, h].T
                    dst = pt * (dpt - dd[bi, None, qs, h])
                    dv_p[bi, ks, h] += r16(pt) @ do[bi, qs, h]
                    dk_p[bi, ks, h] += r16(dst) @ q[bi, qs, h]
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for gi in range(g):   # q head hk * g + gi of kv head hk
        dk += dk_p.view(b, sk, hkv, g, d)[:, :, :, gi]
        dv += dv_p.view(b, sk, hkv, g, d)[:, :, :, gi]
    return dq * scale, dk * scale, dv


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal,window", [
    (1, 100, 100, 4, 2, 16, True, None), (1, 70, 130, 2, 1, 32, False, 20)])
def test_bwd_tile_emulation_matches_jax(b, sq, sk, hq, hkv, d, causal,
                                        window):
    clear_tuning()
    set_tuning("flash_attention", bq=16, bk=16)
    try:
        rng = np.random.default_rng(sq + sk + d)
        # bf16-valued inputs, as the kernel reads them
        q, do = (torch.from_numpy(rng.standard_normal(
            (b, sq, hq, d)).astype(np.float32)).to(BF16).float()
            for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal(
            (b, sk, hkv, d)).astype(np.float32)).to(BF16).float()
            for _ in range(2))
        o, lse = ref.mha_attention(q, k, v, causal=causal, window=window)
        got = _bwd_tc_emulation(q, k, v, o, lse, do, causal, window,
                                1.0 / math.sqrt(d))
        want = flash_attention_bwd_pallas(
            *(jnp.asarray(t.numpy()) for t in (q, k, v, o, lse, do)),
            causal=causal, window=window, interpret=True)
        for gt, w in zip(got, want):
            w = np.asarray(w)
            err = np.abs(gt.numpy() - w).max()
            assert err <= 2 ** -7 * np.abs(w).max(), err
    finally:
        clear_tuning()
