"""im2col's and col2im's routes on the CPU, walks of their new grids, and
a plain emulation of the new col2im's summation order, against the JAX
package.

``kernels/im2col.py`` picks the routes in pure Python, and the card's
kernels follow them: ``im2col_plan`` (5 x 5 and 3 x 3 windows at stride 1
with every offset under 2**31 -> the "band" kernel of ``csrc/im2col.cu``;
other windows, strides or extents -> "flat") with ``im2col_band`` (a
block's output rows and threads and its 16-byte stores), and
``col2im_plan`` ("tile" for the same windows, "flat" else) with
``col2im_tile``.  Held here: the routes at the five LeNet convolutions in
both output layouts and both dtypes, and at a stride of 2, windows not
instantiated, a misaligned base, a column-major x (staged by its strides)
and extents past 2**31; a walk of each new kernel's grid, in its own index
arithmetic, that writes every output element exactly once with the value
the plain version gives, keeps every store inside its block's part of its
row and image segment (P = 576, 225, 49: the odd ones straddle the
16-byte grid in the (C*KH*KW, N*OH*OW) layout) and every 16-byte store
aligned; the C signatures of the new launchers against their ctypes
entries and the kernels' budgets against the planners'; and an emulation
in numpy of the tile kernel's f32 sum (i outer, j inner, a tap in the
padding adding 0, one rounding to cols' dtype) exact against
``col2im_pallas`` in interpret mode (which sums in that order) and within
``SUM_TOL`` of ``ref.col2im`` (a scatter, another order).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clear_tuning  # noqa: E402
from repro.kernels.im2col import col2im_pallas  # noqa: E402
from repro_torch.core.container import MajorOrder, as_layout  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import im2col as M  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ref import conv_out_size  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
# tests/test_torch_caffe_grad.py's tolerance for sums in another order
SUM_TOL = dict(rtol=1e-6, atol=1e-6)

# (C, H = W, k, pad): the five LeNet convolutions (MNIST conv1, conv2;
# CIFAR conv1, conv2, conv3), stride 1, at the solvers' batch of 64
LENET = [(1, 28, 5, 0), (20, 12, 5, 0), (3, 32, 5, 2), (32, 15, 5, 2),
         (32, 7, 5, 2)]
# the convolutions whose input needs a gradient: col2im's shapes
LENET_DX = LENET[1:2] + LENET[3:]
BATCH = 64


def _out_strides(n, c, k, p, batch_in_columns):
    """(o_sn, o_sr) of im2col's output: (R, N*P) or (N, R, P)."""
    r = c * k * k
    return (p, n * p) if batch_in_columns else (r * p, p)


def _p(h, k, pad):
    return conv_out_size(h, k, 1, pad) ** 2


@pytest.mark.parametrize("bic", [True, False])
@pytest.mark.parametrize("case", LENET)
def test_im2col_plan_takes_band_at_lenet(case, bic):
    c, h, k, pad = case
    shape = (BATCH, c, h, h)
    x = torch.empty(shape)
    cm = as_layout(x, MajorOrder.ROW, MajorOrder.COLUMN)
    off = torch.empty(x.numel() + 1)[1:].view(shape)   # base 4 bytes off
    for dtype in (F32, BF16):
        for t in (x, cm, off):
            assert M.im2col_plan(dtype, shape, t.stride(), k, k, 1,
                                 pad) == "band"
        _, o_sr = _out_strides(BATCH, c, k, _p(h, k, pad), bic)
        b = M.im2col_band(dtype, shape, k, k, 1, pad, o_sr, True)
        # LeNet's rows are whole vectors in the GEMM's layout; in the
        # registered one only where P is (576, 64, 1024)
        per_vec = 16 // torch.tensor([], dtype=dtype).element_size()
        assert b.vec == (o_sr % per_vec == 0)
        assert b.vec or not bic
        assert not M.im2col_band(dtype, shape, k, k, 1, pad, o_sr,
                                 False).vec


@pytest.mark.parametrize("shape,k,stride,pad,route", [
    ((8, 16, 30, 30), 3, 1, 1, "band"),     # the 3 x 3 window
    ((8, 16, 30, 30), 3, 2, 1, "flat"),     # stride 2
    ((64, 3, 32, 32), 5, 2, 2, "flat"),
    ((2, 3, 16, 16), 7, 1, 3, "flat"),      # windows not instantiated
    ((2, 3, 16, 16), 1, 1, 0, "flat"),
    ((2, 3, 16, 16), 4, 1, 0, "flat"),
    ((1, 1, 70000, 70000), 5, 1, 2, "flat"),   # x past 2**31 elements
    ((70000, 1, 8, 8), 3, 1, 1, "flat"),       # images past gridDim.z
    ((64, 3, 8, 4096), 5, 1, 0, "flat"),       # one band past 48 KB
])
def test_im2col_plan_off_path(shape, k, stride, pad, route):
    st = (shape[1] * shape[2] * shape[3], shape[2] * shape[3], shape[3], 1)
    for dtype in (F32, BF16):
        if shape[3] == 4096 and dtype == BF16:
            continue   # half the bytes: that band fits
        assert M.im2col_plan(dtype, shape, st, k, k, stride, pad) == route


def test_im2col_plan_output_past_int32():
    # x within 2**31 elements, its 25-fold output past it
    shape = (64, 64, 256, 256)
    st = (64 * 256 * 256, 256 * 256, 256, 1)
    assert M.im2col_plan(F32, shape, st, 5, 5, 1, 2) == "flat"
    assert M.im2col_plan(F32, (1,) + shape[1:], st, 5, 5, 1, 2) == "band"


def _col_views(n, c, h, k, pad):
    """cols' shape and the strides of its two layouts: the backward
    product's (R, N*P) read as (N, R, P) through a transposed view, and a
    contiguous (N, R, P)."""
    r, p = c * k * k, _p(h, k, pad)
    return (n, r, p), ((p, n * p, 1), (r * p, p, 1))


@pytest.mark.parametrize("case", LENET_DX)
def test_col2im_plan_takes_tile_at_lenet(case):
    c, h, k, pad = case
    shape, layouts = _col_views(BATCH, c, h, k, pad)
    for dtype in (F32, BF16):
        for st in layouts:
            assert M.col2im_plan(dtype, (BATCH, c, h, h), shape, st, k, k,
                                 pad) == "tile"


@pytest.mark.parametrize("x_shape,k,pad,route", [
    ((8, 16, 30, 30), 3, 1, "tile"),
    ((2, 3, 16, 16), 7, 3, "flat"),
    ((2, 3, 16, 16), 4, 0, "flat"),
    ((1, 1, 50000, 50000), 3, 1, "flat"),      # the image past 2**31
    ((70000, 1, 8, 8), 3, 1, "flat"),          # images past gridDim.z
])
def test_col2im_plan_off_path(x_shape, k, pad, route):
    n, c, h, w = x_shape
    r, p = c * k * k, conv_out_size(h, k, 1, pad) * conv_out_size(
        w, k, 1, pad)
    for dtype in (F32, BF16):
        assert M.col2im_plan(dtype, x_shape, (n, r, p), (r * p, p, 1), k,
                             k, pad) == route


def test_col2im_plan_cols_past_int32():
    # the image within 2**31 elements, its 25-fold columns past it
    x_shape = (64, 64, 256, 256)
    shape, (st, _) = _col_views(*x_shape[:3], 5, 2)
    assert M.col2im_plan(F32, x_shape, shape, st, 5, 5, 2) == "flat"


def _band_walk(x, k, pad, bic, band):
    """im2col's "band" kernel (``csrc/im2col.cu:im2col_band_kernel``) in
    its own index arithmetic, block by block: the staged rows (image
    cells by the strides, padding as 0), then each item's VE columns and
    every tap's store, a whole vector as one store at an address the
    vector's size divides.  Returns the flat output, the plain version's,
    the write counts, and the number of 16-byte stores."""
    n, c, h, w = x.shape
    s = 1
    oh = ow = conv_out_size(h, k, s, pad)
    p_all, kk = oh * ow, k * k
    o_sn, o_sr = _out_strides(n, c, k, p_all, bic)
    per_vec = 16 // x.element_size()
    ve = per_vec if band.vec else 1
    xs = x.stride()
    # the whole storage, addressed as the kernel does from x's base
    xv = x.as_strided((x.untyped_storage().nbytes() // x.element_size(),),
                      (1,), 0)
    total = n * c * kk * p_all
    out = torch.zeros(total, dtype=x.dtype)
    seen = np.zeros(total, np.int64)
    vec_stores = 0
    taps = np.arange(kk)
    ti, tj = taps // k, taps % k
    for bz in range(n):
        for c0 in range(c):
            for bx in range(-(-oh // band.rows)):
                oy0 = bx * band.rows
                ra = min(band.rows, oh - oy0)
                rin, wpu = (ra - 1) * s + k, (ow - 1) * s + k
                y0, cells = oy0 * s - pad, rin * wpu
                assert cells * x.element_size() <= M.BAND_SMEM
                t = np.arange(cells)
                y, xx = y0 + t // wpu, t % wpu - pad
                inside = (y >= 0) & (y < h) & (xx >= 0) & (xx < w)
                at = (x.storage_offset() + bz * xs[0] + c0 * xs[1]
                      + y * xs[2] + xx * xs[3])
                staged = torch.zeros(cells, dtype=x.dtype)
                staged[inside] = xv[at[inside]]
                p_lo, p_hi = oy0 * ow, (oy0 + ra) * ow
                qb = bz * o_sn
                g0 = (qb + p_lo) // ve
                groups = -(-(qb + p_hi) // ve) - g0
                col = (g0 + np.arange(groups)) * ve          # (items,)
                ps = col[:, None] - qb + np.arange(ve)       # (items, VE)
                ok = (ps >= p_lo) & (ps < p_hi)
                assert ok.any(axis=1).all()
                whole = ok.all(axis=1)
                off = (ps // ow - oy0) * s * wpu + ps % ow * s
                off = np.where(ok, off, off[np.arange(groups),
                                            ok.argmax(axis=1)][:, None])
                # (items, taps, VE): row r = c0*KK + tap
                row0 = (c0 * kk + taps) * o_sr                # (KK,)
                dst = row0[None, :, None] + col[:, None, None] \
                    + np.arange(ve)
                src = off[:, None, :] + (ti * wpu + tj)[None, :, None]
                okb = np.broadcast_to(ok[:, None, :], dst.shape)
                # inside the block's part of each row
                seg = dst - row0[None, :, None] - qb
                assert ((seg >= p_lo) & (seg < p_hi))[okb].all()
                if ve > 1:
                    assert (dst[whole][:, :, 0] % per_vec == 0).all()
                    vec_stores += int(whole.sum()) * kk
                np.add.at(seen, dst[okb], 1)
                out[dst[okb]] = staged[src[okb]]
    want = ref.im2col(x, k, k, s, pad)
    if bic:
        want = want.transpose(0, 1)
    return out, want.reshape(-1), seen, vec_stores


# the walk's batches: 4 f32 images, 8 bf16 (the fewest that keep N*P a
# whole number of vectors at P = 225 and 49, so the GEMM layout's rows
# take vectors whose images' segments straddle them)
WALK_N = {F32: 4, BF16: 8}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("bic", [True, False])
@pytest.mark.parametrize("case", LENET[1:])
def test_band_walk_writes_each_output_once(case, bic, dtype):
    c, h, k, pad = case
    n = WALK_N[dtype]
    gen = torch.Generator().manual_seed(c * h)
    x = torch.randn((n, c, h, h), generator=gen).to(dtype)
    p_all = _p(h, k, pad)
    _, o_sr = _out_strides(n, c, k, p_all, bic)
    # the path's block (planned at batch 64) and the walk's own
    _, o_sr64 = _out_strides(BATCH, c, k, p_all, bic)
    for band in {M.im2col_band(dtype, (BATCH, c, h, h), k, k, 1, pad,
                               o_sr64, True)._replace(
                                   vec=M.im2col_band(dtype, x.shape, k, k,
                                                     1, pad, o_sr,
                                                     True).vec),
                 M.im2col_band(dtype, x.shape, k, k, 1, pad, o_sr, True)}:
        out, want, seen, vecs = _band_walk(x, k, pad, bic, band)
        assert (seen == 1).all()
        assert torch.equal(out, want)
        assert (vecs > 0) == band.vec


@pytest.mark.parametrize("case", [
    (2, 1, 28, 5, 0, True), (3, 3, 9, 3, 1, True), (2, 2, 11, 3, 1, False),
    (3, 2, 13, 5, 2, True)])
def test_band_walk_odd_shapes_and_column_major(case):
    # MNIST conv1 (the planner splits its rows), 3 x 3 windows on odd
    # planes, and each on a column-major x as the transposed crossing
    # hands it, a view offset by one element
    n, c, h, k, pad, bic = case
    gen = torch.Generator().manual_seed(n * h)
    x = torch.randn((n, c, h, h), generator=gen)
    p_all = _p(h, k, pad)
    _, o_sr = _out_strides(n, c, k, p_all, bic)
    cm = as_layout(x, MajorOrder.ROW, MajorOrder.COLUMN)
    off = torch.empty(x.numel() + 1)[1:].view(x.shape).copy_(x)
    for t in (x, cm, off):
        assert M.im2col_plan(F32, t.shape, t.stride(), k, k, 1,
                             pad) == "band"
        band = M.im2col_band(F32, t.shape, k, k, 1, pad, o_sr, True)
        out, want, seen, _ = _band_walk(t, k, pad, bic, band)
        assert (seen == 1).all() and torch.equal(out, want)
    # bands of one output row
    band = M.Band(rows=1, threads=32, vec=o_sr % 4 == 0)
    out, want, seen, _ = _band_walk(x, k, pad, bic, band)
    assert (seen == 1).all() and torch.equal(out, want)


def test_band_grids_fill_the_card_at_lenet():
    # >= 132 blocks at each LeNet convolution, batch 64, both layouts
    for c, h, k, pad in LENET:
        p_all = _p(h, k, pad)
        for bic in (True, False):
            _, o_sr = _out_strides(BATCH, c, k, p_all, bic)
            for dtype in (F32, BF16):
                b = M.im2col_band(dtype, (BATCH, c, h, h), k, k, 1, pad,
                                  o_sr, True)
                oh = conv_out_size(h, k, 1, pad)
                blocks = c * -(-oh // b.rows) * BATCH
                assert blocks >= M.BAND_BLOCKS
                assert 32 <= b.threads <= M.BAND_MAX_THREADS
                assert b.threads % 32 == 0
                assert M.band_smem(torch.tensor([], dtype=dtype)
                                   .element_size(), b.rows, k, k,
                                   1, conv_out_size(h, k, 1, pad)) \
                    <= M.BAND_SMEM


def _tile_walk(x_shape, t):
    """col2im's "tile" kernel (``csrc/im2col.cu:col2im_tile_kernel``):
    the (n, c, y, x) each thread item of each block writes, as write
    counts over the contiguous image."""
    n, c, h, w = x_shape
    seen = np.zeros(n * c * h * w, np.int64)
    for bz in range(n):
        for c0 in range(c):
            for bx in range(-(-h // t.rows)):
                y0 = bx * t.rows
                e = np.arange(min(t.rows, h - y0) * w)
                y, xx = y0 + e // w, e % w
                np.add.at(seen, ((bz * c + c0) * h + y) * w + xx, 1)
    return seen


@pytest.mark.parametrize("x_shape", [
    *[(BATCH, c, h, h) for c, h, _, _ in LENET_DX], (2, 3, 9, 9),
    (1, 1, 40, 40), (3, 5, 7, 13), (2, 700, 3, 3)])
def test_tile_walk_writes_each_element_once(x_shape):
    t = M.col2im_tile(x_shape)
    assert 32 <= t.threads <= M.TILE_MAX_THREADS and t.threads % 32 == 0
    assert (_tile_walk(x_shape, t) == 1).all()
    n, c, h, _ = x_shape
    if x_shape[0] == BATCH:
        assert c * -(-h // t.rows) * n >= M.TILE_BLOCKS


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


@pytest.mark.parametrize("name", ["repro_im2col", "repro_im2col_band",
                                  "repro_col2im", "repro_col2im_tile"])
def test_launchers_match_their_ctypes_signatures(name):
    src = (_build.CSRC / "im2col.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = []
    for p in params.split(","):
        p = " ".join(p.split())
        kinds.append(_CTYPES["void*" if "*" in p else
                             " ".join(p.split()[:-1])])
    assert kinds == _build._SIGNATURES[name]


def test_kernel_budgets_match_the_planners():
    src = (_build.CSRC / "im2col.cu").read_text()
    for name, value in (("kBandMaxThreads", M.BAND_MAX_THREADS),
                        ("kTileMaxThreads", M.TILE_MAX_THREADS)):
        assert int(re.search(rf"{name} = (\d+);", src).group(1)) == value
    assert re.search(r"kBandSmem = 48 \* 1024;", src) and \
        M.BAND_SMEM == 48 * 1024
    # the windows each launcher instantiates
    for kh, kw, st in M.BAND_WINDOWS:
        assert f"KH == {kh} && KW == {kw} && stride == {st}" in src
    for kh, kw in M.TILE_WINDOWS:
        assert f"col2im_tile_kernel<T, {kh}, {kw}>" in src


def _tile_emulation(cols, x_shape, k, pad):
    """The tile kernel's arithmetic in numpy f32: per image element, the
    KH*KW taps (0 for one in the padding) widened to f32 and added to an
    f32 sum that starts at 0, i outer, j inner; one rounding to cols'
    dtype at the end (done by the caller)."""
    n, c, h, w = x_shape
    oh, ow = conv_out_size(h, k, 1, pad), conv_out_size(w, k, 1, pad)
    grid = cols.reshape(n, c, k * k, oh, ow)
    acc = np.zeros((n, c, h, w), np.float32)
    y, xx = np.arange(h)[:, None], np.arange(w)[None, :]
    for i in range(k):
        for j in range(k):
            oy, ox = y + pad - i, xx + pad - j
            ok = (oy >= 0) & (oy < oh) & (ox >= 0) & (ox < ow)
            tap = np.where(ok, grid[:, :, i * k + j, np.clip(oy, 0, oh - 1),
                                    np.clip(ox, 0, ow - 1)], np.float32(0))
            acc = acc + tap.astype(np.float32)
    return acc


# CIFAR conv2's and conv3's windows (pad 2, odd P) and MNIST conv2's,
# batch 2, and a 3 x 3 window
EMU = [(2,) + (c, h, h) + (k, pad) for c, h, k, pad in LENET_DX] + [
    (2, 4, 9, 9, 3, 1)]


@pytest.mark.parametrize("case", EMU)
def test_tile_emulation_matches_pallas_and_ref(case):
    clear_tuning()
    n, c, h, w, k, pad = case
    r, p = c * k * k, _p(h, k, pad)
    cols = np.random.default_rng(sum(case)).standard_normal(
        (n, r, p)).astype(np.float32)
    got = _tile_emulation(cols, (n, c, h, w), k, pad)
    want = np.asarray(col2im_pallas(cols, (n, c, h, w), k, k, 1, pad,
                                    interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, ref.col2im(torch.from_numpy(cols), (n, c, h, w), k, k, 1,
                        pad).numpy(), **SUM_TOL)


@pytest.mark.parametrize("case", EMU[1:2])
def test_tile_emulation_bf16_matches_pallas(case):
    clear_tuning()
    n, c, h, w, k, pad = case
    r, p = c * k * k, _p(h, k, pad)
    cb = jnp.asarray(np.random.default_rng(5).standard_normal((n, r, p)),
                     jnp.bfloat16)
    want = np.asarray(col2im_pallas(cb, (n, c, h, w), k, k, 1, pad,
                                    interpret=True).astype(jnp.float32))
    c32 = np.asarray(cb.astype(jnp.float32))
    got = torch.from_numpy(_tile_emulation(c32, (n, c, h, w), k, pad)).to(
        BF16).float().numpy()
    np.testing.assert_array_equal(got, want)
