"""The max pool's routes on the CPU, and a plain emulation of what its
staged-band kernel computes, against the JAX package.

``kernels/pooling.py`` picks the route in pure Python, and the card's
kernels follow it: ``maxpool_plan`` (x's rows of unit stride -> the
"plane" kernel of ``csrc/pooling.cu``; every other layout, the column-major
blob of the transposed boundary mode -> the "strided" kernel) and
``maxpool_band`` (the plane kernel's output rows, planes and threads a
block and its 16-byte loads, from shapes, strides and alignment alone).
Held here: the routes as the wrapper hands them to the planners
(row-major, a channel slice that is row-major but not contiguous, the
column-major crossing of ``core.container.as_layout``, a view offset by
one element; f32 and bf16); a walk of the plane kernel's blocks, staged
units and threads that reaches every output once, writes every cell of
the staged band once (an image cell from its own row and column, a cell
outside the plane as padding), loads no image element twice, and stays
within the planner's shared memory, thread and plane budgets, at the
LeNet shapes (planned at batch 64, walked at batch 2) and at odd ones;
the C signature of the new launcher against
its ctypes entry and the kernel's budgets against the planner's; and an
emulation in plain PyTorch of the kernel's staged band and window walk
(f32 cells in padded coordinates, each window in row-major order with a
strict ``>``), exact in values and argmax against ``ref.maxpool`` and
``maxpool_pallas`` in interpret mode on the same numpy inputs: the LeNet
pools at batch 2, exact ties, pads 1 and 2, bands that split a plane,
and bf16.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clear_tuning  # noqa: E402
from repro.kernels.pooling import maxpool_pallas  # noqa: E402
from repro_torch.core.container import MajorOrder, as_layout  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import pooling as PO  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ref import conv_out_size  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32

# (shape, k, stride, pad): the LeNet pools at the solvers' batch of 64
# (MNIST pool1, pool2; CIFAR pool1) and the tie case's pad of 1
LENET = [((64, 20, 24, 24), 2, 2, 0), ((64, 50, 8, 8), 2, 2, 0),
         ((64, 32, 32, 32), 3, 2, 0), ((64, 32, 32, 32), 3, 2, 1)]
# odd sizes: ragged rows, windows wholly in the padding (pad >= k), a
# plane split into bands, a row too short for one vector, one output,
# one-row planes whose packed band must shrink to fit the shared memory
# (planned at 2,400 planes, walked on 9), and a one-row band a few bytes
# under the budget
ODD = [((2, 3, 9, 9), 3, 2, 1), ((1, 2, 4, 4), 2, 2, 2),
       ((2, 3, 40, 40), 3, 2, 1), ((3, 5, 7, 13), 3, 3, 0),
       ((2, 1, 3, 3), 3, 1, 0), ((1, 2, 11, 6), 2, 1, 1),
       ((8, 300, 7, 252), 7, 7, 0), ((1, 1, 8, 3924), 3, 1, 0)]
# the shapes the walk takes for a case planned at more planes: batch 2,
# or two packed blocks and a ragged third
WALKED = {shape: (2,) + shape[1:] for shape, *_ in LENET}
WALKED[(8, 300, 7, 252)] = (1, 9, 7, 252)


def _per_vec(dtype):
    return 16 // torch.tensor([], dtype=dtype).element_size()


def _plan(x, k, s, p):
    """The route and, on "plane", the band the wrapper hands the kernel."""
    route = PO.maxpool_plan(x.dtype, x.shape, x.stride(), k, s, p)
    band = PO.maxpool_band(x.dtype, x.shape, k, s, p,
                           _build.aligned16(x, elems=_per_vec(x.dtype)))
    return route, band


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape,k,s,p", [((2, 20, 24, 24), 2, 2, 0),
                                         ((2, 50, 8, 8), 2, 2, 0),
                                         ((2, 32, 32, 32), 3, 2, 0),
                                         ((2, 32, 32, 32), 3, 2, 1)])
def test_plan(dtype, shape, k, s, p):
    n, c, h, w = shape
    x = torch.zeros(shape, dtype=dtype)
    # row-major: rows of whole 16-byte vectors (24, 8 and 32 elements)
    route, band = _plan(x, k, s, p)
    assert route == "plane" and band.vec
    # a channel slice: row-major, not contiguous, still aligned
    wide = torch.zeros((n, c + 3, h, w), dtype=dtype)
    sl = wide[:, 2:2 + c]
    assert not sl.is_contiguous()
    route, band = _plan(sl, k, s, p)
    assert route == "plane" and band.vec
    # the transposed boundary mode's crossing: a column-major blob
    col = as_layout(x, MajorOrder.ROW, MajorOrder.COLUMN)
    assert col.stride(3) != 1 and _plan(col, k, s, p)[0] == "strided"
    # a view offset by one element: rows of unit stride, loaded one
    # element a thread (its base is not 16-byte aligned)
    buf = torch.zeros(x.numel() + 1, dtype=dtype)
    route, band = _plan(buf[1:].view(shape), k, s, p)
    assert route == "plane" and not band.vec
    assert _plan(buf[:-1].view(shape), k, s, p)[1].vec


def test_plan_layouts_and_limits():
    # rows of unit stride whatever the other strides: a row slice, a
    # channels-last view, a one-column plane read with any stride
    x = torch.zeros((2, 3, 10, 12))
    assert _plan(x[:, :, 1:], 2, 2, 0)[0] == "plane"
    route, band = _plan(x[:, :, :, 4:12], 2, 2, 0)     # 16 bytes in
    assert route == "plane" and band.vec
    route, band = _plan(x[:, :, :, 2:10], 2, 2, 0)     # 8 bytes in
    assert route == "plane" and not band.vec
    cl = x.to(memory_format=torch.channels_last)
    assert _plan(cl, 2, 2, 0)[0] == "strided"
    assert PO.maxpool_plan(F32, (2, 3, 5, 1), (15, 5, 1, 7), 1, 1, 0) \
        == "plane"
    # rows not whole vectors load one element a thread
    assert not _plan(torch.zeros((2, 3, 9, 9)), 3, 2, 1)[1].vec
    assert not _plan(torch.zeros((2, 3, 12, 12), dtype=BF16), 2, 2, 0)[1].vec
    # one output row's band past the static shared memory: "strided"
    wide = (1, 1, 8, 5000)
    assert PO.band_smem(1, 1, 3, 3, conv_out_size(5000, 3, 3, 0)) \
        > PO.POOL_SMEM
    assert PO.maxpool_plan(F32, wide, (40000, 40000, 5000, 1), 3, 3, 0) \
        == "strided"
    # the block's staged plane bases share the static 48 KB with the band:
    # a band of 47,088 bytes fits beside them, of 47,112 or 48,000 does not
    assert PO.POOL_SMEM + 8 * PO.POOL_MAX_PLANES == 48 * 1024
    for w, route in ((3924, "plane"), (3926, "strided"),
                     (4000, "strided")):
        assert PO.maxpool_plan(F32, (1, 1, 8, w), (8 * w, 8 * w, w, 1), 3,
                               1, 0) == route


def _walk(dtype, shape, k, s, p, band):
    """The plane kernel's visits (``csrc/pooling.cu:maxpool_plane_kernel``)
    for x of ``shape`` with row-major planes: how many threads store each
    output, how many times each image element is loaded, and, block by
    block, the staged band's cells as written (the image's flat index, -1
    for padding), which must be each cell once."""
    n, c, h, w = shape
    oh, ow = conv_out_size(h, k, s, p), conv_out_size(w, k, s, p)
    P = n * c
    bands = -(-oh // band.rows)
    blocks = -(-P // band.planes) * bands
    seen = np.zeros(P * oh * ow, np.int64)
    loads = np.zeros(P * h * w, np.int64)
    e = _per_vec(dtype) if band.vec else 1
    wpu = (ow - 1) * s + k
    for blk in range(blocks):
        g = blk // bands
        oy0 = (blk - g * bands) * band.rows
        p0 = g * band.planes
        pa, ra = min(band.planes, P - p0), min(band.rows, oh - oy0)
        rin = (ra - 1) * s + k
        y0 = oy0 * s - p
        nv, lp = w // e, min(p, wpu)
        units = nv + lp + max(0, wpu - p - w)
        t = np.arange(pa * rin * units)
        srow, u = t // units, t % units
        q, y = srow // rin, y0 + srow % rin
        inside = (y >= 0) & (y < h)
        cells = np.zeros((pa * rin, wpu), np.int64)
        src = np.full((pa * rin, wpu), -2, np.int64)
        for j in range(e):
            col = p + u * e + j
            keep = (u < nv) & (col < wpu)
            img = ((p0 + q) * h + y) * w + u * e + j
            np.add.at(cells, (srow[keep], col[keep]), 1)
            src[srow[keep], col[keep]] = np.where(inside, img, -1)[keep]
            # a vector is loaded whole; a single element only where staged
            got = inside & ((u < nv) if band.vec else keep)
            np.add.at(loads, img[got], 1)
        pu = u - nv
        pad_col = np.where(pu < lp, pu, p + w + pu - lp)
        np.add.at(cells, (srow[u >= nv], pad_col[u >= nv]), 1)
        src[srow[u >= nv], pad_col[u >= nv]] = -1
        assert (cells == 1).all(), "a staged cell written other than once"
        # each cell holds its own image element, or padding outside it
        qq, rr = np.divmod(np.arange(pa * rin), rin)
        yy = (y0 + rr)[:, None]
        xx = np.arange(wpu)[None, :] - p
        want = np.where((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w),
                        ((p0 + qq)[:, None] * h + yy) * w + xx, -1)
        np.testing.assert_array_equal(src, want)
        o = np.arange(pa * ra * ow)
        qo, r = o // (ra * ow), o % (ra * ow)
        oy, ox = r // ow, r % ow
        flat = ((p0 + qo) * oh + oy0 + oy) * ow + ox
        # the block's outputs are contiguous from (p0, oy0, 0)
        np.testing.assert_array_equal(flat, (p0 * oh + oy0) * ow + o)
        np.add.at(seen, flat, 1)
        # every window's cells lie in the staged band
        assert ((oy.max(initial=0) * s + k <= rin)
                and (ox.max(initial=0) * s + k <= wpu))
    return seen, loads, blocks


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", LENET + ODD)
def test_walk_reaches_every_output_once(dtype, case):
    """The band planned at the case's shape, walked at ``WALKED``'s."""
    shape, k, s, p = case
    n, c, h, w = shape
    band = PO.maxpool_band(dtype, shape, k, s, p, True)
    oh, ow = conv_out_size(h, k, s, p), conv_out_size(w, k, s, p)
    walked = WALKED.get(shape, shape)
    seen, loads, _ = _walk(dtype, walked, k, s, p, band)
    assert (seen == 1).all()
    assert loads.max() <= 1 or band.rows < oh   # bands overlap by k - s
    assert PO.band_smem(band.planes, band.rows, k, s, ow) <= PO.POOL_SMEM
    assert band.threads % 32 == 0 and 32 <= band.threads <= PO.POOL_THREADS
    assert 1 <= band.planes <= PO.POOL_MAX_PLANES
    assert band.planes == 1 or band.rows == oh
    if case in LENET:
        # whole planes, each image element the windows read loaded once,
        # and at batch 64 a grid that fills the card
        blocks = -(-n * c // band.planes) * -(-oh // band.rows)
        assert band.rows == oh and blocks >= PO.POOL_BLOCKS
        need = (oh - 1) * s + k - p
        rows_read = loads.reshape(-1, h, w)[:, :min(h, need)]
        assert (rows_read == 1).all() and loads.sum() == rows_read.sum()


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


@pytest.mark.parametrize("name", ["repro_maxpool", "repro_maxpool_plane"])
def test_launchers_match_their_ctypes_signatures(name):
    src = (_build.CSRC / "pooling.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = []
    for prm in params.split(","):
        prm = " ".join(prm.split())
        kinds.append(_CTYPES["void*" if "*" in prm else
                             " ".join(prm.split()[:-1])])
    assert kinds == _build._SIGNATURES[name]


def test_kernel_budgets_are_the_planners():
    src = (_build.CSRC / "pooling.cu").read_text()

    consts = {}

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        expr = expr.replace("(int)sizeof(long long)", "8")
        consts[name] = eval(expr, {"__builtins__": {}}, consts)
        return consts[name]
    assert const("kPlaneThreads") == PO.POOL_THREADS
    assert const("kMaxPlanes") == PO.POOL_MAX_PLANES
    assert const("kPlaneSmem") == PO.POOL_SMEM
    # the static bases the kernel declares beside its dynamic band
    assert "__shared__ long long base[kMaxPlanes];" in src


def _plane_emulation(x, k, s, p, band=None):
    """The plane kernel on x: block by block, the band staged as f32 in
    padded coordinates (finfo(dtype).min outside the plane), then each
    output's window visited in row-major order with a strict ``>``, the
    winner stored back in x's dtype and its padded index as the argmax."""
    n, c, h, w = x.shape
    oh, ow = conv_out_size(h, k, s, p), conv_out_size(w, k, s, p)
    if band is None:
        band = _plan(x, k, s, p)[1]
    P, wp, wpu = n * c, w + 2 * p, (ow - 1) * s + k
    planes = x.reshape(P, h, w).float()
    out = torch.empty(P * oh * ow, dtype=x.dtype)
    arg = torch.empty(P * oh * ow, dtype=torch.int32)
    neg = torch.finfo(x.dtype).min
    bands = -(-oh // band.rows)
    for blk in range(-(-P // band.planes) * bands):
        g = blk // bands
        oy0 = (blk - g * bands) * band.rows
        p0 = g * band.planes
        pa, ra = min(band.planes, P - p0), min(band.rows, oh - oy0)
        rin, y0 = (ra - 1) * s + k, oy0 * s - p
        staged = torch.full((pa, rin, wpu), neg, dtype=torch.float32)
        lo, hi = max(0, y0), min(h, y0 + rin)
        wc = min(w, wpu - p)
        if hi > lo and wc > 0:
            staged[:, lo - y0:hi - y0, p:p + wc] = \
                planes[p0:p0 + pa, lo:hi, :wc]
        rows = (torch.arange(ra) * s)[:, None]
        cols = (torch.arange(ow) * s)[None, :]
        best = staged[:, rows, cols]
        bi = torch.zeros(best.shape, dtype=torch.int64)
        bj = torch.zeros(best.shape, dtype=torch.int64)
        for i in range(k):
            for j in range(k):
                v = staged[:, rows + i, cols + j]
                take = v > best
                best = torch.where(take, v, best)
                bi = torch.where(take, i, bi)
                bj = torch.where(take, j, bj)
        a = ((oy0 + torch.arange(ra))[:, None] * s + bi) * wp + cols + bj
        o0 = (p0 * oh + oy0) * ow
        out[o0:o0 + best.numel()] = best.to(x.dtype).reshape(-1)
        arg[o0:o0 + best.numel()] = a.to(torch.int32).reshape(-1)
    return out.view(n, c, oh, ow), arg.view(n, c, oh, ow)


def _inputs(shape, ties, seed):
    rng = np.random.default_rng(seed)
    if ties:
        return rng.integers(-1, 2, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


# the LeNet pools at batch 2, CIFAR's on exact ties unpadded and with a
# pad of 1 (chip_smoke's tie rows), MNIST pool1's ties, then odd sizes
EMULATED = [((2, 20, 24, 24), 2, 2, 0, False), ((2, 50, 8, 8), 2, 2, 0,
                                                 False),
            ((2, 32, 32, 32), 3, 2, 0, False), ((2, 32, 32, 32), 3, 2, 0,
                                                 True),
            ((2, 32, 32, 32), 3, 2, 1, True), ((2, 20, 24, 24), 2, 2, 0,
                                                True),
            ((2, 3, 9, 9), 3, 2, 1, True), ((1, 2, 4, 4), 2, 2, 2, False),
            ((2, 3, 40, 40), 3, 2, 1, False), ((3, 5, 7, 13), 3, 3, 0,
                                                True)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape,k,s,p,ties", EMULATED)
def test_emulation_exact_against_pallas(dtype, shape, k, s, p, ties):
    clear_tuning()
    x = _inputs(shape, ties, sum(shape) + k + p)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    w_out, w_arg = maxpool_pallas(xj, k, s, p, interpret=True)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(dtype)
    route, band = _plan(xt, k, s, p)
    assert route == "plane"
    got, arg = _plane_emulation(xt, k, s, p)
    r_out, r_arg = ref.maxpool(xt, k, s, p)
    assert got.dtype == dtype and arg.dtype == torch.int32
    for want_out, want_arg in ((r_out.float().numpy(), r_arg.numpy()),
                               (np.asarray(w_out.astype(jnp.float32)),
                                np.asarray(w_arg))):
        np.testing.assert_array_equal(got.float().numpy(), want_out)
        np.testing.assert_array_equal(arg.numpy(), want_arg)


@pytest.mark.parametrize("band", [PO.Band(2, 1, 64, True),
                                  PO.Band(5, 1, 32, False),
                                  PO.Band(15, 3, 256, True)])
def test_emulation_exact_at_other_bands(band):
    """The walk is right at any band the sweep may pick: planes split into
    bands of rows, several planes a block with threads that loop."""
    x = torch.tensor(_inputs((2, 4, 32, 32), True, 5))
    got = _plane_emulation(x, 3, 2, 1 if band.rows == 2 else 0, band)
    want = ref.maxpool(x, 3, 2, 1 if band.rows == 2 else 0)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_.numpy())
