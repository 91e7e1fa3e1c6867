"""im2col and col2im — the Hopper kernels of Caffe's Convolution (the
paper's merged penta-loop) and of its input gradient.

Replaces ``repro/kernels/im2col.py:im2col_pallas`` and ``col2im_pallas``.
Both read their input by its strides and make no padded copy; both are
bound by bytes.  ``batch_in_columns`` has im2col write the (C*KH*KW,
N*OH*OW) matrix of the convolution's one GEMM (``kernels/ops.py``)
directly, where JAX transposes the (N, C*KH*KW, OH*OW) result.  ``col2im``
(stride 1 only, as JAX's kernel) gathers each image element's taps in f32
(no atomics) and reads its (N, C*KH*KW, OH*OW) columns by their strides,
so the convolution backward's (C*KH*KW, N*OH*OW) product is read in place
through a transposed view.

Each has two routes, picked from dtype, shapes, strides, window and
stride alone (never by trying a kernel) and counted in ``im2col.routes``
and ``col2im.routes`` beside ``launches``:

* im2col "band" (``im2col_plan``: the windows of ``BAND_WINDOWS`` with
  every offset under 2**31): a block stages the input rows of ``rows``
  output rows of one (n, c) plane (``im2col_band``) in shared memory
  once, padded with zeros, and each thread writes all KH*KW tap rows of
  its output columns from there, 16-byte vectors where the output rows'
  stride keeps them aligned.  "flat": the first port's kernel, one thread
  per output element.
* col2im "tile" (``col2im_plan``: the windows of ``TILE_WINDOWS`` with
  every offset under 2**31): a block owns ``rows`` image rows of one
  (n, c) plane (``col2im_tile``), each thread all of its taps' loads
  before the first add, summed in the flat kernel's order, so the
  two agree bit for bit.  "flat": the first port's kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import col2im as col2im_ref
from repro_torch.kernels.ref import conv_out_size
from repro_torch.kernels.ref import im2col as im2col_ref

ROUTES = ("band", "flat")
COL2IM_ROUTES = ("tile", "flat")
# the (KH, KW, stride) the band kernel instantiates and the (KH, KW) the
# tile kernel does (csrc/im2col.cu: launch_band, launch_tile)
BAND_WINDOWS = ((5, 5, 1), (3, 3, 1))
TILE_WINDOWS = ((5, 5), (3, 3))
# the band kernel (csrc/im2col.cu:im2col_band_kernel): a block's most
# threads (kBandMaxThreads) and most bytes of staged rows (kBandSmem:
# dynamic, within the 48 KB a block takes without an opt-in; the kernel
# has no static shared memory); the thread items (a group of output
# columns) a block aims at, and the blocks the grid must reach where the
# shape allows (one an SM).  Swept on the H100 (chip_smoke.py phase 3,
# "band sweep"): 64 items a block came first or within 5% at each of the
# five LeNet convolutions
BAND_MAX_THREADS = 512
BAND_SMEM = 48 * 1024
BAND_ITEMS = 64
BAND_BLOCKS = 132
# the tile kernel (csrc/im2col.cu:col2im_tile_kernel): a block's most
# threads (kTileMaxThreads), the image elements it aims at and the blocks
# the grid must reach (swept as "tile sweep": the planner's block came
# first at LeNet's three col2im shapes)
TILE_MAX_THREADS = 512
TILE_ITEMS = 256
TILE_BLOCKS = 132
# CUDA's limit on gridDim.y and gridDim.z (channels, images), and
# the 32-bit indices of both new kernels
GRID_YZ = 65535
INT32 = 2 ** 31


class Band(NamedTuple):
    """A "band" block: ``rows`` output rows of one (n, c) plane,
    ``threads``, and 16-byte stores (``vec``)."""
    rows: int
    threads: int
    vec: bool


class Tile(NamedTuple):
    """A "tile" block: ``rows`` image rows of one (n, c) plane, and
    ``threads``."""
    rows: int
    threads: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _esize(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def _last(shape: Sequence[int], strides: Sequence[int]) -> int:
    """The largest element offset a tensor of this shape and these
    strides reaches."""
    return sum((d - 1) * s for d, s in zip(shape, strides))


def band_smem(es: int, rows: int, kh: int, kw: int, stride: int,
              ow: int) -> int:
    """Bytes of a "band" block's staged rows: ``(rows-1)*stride + KH``
    rows of ``(OW-1)*stride + KW`` padded columns, ``es`` bytes a cell."""
    return es * ((rows - 1) * stride + kh) * ((ow - 1) * stride + kw)


def im2col_plan(dtype: torch.dtype, shape: Sequence[int],
                strides: Sequence[int], kh: int, kw: int, stride: int,
                pad: int) -> str:
    """im2col's route: "band" for a window and stride of
    ``BAND_WINDOWS`` where every offset of x and of the output is under
    2**31, the grid's images and channels within ``GRID_YZ`` and one
    output row's band within ``BAND_SMEM``; "flat" else.  x's strides
    may be any (a column-major blob is staged by them)."""
    n, c, h, w = shape
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(w, kw, stride, pad)
    fits = (_last(shape, strides) < INT32
            and n * c * kh * kw * oh * ow < INT32
            and n <= GRID_YZ and c <= GRID_YZ
            and band_smem(_esize(dtype), 1, kh, kw, stride, ow)
            <= BAND_SMEM)
    return "band" if (kh, kw, stride) in BAND_WINDOWS and fits else "flat"


def im2col_band(dtype: torch.dtype, shape: Sequence[int], kh: int, kw: int,
                stride: int, pad: int, o_sr: int, aligned: bool) -> Band:
    """The "band" block for these shapes.  16-byte stores (``vec``) where
    the output base is aligned (``aligned``) and its row stride ``o_sr``
    is whole vectors; a thread item is then one vector of output columns
    (else one column).  The output rows whose items make ``BAND_ITEMS``
    (all OH where the plane has fewer); then, while the grid has fewer
    than ``BAND_BLOCKS`` blocks, or the band passes ``BAND_SMEM``, halve
    them; they are then split evenly.  Threads: the block's items rounded
    up to a warp, at most ``BAND_MAX_THREADS`` (then they loop)."""
    n, c, h, w = shape
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(w, kw, stride, pad)
    es = _esize(dtype)
    vec = aligned and o_sr % (16 // es) == 0
    ve = 16 // es if vec else 1

    def groups(rows):
        # the most column groups a band's rows meet (one more where a
        # vector straddles its start)
        return _cdiv(rows * ow, ve) + (ve > 1)

    rows = max(1, min(oh, BAND_ITEMS * ve // ow))
    while rows > 1 and (c * _cdiv(oh, rows) * n < BAND_BLOCKS or band_smem(
            es, rows, kh, kw, stride, ow) > BAND_SMEM):
        rows = _cdiv(rows, 2)
    rows = _cdiv(oh, _cdiv(oh, rows))
    threads = min(BAND_MAX_THREADS, _cdiv(groups(rows), 32) * 32)
    return Band(rows, threads, vec)


def col2im_plan(dtype: torch.dtype, x_shape: Sequence[int],
                cols_shape: Sequence[int], cols_strides: Sequence[int],
                kh: int, kw: int, pad: int) -> str:
    """col2im's route (stride 1): "tile" for a window of ``TILE_WINDOWS``
    where every offset of cols (by its strides) and of the image is under
    2**31 and the grid's images and channels within ``GRID_YZ``; "flat"
    else."""
    n, c, h, w = x_shape
    fits = (_last(cols_shape, cols_strides) < INT32 and n * c * h * w < INT32
            and n <= GRID_YZ and c <= GRID_YZ)
    return "tile" if (kh, kw) in TILE_WINDOWS and fits else "flat"


def col2im_tile(x_shape: Sequence[int]) -> Tile:
    """The "tile" block for an image of ``x_shape``: the image rows that
    make ``TILE_ITEMS`` elements (all H where the plane has fewer); then,
    while the grid has fewer than ``TILE_BLOCKS`` blocks, halve them; they
    are then split evenly.  Threads: the block's elements rounded up to a
    warp, at most ``TILE_MAX_THREADS`` (then they loop)."""
    n, c, h, w = x_shape
    rows = max(1, min(h, TILE_ITEMS // w))
    while rows > 1 and c * _cdiv(h, rows) * n < TILE_BLOCKS:
        rows = _cdiv(rows, 2)
    rows = _cdiv(h, _cdiv(h, rows))
    return Tile(rows, min(TILE_MAX_THREADS, _cdiv(rows * w, 32) * 32))


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           pad: int = 0, *, batch_in_columns: bool = False) -> torch.Tensor:
    """(N,C,H,W) -> (N, C*KH*KW, OH*OW), or (C*KH*KW, N*OH*OW) with
    ``batch_in_columns``, on the route ``im2col_plan`` picks.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if not x.is_cuda:
        cols = im2col_ref(x, kh, kw, stride, pad)
        if batch_in_columns:
            return cols.transpose(0, 1).reshape(cols.shape[1], -1)
        return cols
    _build.guard_grad("im2col", x)
    if x.dim() != 4:
        raise ValueError(f"im2col: x must be (N,C,H,W), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"im2col: dtype {x.dtype} not supported")
    n, c, h, w = x.shape
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(w, kw, stride, pad)
    if min(kh, kw, stride) < 1 or pad < 0 or oh < 1 or ow < 1:
        raise ValueError(f"im2col: window {kh}x{kw}, stride {stride}, pad "
                         f"{pad} does not fit a {h}x{w} plane")
    r, p = c * kh * kw, oh * ow
    if batch_in_columns:
        out = torch.empty((r, n * p), dtype=x.dtype, device=x.device)
        o_sn, o_sr = p, n * p
    else:
        out = torch.empty((n, r, p), dtype=x.dtype, device=x.device)
        o_sn, o_sr = r * p, p
    if out.numel() == 0:
        return out
    route = im2col_plan(x.dtype, x.shape, x.stride(), kh, kw, stride, pad)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "band":
        b = im2col_band(x.dtype, x.shape, kh, kw, stride, pad, o_sr,
                        out.data_ptr() % 16 == 0)
        rc = _build.lib().repro_im2col_band(
            x.data_ptr(), out.data_ptr(), n, c, h, w, *x.stride(), kh, kw,
            stride, pad, oh, ow, o_sn, o_sr, b.rows, b.threads, int(b.vec),
            DTYPES[x.dtype], stream)
    else:
        rc = _build.lib().repro_im2col(
            x.data_ptr(), out.data_ptr(), n, c, h, w, *x.stride(), kh, kw,
            stride, pad, oh, ow, o_sn, o_sr, DTYPES[x.dtype], stream)
    _build.check(rc, "im2col")
    im2col.launches += 1
    im2col.routes[route] += 1
    return out


im2col.launches = 0
# launches per route, beside the total
im2col.routes = dict.fromkeys(ROUTES, 0)


def col2im(cols: torch.Tensor, x_shape, kh: int, kw: int, stride: int = 1,
           pad: int = 0) -> torch.Tensor:
    """The adjoint of ``im2col``, stride 1: cols (N, C*KH*KW, OH*OW), read
    by its strides on the route ``col2im_plan`` picks, -> the (N,C,H,W)
    image of ``x_shape`` in ``cols.dtype``.  Another stride raises
    (``ops.col2im`` takes the plain scatter there).  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    n, c, h, w = (int(d) for d in x_shape)
    if stride != 1:
        raise NotImplementedError(
            f"col2im: the kernel takes stride 1, not {stride} "
            "(ops.col2im takes the plain version)")
    oh = conv_out_size(h, kh, 1, pad)
    ow = conv_out_size(w, kw, 1, pad)
    want = (n, c * kh * kw, oh * ow)
    if tuple(cols.shape) != want:
        raise ValueError(f"col2im: cols {tuple(cols.shape)}, expected {want}"
                         f" for {(n, c, h, w)} k{kh}x{kw} p{pad}")
    if not cols.is_cuda:
        return col2im_ref(cols, (n, c, h, w), kh, kw, 1, pad)
    _build.guard_grad("col2im", cols)
    if cols.dtype not in DTYPES:
        raise TypeError(f"col2im: dtype {cols.dtype} not supported")
    if min(kh, kw) < 1 or pad < 0 or oh < 1 or ow < 1:
        raise ValueError(f"col2im: window {kh}x{kw}, pad {pad} does not fit "
                         f"a {h}x{w} plane")
    out = torch.empty((n, c, h, w), dtype=cols.dtype, device=cols.device)
    if out.numel() == 0:
        return out
    route = col2im_plan(cols.dtype, (n, c, h, w), cols.shape, cols.stride(),
                        kh, kw, pad)
    stream = torch.cuda.current_stream(cols.device).cuda_stream
    if route == "tile":
        t = col2im_tile((n, c, h, w))
        rc = _build.lib().repro_col2im_tile(
            cols.data_ptr(), out.data_ptr(), n, c, h, w, kh, kw, pad, oh, ow,
            *cols.stride(), t.rows, t.threads, DTYPES[cols.dtype], stream)
    else:
        rc = _build.lib().repro_col2im(
            cols.data_ptr(), out.data_ptr(), n, c, h, w, kh, kw, pad, oh, ow,
            *cols.stride(), DTYPES[cols.dtype], stream)
    _build.check(rc, "col2im")
    col2im.launches += 1
    col2im.routes[route] += 1
    return out


col2im.launches = 0
# launches per route, beside the total
col2im.routes = dict.fromkeys(COL2IM_ROUTES, 0)
