"""Max pooling with argmax and its backward — the Hopper kernels of
Caffe's Pooling (MAX).

Replaces ``repro/kernels/pooling.py:maxpool_pallas`` and
``maxpool_bwd_pallas``.  The forward (``csrc/pooling.cu``) visits each
window in row-major order with a strict ``>`` and treats a cell in the
padding as a candidate of value ``finfo(dtype).min``, so the int32 argmax
(the flat index into the padded plane) is JAX's bit for bit, ties and
all-padding windows included; bound by bytes.  Two routes, picked by
``maxpool_plan`` from the layout (never by trying a kernel) and counted
in ``maxpool.routes`` beside ``launches``:

* "plane": x's rows have unit stride (every row-major input, contiguous
  or not).  A block stages the band of input rows its outputs' windows
  touch in shared memory, padded as it is read (whole small planes
  packed several to a block, or ``rows`` output rows of a large one:
  ``maxpool_band``), then takes its outputs from there.
* "strided": every other layout (the column-major blob of the transposed
  boundary mode): the first port's kernel, one thread per output reading
  its window by the image's four strides.

The backward, for windows that do not overlap (stride >= k, as JAX's
kernel), gathers: every input pixel takes its window's ``dy`` if the
stored argmax is its own padded index, else 0 (no atomics, every pixel
written once); overlapping pools take the plain scatter in the ops layer.
Two routes, picked by ``maxpool_bwd_plan`` from the layouts and the
stride and counted in ``maxpool_bwd.routes``:

* "window": dy's and the argmax's rows of unit stride, stride 2 or 3 (a
  template parameter of the kernel; k does not enter the backward).  A
  thread owns a 16-byte vector of output columns across the ``stride``
  image rows of one window row: it loads the argmax and dy of the windows
  its columns fall in once and writes ``stride`` vectors.  The block,
  (vectors, window rows, planes), packs several small planes or takes a
  band of a large plane's window rows (``maxpool_bwd_band``).
* "pixel": every other layout and stride: the first port's kernel, one
  thread per input pixel reading dy and the argmax by their strides.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import conv_out_size
from repro_torch.kernels.ref import maxpool as maxpool_ref
from repro_torch.kernels.ref import maxpool_bwd as maxpool_bwd_ref

ROUTES = ("plane", "strided")
# the "plane" kernel (csrc/pooling.cu:maxpool_plane_kernel): a block's most
# threads (kPlaneThreads) and planes (kMaxPlanes), the most bytes of its
# staged band (kPlaneSmem: the static 48 KB a block, no opt-in, less the
# 8-byte bases of its most planes, which share that limit); the outputs a
# block aims at, the blocks the grid must reach where the shape allows
# (one an SM), and the waves of resident blocks it may take before planes
# are packed closer.  Swept on the H100 (chip_smoke.py phase 3, "pool
# sweep"): CIFAR pool1's 2,048 one-plane blocks took two waves and 0.0131
# ms, 1,024 two-plane blocks one wave and 0.0124.
POOL_THREADS = 256
POOL_MAX_PLANES = 256
POOL_SMEM = 48 * 1024 - 8 * POOL_MAX_PLANES
POOL_OUTPUTS = 256
POOL_BLOCKS = 132
POOL_WAVES = 1
# an H100 SM: blocks, threads and bytes of shared memory it holds at once
# (the plane kernel's 2 KB of static bases and 1 KB the system keeps per
# block included)
SMS, SM_BLOCKS, SM_THREADS, SM_SMEM = 132, 32, 2048, 228 * 1024


class Band(NamedTuple):
    """A "plane" block: ``rows`` output rows (all OH where ``planes`` >
    1) of ``planes`` planes, ``threads``, and 16-byte loads (``vec``)."""
    rows: int
    planes: int
    threads: int
    vec: bool


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def band_smem(planes: int, rows: int, k: int, stride: int, ow: int) -> int:
    """Bytes of a "plane" block's staged band: f32 cells of ``planes``
    planes' ``(rows-1)*stride + k`` rows of ``(OW-1)*stride + k`` padded
    columns."""
    return 4 * planes * ((rows - 1) * stride + k) * ((ow - 1) * stride + k)


def maxpool_plan(dtype: torch.dtype, shape: Sequence[int],
                 strides: Sequence[int], k: int, stride: int,
                 pad: int) -> str:
    """The forward's route: "plane" where x's rows have unit stride (or
    are one element wide) and one output row's band fits ``POOL_SMEM``;
    "strided" for every other layout (a column-major blob)."""
    n, c, _, w = shape
    ow = conv_out_size(w, k, stride, pad)
    unit = strides[3] == 1 or w == 1
    fits = band_smem(1, 1, k, stride, ow) <= POOL_SMEM
    return "plane" if unit and fits and n * c < 2 ** 31 else "strided"


def maxpool_band(dtype: torch.dtype, shape: Sequence[int], k: int,
                 stride: int, pad: int, aligned: bool) -> Band:
    """The "plane" block for these shapes.  A plane of fewer than
    ``POOL_OUTPUTS`` outputs: as many whole planes as make them (at most
    ``POOL_MAX_PLANES``); a larger one: the output rows that make them.
    Then, while the grid has fewer than ``POOL_BLOCKS`` blocks, halve the
    planes, then the rows; while the band passes ``POOL_SMEM``, the same;
    the rows are then split evenly.  Whole planes are then packed two,
    three, ... to a block while the grid takes more than ``POOL_WAVES``
    waves of the blocks an SM holds at once (a second wave waits for the
    first's loads: ``SM_BLOCKS``, ``SM_THREADS``, ``SM_SMEM``).  Threads:
    the block's outputs rounded up to a warp, at most ``POOL_THREADS``
    (then they loop).  16-byte loads where ``aligned`` (x's base and its
    strides but the last, as ``_build.aligned16`` checks) and the rows
    are whole vectors."""
    n, c, h, w = shape
    oh = conv_out_size(h, k, stride, pad)
    ow = conv_out_size(w, k, stride, pad)
    if oh * ow < POOL_OUTPUTS:
        planes, rows = min(POOL_OUTPUTS // (oh * ow), POOL_MAX_PLANES), oh
    else:
        planes, rows = 1, max(1, POOL_OUTPUTS // ow)

    def blocks(planes):
        return _cdiv(n * c, planes) * _cdiv(oh, rows)

    def threads(planes):
        return min(POOL_THREADS, _cdiv(planes * rows * ow, 32) * 32)

    def wave(planes):
        smem = band_smem(planes, rows, k, stride, ow) + 3 * 1024
        return SMS * min(SM_BLOCKS, SM_THREADS // threads(planes),
                         SM_SMEM // smem)

    while blocks(planes) < POOL_BLOCKS and planes > 1:
        planes = _cdiv(planes, 2)
    while blocks(planes) < POOL_BLOCKS and rows > 1:
        rows = _cdiv(rows, 2)
    while (band_smem(planes, rows, k, stride, ow) > POOL_SMEM
           and planes * rows > 1):
        if planes > 1:
            planes = _cdiv(planes, 2)
        else:
            rows = _cdiv(rows, 2)
    rows = _cdiv(oh, _cdiv(oh, rows))
    if rows == oh:
        more = planes + 1
        while (blocks(planes) > POOL_WAVES * wave(planes)
               and more <= POOL_MAX_PLANES and blocks(more) >= POOL_BLOCKS
               and band_smem(more, rows, k, stride, ow) <= POOL_SMEM):
            planes, more = more, more + 1
    per_vec = 16 // torch.tensor([], dtype=dtype).element_size()
    return Band(rows, planes, threads(planes),
                aligned and w % per_vec == 0)


def maxpool(x: torch.Tensor, k: int, stride: int,
            pad: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,C,H,W) -> (out (N,C,OH,OW) in ``x.dtype``, argmax int32), x read
    by its strides on the route ``maxpool_plan`` picks.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if not x.is_cuda:
        return maxpool_ref(x, k, stride, pad)
    _build.guard_grad("maxpool", x)
    if x.dim() != 4:
        raise ValueError(f"maxpool: x must be (N,C,H,W), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"maxpool: dtype {x.dtype} not supported")
    n, c, h, w = x.shape
    oh = conv_out_size(h, k, stride, pad)
    ow = conv_out_size(w, k, stride, pad)
    if min(k, stride) < 1 or pad < 0 or oh < 1 or ow < 1:
        raise ValueError(f"maxpool: window {k}, stride {stride}, pad {pad} "
                         f"does not fit a {h}x{w} plane")
    out = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    arg = torch.empty((n, c, oh, ow), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out, arg
    route = maxpool_plan(x.dtype, x.shape, x.stride(), k, stride, pad)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "plane":
        b = maxpool_band(x.dtype, x.shape, k, stride, pad,
                         _build.aligned16(x, elems=16 // x.element_size()))
        rc = _build.lib().repro_maxpool_plane(
            x.data_ptr(), out.data_ptr(), arg.data_ptr(), n, c, h, w,
            *x.stride()[:3], k, stride, pad, oh, ow, b.rows, b.planes,
            b.threads, int(b.vec), DTYPES[x.dtype], stream)
    else:
        rc = _build.lib().repro_maxpool(
            x.data_ptr(), out.data_ptr(), arg.data_ptr(), n, c, h, w,
            *x.stride(), k, stride, pad, oh, ow, DTYPES[x.dtype], stream)
    _build.check(rc, "maxpool")
    maxpool.launches += 1
    maxpool.routes[route] += 1
    return out, arg


maxpool.launches = 0
# launches per route, beside the total
maxpool.routes = dict.fromkeys(ROUTES, 0)


BWD_ROUTES = ("window", "pixel")
# the "window" kernel (csrc/pooling.cu:maxpool_bwd_window_kernel): the
# strides it is instantiated for, a block's most threads (kBwdThreads) and
# planes (kBwdMaxPlanes: the block's z extent), the most bands of a plane
# (the grid's y extent); the units (16-byte vectors across a window row) a
# block aims at and the blocks the grid must reach where the shape allows
# (one an SM).  Swept on the H100 (chip_smoke.py phase 3, "pool_bwd
# sweep")
BWD_STRIDES = (2, 3)
BWD_THREADS = 512
BWD_MAX_PLANES = 64
BWD_MAX_BANDS = 65535
BWD_UNITS = 256
BWD_BLOCKS = 132


class BwdBand(NamedTuple):
    """A "window" block: ``cols`` 16-byte vectors of a row, ``groups``
    window rows and ``planes`` planes (its x, y and z extents, threads
    looping past them), its ``threads``, 16-byte stores (``vec``) and the
    grid's ``blocks``."""
    cols: int
    groups: int
    planes: int
    threads: int
    vec: bool
    blocks: int


def window_rows(h: int, stride: int, pad: int) -> int:
    """The window rows (``stride`` padded rows each) that hold image rows:
    ``pad // stride`` to ``(h - 1 + pad) // stride``."""
    return (h - 1 + pad) // stride - pad // stride + 1


def maxpool_bwd_plan(dtype: torch.dtype, x_shape: Sequence[int],
                     dy_strides: Sequence[int], arg_strides: Sequence[int],
                     k: int, stride: int, pad: int) -> str:
    """The backward's route: "window" where dy's and the argmax's rows
    have unit stride (or one window), the stride is one the kernel is
    instantiated for (``BWD_STRIDES``), and the planes, the bands and the
    padded plane fit its 32-bit indices and grid; "pixel" for every other
    layout and stride."""
    n, c, h, w = x_shape
    ow = conv_out_size(w, k, stride, pad)

    def unit(st):
        return st[3] == 1 or ow == 1

    fits = (n * c < 2 ** 31 and window_rows(h, stride, pad) <= BWD_MAX_BANDS
            and (h + 2 * pad) * (w + 2 * pad) < 2 ** 31)
    return "window" if stride in BWD_STRIDES and unit(dy_strides) \
        and unit(arg_strides) and fits else "pixel"


def maxpool_bwd_band(dtype: torch.dtype, x_shape: Sequence[int],
                     stride: int, pad: int) -> BwdBand:
    """The "window" block for these shapes.  A plane of fewer than
    ``BWD_UNITS`` units (window rows x 16-byte vectors): as many whole
    planes as make them (at most ``BWD_MAX_PLANES``); a larger one: the
    window rows whose vectors make them.  Then, while the grid has fewer
    than ``BWD_BLOCKS`` blocks, halve the planes, then the window rows,
    which are then split evenly.  16-byte stores where the rows are whole
    vectors (the output is contiguous)."""
    n, c, h, w = x_shape
    e = 16 // dtype.itemsize
    g_all, nv = window_rows(h, stride, pad), _cdiv(w, e)
    cols = min(nv, BWD_UNITS)
    if g_all * nv < BWD_UNITS:
        planes, groups = min(BWD_UNITS // (g_all * nv), BWD_MAX_PLANES), g_all
    else:
        planes, groups = 1, min(g_all, max(1, BWD_UNITS // cols))

    def blocks(planes, groups):
        return _cdiv(n * c, planes) * _cdiv(g_all, groups)

    while blocks(planes, groups) < BWD_BLOCKS and planes > 1:
        planes = _cdiv(planes, 2)
    while blocks(planes, groups) < BWD_BLOCKS and groups > 1:
        groups = _cdiv(groups, 2)
    groups = _cdiv(g_all, _cdiv(g_all, groups))
    return BwdBand(cols, groups, planes, cols * groups * planes,
                   w % e == 0, blocks(planes, groups))


def maxpool_bwd(dy: torch.Tensor, argmax: torch.Tensor, x_shape, k: int,
                stride: int, pad: int = 0) -> torch.Tensor:
    """dy (N,C,OH,OW) and the forward's int32 argmax -> the (N,C,H,W)
    input gradient of ``x_shape`` in ``dy.dtype``, for stride >= k
    (another stride raises: ``ops`` takes the plain scatter there).  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    n, c, h, w = (int(d) for d in x_shape)
    if stride < k:
        raise NotImplementedError(
            f"maxpool_bwd: the kernel takes stride >= k, not stride {stride}"
            f" with k {k} (overlapping pools take the plain version)")
    if dy.dim() != 4 or dy.shape[:2] != (n, c) or argmax.shape != dy.shape:
        raise ValueError(f"maxpool_bwd: dy {tuple(dy.shape)}, argmax "
                         f"{tuple(argmax.shape)} for x {(n, c, h, w)}")
    if not dy.is_cuda:
        return maxpool_bwd_ref(dy, argmax, (n, c, h, w), k, stride, pad)
    _build.guard_grad("maxpool_bwd", dy)
    if dy.dtype not in DTYPES or argmax.dtype != torch.int32 \
            or argmax.device != dy.device:
        raise TypeError(f"maxpool_bwd: dy {dy.dtype}, argmax {argmax.dtype} "
                        f"on {argmax.device}")
    oh, ow = dy.shape[2], dy.shape[3]
    out = torch.empty((n, c, h, w), dtype=dy.dtype, device=dy.device)
    if out.numel() == 0:
        return out
    route = maxpool_bwd_plan(dy.dtype, (n, c, h, w), dy.stride(),
                             argmax.stride(), k, stride, pad)
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    if route == "window":
        b = maxpool_bwd_band(dy.dtype, (n, c, h, w), stride, pad)
        rc = _build.lib().repro_maxpool_bwd_window(
            dy.data_ptr(), argmax.data_ptr(), out.data_ptr(), n, c, h, w,
            *dy.stride()[:3], *argmax.stride()[:3], stride, pad, oh, ow,
            b.cols, b.groups, b.planes,
            int(b.vec and out.data_ptr() % 16 == 0), DTYPES[dy.dtype],
            stream)
    else:
        rc = _build.lib().repro_maxpool_bwd(
            dy.data_ptr(), argmax.data_ptr(), out.data_ptr(), n, c, h, w,
            *dy.stride(), *argmax.stride(), stride, pad, oh, ow,
            DTYPES[dy.dtype], stream)
    _build.check(rc, "maxpool_bwd")
    maxpool_bwd.launches += 1
    maxpool_bwd.routes[route] += 1
    return out


maxpool_bwd.launches = 0
# launches per route, beside the total
maxpool_bwd.routes = dict.fromkeys(BWD_ROUTES, 0)
