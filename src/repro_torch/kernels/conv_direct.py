"""conv2d_direct — the Hopper kernels of the direct convolution (implicit
GEMM), which never write the column matrix of the im2col + gemm path.

Replaces ``repro/kernels/conv_direct.py:conv2d_direct_pallas``.  Two routes
in ``csrc/conv_direct.cu``, picked by ``plan`` from the shapes (never by
trying a kernel) and counted in ``conv2d_direct.routes`` beside
``launches``:

* "reg": square 3 x 3 or 5 x 5 windows at stride 1 (every LeNet
  convolution, the autotuner's conv3x3 cell).  The window is a template
  parameter, a thread holds 4 output pixels of a row x 8 filters of f32
  sums in registers, a block adds ``ks`` channel groups' sums in group
  order at the end, and chunks of channels stream through a two-stage
  cp.async ring.  ``tiles`` sizes the block from the shapes alone.
* "scalar": the first port's kernel (8 x 8 output pixels x 32 filters a
  block, runtime window), for every other window and stride (JAX's 2 x 2
  windows, strides 2 and 3).

Both read x by its strides (0 for a tap in the padding, so no padded copy
is made), add the bias in f32 and round once to ``x.dtype``, as the TPU
kernel does.  Bound by operations at LeNet's shapes but MNIST conv1's,
which its bytes bound.

Like JAX's ``conv2d_direct_pallas``, it has no backward: under grad the
wrapper raises (``_build.guard_grad``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import conv2d_direct as conv2d_direct_ref
from repro_torch.kernels.ref import conv_out_size


ROUTES = ("reg", "scalar")
# the "reg" kernel's instances: square windows at stride 1
# (csrc/conv_direct.cu:launch_reg_k)
REG_WINDOWS = (3, 5)
# a thread's output pixels (one row) and filters (kRegP, kRegFT)
REG_P, REG_FT = 4, 8
# a block's most threads (kRegMaxThreads), output strips of REG_P pixels,
# filter groups of REG_FT and channel groups; the channels a group takes
# from each stage of the ring; the blocks the grid must reach where the
# shape allows (one an SM); the shared memory the two stages may take.
# Swept on the H100 (chip_smoke.py phase 3, "conv sweep"): 4 channel
# groups put MNIST conv2 and CIFAR conv3 first; no other cap beat the
# planner's by more than 8% at any LeNet shape.
REG_MAX_THREADS = 256
REG_MAX_STRIPS = 64
REG_MAX_FG = 4
REG_MAX_GROUPS = 4
REG_CHUNK = 2
REG_BLOCKS = 132
REG_SMEM = 96 * 1024


class Tiles(NamedTuple):
    """A "reg" block: ``filters`` (a multiple of ``REG_FT``) x ``rows`` x
    ``cols`` output pixels (``cols`` a multiple of ``REG_P``) of one image,
    ``groups`` channel groups, stages of ``chunk`` channels, ``threads``."""
    filters: int
    rows: int
    cols: int
    chunk: int
    groups: int
    threads: int


def plan(dtype: torch.dtype, x_shape, w_shape, stride: int,
         pad: int) -> str:
    """The route: "reg" for a square window of ``REG_WINDOWS`` at stride 1,
    "scalar" for every other.  Neither reads x in 16-byte pieces (a
    window's rows start at any column), so alignment and layout play no
    part: any strides, either dtype."""
    _, _, kh, kw = w_shape
    return ("reg" if kh == kw and kh in REG_WINDOWS and stride == 1
            else "scalar")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def reg_channel_floats(t: Tiles, k: int) -> int:
    """Floats a staged channel takes (``csrc/conv_direct.cu:reg_channel``):
    its taps' weights at a padded filter pitch (``reg_fbp``), then its
    input window of ``rows + k - 1`` rows of ``cols + 4`` columns."""
    fbp = t.filters if t.filters % 16 == 8 else t.filters + 8
    return k * k * fbp + (t.rows + k - 1) * (t.cols + 4)


def reg_smem(t: Tiles, k: int) -> int:
    """Bytes of a "reg" block's shared memory: the two stages, or the sums
    of every channel group but the first where those take more."""
    per_group = t.rows * (t.cols // REG_P) * (t.filters // REG_FT)
    return 4 * max(2 * t.chunk * reg_channel_floats(t, k),
                   (t.groups - 1) * REG_P * REG_FT * per_group)


def tiles(dtype: torch.dtype, x_shape, w_shape, stride: int,
          pad: int) -> Tiles:
    """The "reg" block for these shapes.  Columns: the row's strips of
    ``REG_P`` pixels, at most 32 pixels.  Filters: up to ``REG_MAX_FG``
    groups of ``REG_FT``.  Rows: up to ``REG_MAX_STRIPS`` strips, split
    evenly.  Then, while the grid has fewer than ``REG_BLOCKS`` blocks,
    halve the filter groups, then the rows.  Channel groups: as many as
    fit ``REG_MAX_THREADS`` threads (at most ``REG_MAX_GROUPS`` and C),
    the fewest that give the fewest channels a group.  A stage holds
    ``REG_CHUNK`` channels a group (all C where that is more), fewer where
    the two stages would pass ``REG_SMEM``."""
    n, c, h, wd = x_shape
    f, _, k, _ = w_shape
    oh = conv_out_size(h, k, stride, pad)
    ow = conv_out_size(wd, k, stride, pad)
    spr = _cdiv(min(ow, 32), REG_P)
    cols = REG_P * spr
    fgroups = _cdiv(f, REG_FT)
    fg = min(fgroups, REG_MAX_FG)
    rows = min(oh, max(1, REG_MAX_STRIPS // spr))
    rows = _cdiv(oh, _cdiv(oh, rows))

    def blocks():
        return (_cdiv(oh, rows) * _cdiv(ow, cols) * _cdiv(fgroups, fg)
                * n)

    while blocks() < REG_BLOCKS and fg > 1:
        fg = _cdiv(fg, 2)
    while blocks() < REG_BLOCKS and rows > 1:
        rows = _cdiv(rows, 2)
    per_group = rows * spr * fg
    fits = [g for g in range(1, min(c, REG_MAX_GROUPS) + 1)
            if per_group * g <= REG_MAX_THREADS] or [1]
    groups = min(fits, key=lambda g: (_cdiv(c, g), g))
    chunk = c if REG_CHUNK * groups >= c else REG_CHUNK * groups
    t = Tiles(REG_FT * fg, rows, cols, chunk, groups,
              _cdiv(per_group * groups, 32) * 32)
    while reg_smem(t, k) > REG_SMEM and t.chunk > groups:
        t = t._replace(chunk=(t.chunk - 1) // groups * groups or groups)
    return t


def cost(x_shape, w_shape, stride: int = 1, pad: int = 0,
         itemsize: int = 4, bias: bool = True):
    """The direct convolution's least traffic and work, from the shapes:
    (bytes, flops, column bytes).  bytes = x read once (no padded copy) +
    w + the f32 bias + y written once; flops = 2*N*F*C*KH*KW*OH*OW; column
    bytes = the (N, C*KH*KW, OH*OW) matrix that the im2col + gemm form
    writes and reads again, and this kernel never makes."""
    n, c, h, wd = x_shape
    f, _, kh, kw = w_shape
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(wd, kw, stride, pad)
    nbytes = ((n * c * h * wd + f * c * kh * kw + n * f * oh * ow) * itemsize
              + (4 * f if bias else 0))
    flops = 2.0 * n * f * c * kh * kw * oh * ow
    return nbytes, flops, n * c * kh * kw * oh * ow * itemsize


def conv2d_direct(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *, stride: int = 1,
                  pad: int = 0) -> torch.Tensor:
    """x (N,C,H,W), read by its strides; w (F,C,KH,KW) in x's dtype; b
    (F,) of any float dtype -> (N,F,OH,OW) in x's dtype.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if not x.is_cuda:
        return conv2d_direct_ref(x, w, b, stride=stride, pad=pad)
    _build.guard_grad("conv2d_direct", x, w, b)
    if x.dim() != 4 or w.dim() != 4 or w.shape[1] != x.shape[1]:
        raise ValueError(f"conv2d_direct: x (N,C,H,W) and w (F,C,KH,KW) "
                         f"expected, got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"conv2d_direct: dtype {x.dtype} not supported")
    if w.dtype != x.dtype:
        raise TypeError(f"conv2d_direct: w is {w.dtype}, x is {x.dtype}")
    n, c, h, wd = x.shape
    f, _, kh, kw = w.shape
    if b is not None and tuple(b.shape) != (f,):
        raise ValueError(f"conv2d_direct: bias {tuple(b.shape)}, expected "
                         f"({f},)")
    if any(t.device != x.device for t in (w, b) if t is not None):
        raise ValueError("conv2d_direct: x, w and b must be on one device")
    oh = conv_out_size(h, kh, stride, pad)
    ow = conv_out_size(wd, kw, stride, pad)
    if min(kh, kw, stride) < 1 or pad < 0 or oh < 1 or ow < 1:
        raise ValueError(f"conv2d_direct: window {kh}x{kw}, stride {stride},"
                         f" pad {pad} does not fit a {h}x{wd} plane")
    out = torch.empty((n, f, oh, ow), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    w = w.contiguous()
    bias = None if b is None else b.float().contiguous()
    args = (x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), n, c,
            h, wd, *x.stride(), f, kh, kw, stride, pad, oh, ow)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    route = plan(x.dtype, x.shape, w.shape, stride, pad)
    if route == "reg":
        t = tiles(x.dtype, x.shape, w.shape, stride, pad)
        rc = _build.lib().repro_conv2d_direct_reg(
            *args, t.filters, t.rows, t.cols, t.chunk, t.groups, t.threads,
            DTYPES[x.dtype], stream)
    else:
        rc = _build.lib().repro_conv2d_direct(*args, DTYPES[x.dtype],
                                              stream)
    _build.check(rc, "conv2d_direct")
    conv2d_direct.launches += 1
    conv2d_direct.routes[route] += 1
    return out


conv2d_direct.launches = 0
# launches per route, beside the total
conv2d_direct.routes = dict.fromkeys(ROUTES, 0)
