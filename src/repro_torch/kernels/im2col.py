"""im2col and col2im — the Hopper kernels of Caffe's Convolution (the
paper's merged penta-loop) and of its input gradient.

Replaces ``repro/kernels/im2col.py:im2col_pallas`` and ``col2im_pallas``.  The kernel
(``csrc/im2col.cu``) writes one output element per thread along OH*OW,
reads the image by its strides and chooses 0 for a tap in the padding, so
no padded copy is made; bound by bytes.  ``batch_in_columns`` has it write
the (C*KH*KW, N*OH*OW) matrix of the convolution's one GEMM
(``kernels/ops.py``) directly, where JAX transposes the (N, C*KH*KW,
OH*OW) result.  ``col2im`` (``csrc/im2col.cu``), stride 1 only as JAX's
kernel, gathers each image element's taps in f32 (one thread per element,
no atomics) and reads its (N, C*KH*KW, OH*OW) columns by their strides,
so the convolution backward's (C*KH*KW, N*OH*OW) product is read in
place through a transposed view.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import col2im as col2im_ref
from repro_torch.kernels.ref import conv_out_size
from repro_torch.kernels.ref import im2col as im2col_ref


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           pad: int = 0, *, batch_in_columns: bool = False) -> torch.Tensor:
    """(N,C,H,W) -> (N, C*KH*KW, OH*OW), or (C*KH*KW, N*OH*OW) with
    ``batch_in_columns``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
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
    rc = _build.lib().repro_im2col(
        x.data_ptr(), out.data_ptr(), n, c, h, w, *x.stride(), kh, kw,
        stride, pad, oh, ow, o_sn, o_sr, DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "im2col")
    im2col.launches += 1
    return out


im2col.launches = 0


def col2im(cols: torch.Tensor, x_shape, kh: int, kw: int, stride: int = 1,
           pad: int = 0) -> torch.Tensor:
    """The adjoint of ``im2col``, stride 1: cols (N, C*KH*KW, OH*OW), read
    by its strides, -> the (N,C,H,W) image of ``x_shape`` in
    ``cols.dtype``.  Another stride raises (``ops.col2im`` takes the plain
    scatter there).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
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
    rc = _build.lib().repro_col2im(
        cols.data_ptr(), out.data_ptr(), n, c, h, w, kh, kw, pad, oh, ow,
        *cols.stride(), DTYPES[cols.dtype],
        torch.cuda.current_stream(cols.device).cuda_stream,
    )
    _build.check(rc, "col2im")
    col2im.launches += 1
    return out


col2im.launches = 0
