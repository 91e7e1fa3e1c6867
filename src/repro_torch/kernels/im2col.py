"""im2col — the Hopper kernel of Caffe's Convolution (the paper's merged
penta-loop).

Replaces ``repro/kernels/im2col.py:im2col_pallas``.  The kernel
(``csrc/im2col.cu``) writes one output element per thread along OH*OW,
reads the image by its strides and chooses 0 for a tap in the padding, so
no padded copy is made; bound by bytes.  ``batch_in_columns`` has it write
the (C*KH*KW, N*OH*OW) matrix of the convolution's one GEMM
(``kernels/ops.py``) directly, where JAX transposes the (N, C*KH*KW,
OH*OW) result.  ``col2im`` (the convolution's backward) comes with the
Caffe training slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
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
