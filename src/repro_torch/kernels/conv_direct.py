"""conv2d_direct — the Hopper kernel of the direct convolution (implicit
GEMM), which never writes the column matrix of the im2col + gemm path.

Replaces ``repro/kernels/conv_direct.py:conv2d_direct_pallas``.  The kernel
(``csrc/conv_direct.cu``) runs a grid of (8 x 8 output pixels, 32 filters,
image); each block stages a chunk of input channels' window (read by x's
strides, 0 for a tap in the padding, so no padded copy is made) and their
weights into shared memory and keeps its sums in f32 registers; the bias
is added in f32 and the result rounded once to ``x.dtype``, as the TPU
kernel does.  The tiles are fixed (``core/registry.py``).  Bound by
operations at LeNet's shapes but MNIST conv1's, which its bytes bound.

Like JAX's ``conv2d_direct_pallas``, it has no backward: under grad the
wrapper raises (``_build.guard_grad``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import conv2d_direct as conv2d_direct_ref
from repro_torch.kernels.ref import conv_out_size


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
    rc = _build.lib().repro_conv2d_direct(
        x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), n, c, h, wd, *x.stride(), f, kh, kw, stride, pad, oh,
        ow, DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "conv2d_direct")
    conv2d_direct.launches += 1
    return out


conv2d_direct.launches = 0
