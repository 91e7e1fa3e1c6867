"""Max pooling with argmax and its backward — the Hopper kernels of
Caffe's Pooling (MAX).

Replaces ``repro/kernels/pooling.py:maxpool_pallas`` and
``maxpool_bwd_pallas``.  The kernel
(``csrc/pooling.cu``) computes one output per thread, visiting its window
in row-major order with a strict ``>`` and treating a cell in the padding
as a candidate of value ``finfo(dtype).min``, so the int32 argmax (the
flat index into the padded plane) is JAX's bit for bit, ties and
all-padding windows included; bound by bytes.  The backward, for
windows that do not overlap (stride >= k, as JAX's kernel), gathers: one
thread per input pixel takes its window's ``dy`` if the stored argmax is
its own padded index (no atomics); overlapping pools take the plain
scatter in the ops layer.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import conv_out_size
from repro_torch.kernels.ref import maxpool as maxpool_ref
from repro_torch.kernels.ref import maxpool_bwd as maxpool_bwd_ref


def maxpool(x: torch.Tensor, k: int, stride: int,
            pad: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N,C,H,W) -> (out (N,C,OH,OW) in ``x.dtype``, argmax int32).  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
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
    rc = _build.lib().repro_maxpool(
        x.data_ptr(), out.data_ptr(), arg.data_ptr(), n, c, h, w,
        *x.stride(), k, stride, pad, oh, ow, DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "maxpool")
    maxpool.launches += 1
    return out, arg


maxpool.launches = 0


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
    rc = _build.lib().repro_maxpool_bwd(
        dy.data_ptr(), argmax.data_ptr(), out.data_ptr(), n, c, h, w,
        *dy.stride(), *argmax.stride(), stride, pad, oh, ow,
        DTYPES[dy.dtype], torch.cuda.current_stream(dy.device).cuda_stream,
    )
    _build.check(rc, "maxpool_bwd")
    maxpool_bwd.launches += 1
    return out


maxpool_bwd.launches = 0
