"""RMSNorm and its backward — Hopper kernels.

Replaces ``repro/kernels/rmsnorm.py:rmsnorm_pallas`` and
``rmsnorm_bwd_pallas``.  The forward kernel (``csrc/rmsnorm.cu``) takes
one block per row: f32 sum of squares by warp shuffles, ``x * rsqrt(mean
+ eps)`` cast to the storage dtype, then the weight multiply — the order of
``rmsnorm.py:25``.  The backward takes 4 rows per block and writes dx and
one f32 dw partial per block, summed here with ``.sum(0)`` as JAX sums its
partials outside the kernel (``rmsnorm.py:108``).  Both bound by bytes:
one read and one write of each row.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import rmsnorm as rmsnorm_ref
from repro_torch.kernels.ref import rmsnorm_bwd as rmsnorm_bwd_ref

BWD_ROWS = 4               # rows per block of the backward (csrc: kBwdRows)
# its f32 dw row and the 8-float reduction scratch share 48 KB of smem:
# (48 * 1024 - 8 * 4) / 4
MAX_BWD_WIDTH = 12280


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if not x.is_cuda:
        return rmsnorm_ref(x, w, eps)
    _build.guard_grad("rmsnorm", x, w)
    d = x.shape[-1]
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm: dtypes {x.dtype}, {w.dtype} not supported")
    if w.shape != (d,) or not w.is_contiguous() or w.device != x.device:
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} for width {d}")
    x2 = x.reshape(-1, d)
    if x2.stride(1) != 1:
        raise ValueError("rmsnorm: rows need unit stride")
    out = torch.empty((x2.shape[0], d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(x.shape)
    rc = _build.lib().repro_rmsnorm(
        x2.data_ptr(), w.data_ptr(), out.data_ptr(), x2.shape[0], d,
        x2.stride(0), float(eps), DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "rmsnorm")
    rmsnorm.launches += 1
    return out.reshape(x.shape)


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in ``x.dtype``, dw in ``w.dtype``) of RMSNorm over the last
    axis.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if not x.is_cuda:
        return rmsnorm_bwd_ref(x, w, dy, eps)
    _build.guard_grad("rmsnorm_bwd", x, w, dy)
    d = x.shape[-1]
    if x.dtype not in DTYPES or w.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(f"rmsnorm_bwd: dtypes {x.dtype}, {w.dtype}, "
                        f"{dy.dtype} not supported")
    if (w.shape != (d,) or not w.is_contiguous() or dy.shape != x.shape
            or w.device != x.device or dy.device != x.device):
        raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, dy {tuple(dy.shape)}")
    if d > MAX_BWD_WIDTH:
        raise ValueError(f"rmsnorm_bwd: width {d} > {MAX_BWD_WIDTH}")
    x2, dy2 = x.reshape(-1, d), dy.reshape(-1, d)
    if x2.stride(1) != 1 or dy2.stride(1) != 1:
        raise ValueError("rmsnorm_bwd: rows need unit stride")
    rows = x2.shape[0]
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if dx.numel() == 0:
        return dx.reshape(x.shape), torch.zeros_like(w)
    dwp = torch.empty((-(-rows // BWD_ROWS), d), dtype=torch.float32,
                      device=x.device)
    rc = _build.lib().repro_rmsnorm_bwd(
        x2.data_ptr(), w.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
        dwp.data_ptr(), rows, d, x2.stride(0), dy2.stride(0), float(eps),
        DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx.reshape(x.shape), dwp.sum(dim=0).to(w.dtype)


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
