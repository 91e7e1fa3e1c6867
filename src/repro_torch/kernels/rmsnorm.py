"""RMSNorm — Hopper kernel.

Replaces ``repro/kernels/rmsnorm.py:rmsnorm_pallas``.  The kernel
(``csrc/rmsnorm.cu``) takes one block per row: f32 sum of squares by warp
shuffles, ``x * rsqrt(mean + eps)`` cast to the storage dtype, then the
weight multiply — the order of ``rmsnorm.py:25``.  Bound by bytes: one
read and one write of each row.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import rmsnorm as rmsnorm_ref


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if not x.is_cuda:
        return rmsnorm_ref(x, w, eps)
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


rmsnorm.launches = 0
