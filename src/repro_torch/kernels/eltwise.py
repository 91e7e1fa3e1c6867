"""Bias over rows — Hopper kernel (the paper's ``matrixPlusVectorRows``).

Replaces ``repro/kernels/eltwise.py:bias_add_rows_pallas``.  The kernel
(``csrc/eltwise.cu``) is one grid-stride elementwise pass, f32 add,
rounded to the storage dtype; bound by bytes.  The Caffe ReLU kernels of
the same JAX module come with the Caffe slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import bias_add_rows as bias_add_rows_ref


def bias_add_rows(m: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """(M,N) + (N,) broadcast over rows.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if not m.is_cuda:
        return bias_add_rows_ref(m, vec)
    _build.guard_grad("bias_add_rows", m, vec)
    if m.dim() != 2 or vec.shape != (m.shape[1],):
        raise ValueError(
            f"bias_add_rows: shapes {tuple(m.shape)} + {tuple(vec.shape)}"
        )
    if m.dtype not in DTYPES or vec.dtype != m.dtype:
        raise TypeError(f"bias_add_rows: dtypes {m.dtype}, {vec.dtype}")
    if m.stride(1) != 1 or not vec.is_contiguous() or vec.device != m.device:
        raise ValueError("bias_add_rows: rows and vector need unit stride")
    out = torch.empty(m.shape, dtype=m.dtype, device=m.device)
    if out.numel() == 0:
        return out
    rc = _build.lib().repro_bias_add_rows(
        m.data_ptr(), vec.data_ptr(), out.data_ptr(), m.shape[0], m.shape[1],
        m.stride(0), DTYPES[m.dtype],
        torch.cuda.current_stream(m.device).cuda_stream,
    )
    _build.check(rc, "bias_add_rows")
    bias_add_rows.launches += 1
    return out


bias_add_rows.launches = 0
