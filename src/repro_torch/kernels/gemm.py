"""GEMM — the Hopper kernel behind every projection and the LM head.

Replaces ``repro/kernels/gemm.py:gemm_pallas``.  The kernel
(``csrc/gemm.cu``) is a streaming skinny GEMM for the decode path: at
M = batch rows it is bound by reading the weight once from device memory,
so each weight byte is loaded once as part of a 16-byte vector and
multiplied into at most 8 row accumulators in registers (f32 accumulation;
f32 inputs use IEEE FMAs, never TF32).  ``b`` is read in place by its
strides: unit stride along N (the projection weights) or along K (the tied
LM head, ``embed.T``, whose transpose is never copied).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import gemm as gemm_ref


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,K) @ (K,N) -> (M,N) in ``a.dtype``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if not a.is_cuda:
        return gemm_ref(a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"gemm: dtypes {a.dtype}, {b.dtype} not supported")
    if b.device != a.device:
        raise ValueError(f"gemm: operands on {a.device} and {b.device}")
    if a.stride(1) != 1:
        raise ValueError("gemm: a needs unit stride along K")
    m, k = a.shape
    n = b.shape[1]
    if b.stride(1) == 1:
        b_k_contiguous, ldb = 0, b.stride(0)
    elif b.stride(0) == 1:
        b_k_contiguous, ldb = 1, b.stride(1)
    else:
        raise ValueError(f"gemm: b strides {b.stride()} have no unit stride")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    vec = 16 // a.element_size()
    vec_ok = (a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
              and a.stride(0) % vec == 0 and ldb % vec == 0)
    rc = _build.lib().repro_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        a.stride(0), ldb, b_k_contiguous, DTYPES[a.dtype], int(vec_ok),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "gemm")
    gemm.launches += 1
    return out


gemm.launches = 0
