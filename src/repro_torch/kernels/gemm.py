"""GEMM — the Hopper kernel behind every projection, the LM head and both
products of every training backward.

Replaces ``repro/kernels/gemm.py:gemm_pallas``.  ``csrc/gemm.cu`` holds two
kernels, both with f32 accumulation (f32 inputs use IEEE FMAs, never TF32):
at M <= ``SKINNY_MAX_M`` (decode, chunked prefill) a streaming skinny
GEMM, bound by reading the weight once from device memory, each weight
byte loaded once as part of a 16-byte vector and multiplied into at most 8
row accumulators in registers; above (the check's teacher-forced forward,
training's M = B*S rows and the weight gradients' M = d_in) a
shared-memory tiled GEMM with 64 x 64 output tiles.  Both
operands are read in place by their strides: ``b`` with unit stride along
N (the projection weights) or along K (the tied LM head ``embed.T`` and
the ``W.T`` of an input gradient), ``a`` along K or, for the tiled kernel,
along M (the ``x.T`` of a weight gradient); no transpose is copied.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import gemm as gemm_ref

# The largest M the skinny kernel takes; above it, the tiled kernel.  Set
# from the two kernels' crossover over one qwen2.5-3b forward's products
# (36 layers and the head), which chip_smoke.py's phase 3 measures: the
# skinny kernel is faster up to M = 128 in bf16 and f32, the tiled one at
# M = 320 (PERF.md).
SKINNY_MAX_M = 128


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M,K) @ (K,N) -> (M,N) in ``a.dtype`` (the only ``out_dtype`` the
    kernel writes).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not a.is_cuda:
        return gemm_ref(a, b, out_dtype=out_dtype)
    _build.guard_grad("gemm", a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"gemm: dtypes {a.dtype}, {b.dtype} not supported")
    if out_dtype not in (None, a.dtype):
        raise TypeError(f"gemm: the kernel writes {a.dtype}, not {out_dtype}")
    if b.device != a.device:
        raise ValueError(f"gemm: operands on {a.device} and {b.device}")
    if a.stride(1) == 1:
        a_m_contiguous, lda = 0, a.stride(0)
    elif a.stride(0) == 1:
        a_m_contiguous, lda = 1, a.stride(1)
    else:
        raise ValueError(f"gemm: a strides {a.stride()} have no unit stride")
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
              and lda % vec == 0 and ldb % vec == 0)
    rc = _build.lib().repro_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        lda, a_m_contiguous, ldb, b_k_contiguous, DTYPES[a.dtype],
        int(vec_ok), SKINNY_MAX_M,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "gemm")
    gemm.launches += 1
    return out


gemm.launches = 0
