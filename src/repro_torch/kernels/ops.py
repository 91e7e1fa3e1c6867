"""Portable ops — the backend-switched operator set the model calls.

Every op is registered once in ``repro_torch.core.registry`` with its two
lowerings — the plain PyTorch version (``kernels/ref.py``) and the Hopper
kernel wrapper — and exposed as a plain function; the policy
(``repro_torch.core.policy``) decides per call from the backend and the
tensor's device which one runs.  This slice registers the four ops of the
contiguous decode path; the rest of ``repro.kernels.ops`` comes with later
slices.  Forward only: training (and with it autograd) is a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import dispatch, register_op
from repro_torch.kernels import ref
from repro_torch.kernels.eltwise import bias_add_rows as bias_add_rows_hopper
from repro_torch.kernels.flash_attention import flash_decode
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_hopper


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,K) @ (K,N), f32 accumulation, output in ``a.dtype``."""
    return dispatch("matmul", a)(a, b)


def bias_add_rows(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return dispatch("bias_add_rows", m)(m, v)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    return dispatch("rmsnorm", x)(x, w, eps)


def attention_decode(
    q: torch.Tensor,          # (B, Hq, D)
    k_cache: torch.Tensor,    # (B, Smax, Hkv, D) contiguous slab
    v_cache: torch.Tensor,
    cache_len,                # int32 () or (B,): valid prefix incl. new token
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over the contiguous KV cache (the
    paged layout comes with the next slice)."""
    return dispatch("attention_decode", q)(
        q, k_cache, v_cache, cache_len, window=window, scale=scale
    )


register_op("matmul", reference=ref.gemm, hopper=gemm,
            doc="skinny streaming GEMM (NN / NT by strides)")
register_op("bias_add_rows", reference=ref.bias_add_rows,
            hopper=bias_add_rows_hopper, doc="matrixPlusVectorRows functor")
register_op("rmsnorm", reference=ref.rmsnorm, hopper=rmsnorm_hopper,
            doc="row RMSNorm, f32 statistics")
register_op("attention_decode", reference=ref.attention_decode,
            hopper=flash_decode, doc="contiguous-cache decode attention")
