"""Portable ops — the backend-switched operator set the model calls.

Every op is registered once in ``repro_torch.core.registry`` with its two
lowerings — the plain PyTorch version (``kernels/ref.py``) and the Hopper
kernel wrapper — and exposed as a plain function; the policy
(``repro_torch.core.policy``) decides per call from the backend and the
tensor's device which one runs.  Registered so far: the ops of the
contiguous and paged decode paths and of chunked prefill; the rest of
``repro.kernels.ops`` comes with later slices.  Forward only: training
(and with it autograd) is a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.registry import dispatch, register_op
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels.eltwise import bias_add_rows as bias_add_rows_hopper
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
    k_cache: torch.Tensor,    # contiguous: (B, Smax, Hkv, D);
                              # paged: (P, page_size, Hkv, D) page pool
    v_cache: torch.Tensor,
    cache_len,                # int32 () or (B,): valid prefix incl. new token
    *,
    block_table: Optional[torch.Tensor] = None,  # (B, max_blocks) int32
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over the KV cache.  The layout switch
    point: ``block_table=None`` selects the contiguous per-row slab, a
    block table the shared page pool (``repro_torch.serving.pager``)."""
    if block_table is not None:
        return dispatch("attention_decode_paged", q)(
            q, k_cache, v_cache, cache_len, block_table, window=window,
            scale=scale,
        )
    return dispatch("attention_decode", q)(
        q, k_cache, v_cache, cache_len, window=window, scale=scale
    )


def attention_prefill_chunk(
    q: torch.Tensor,          # (B, C, Hq, D): C prompt tokens per row
    k_cache: torch.Tensor,    # contiguous (B, Smax, Hkv, D) or page pool
    v_cache: torch.Tensor,
    start,                    # int32 () or (B,): position of chunk token 0
    width,                    # int32 () or (B,): real tokens in the chunk
    *,
    block_table: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-prefill attention over the KV cache, the chunk's own K/V
    already written; the same layout switch as ``attention_decode``."""
    if block_table is not None:
        return dispatch("attention_prefill_chunk_paged", q)(
            q, k_cache, v_cache, start, width, block_table, window=window,
            scale=scale,
        )
    return dispatch("attention_prefill_chunk", q)(
        q, k_cache, v_cache, start, width, window=window, scale=scale
    )


register_op("matmul", reference=ref.gemm, hopper=gemm,
            doc="skinny streaming GEMM (NN / NT by strides)")
register_op("bias_add_rows", reference=ref.bias_add_rows,
            hopper=bias_add_rows_hopper, doc="matrixPlusVectorRows functor")
register_op("rmsnorm", reference=ref.rmsnorm, hopper=rmsnorm_hopper,
            doc="row RMSNorm, f32 statistics")
register_op("attention_decode", reference=ref.attention_decode,
            hopper=FA.flash_decode, doc="contiguous-cache decode attention")
register_op("attention_decode_paged", reference=ref.attention_decode_paged,
            hopper=FA.flash_decode_paged,
            doc="block-table paged decode attention")
register_op("attention_prefill_chunk", reference=ref.attention_prefill_chunk,
            hopper=FA.flash_prefill_chunk,
            doc="chunked-prefill attention (C-token query block vs cache)")
register_op("attention_prefill_chunk_paged",
            reference=ref.attention_prefill_chunk_paged,
            hopper=FA.flash_prefill_chunk_paged,
            doc="block-table paged chunked-prefill attention")
