"""Plain PyTorch versions of the ported kernels.

Each function computes what its Hopper kernel computes, with the JAX
package's arithmetic (``repro.kernels.ref`` / the Pallas kernel bodies):
the CPU tests hold these against the JAX oracles, and on the card the
kernels are held against these.  Nothing on the main path calls them when
a card is present unless the ``reference`` backend is asked for.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _rows(x, b: int, device: torch.device) -> torch.Tensor:
    """A () or (B,) int argument as a (B,) int32 tensor on ``device``; a
    Python int is filled in place, so no host-to-device copy syncs."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(-1).expand(b)
    return torch.full((b,), int(x), dtype=torch.int32, device=device)


def _gather_pages(pages: torch.Tensor, block_table: torch.Tensor,
                  b: int) -> torch.Tensor:
    """Each row's pages as a logical (B, max_blocks*page, Hkv, D) cache.
    Unmapped blocks (-1) gather page 0; readers mask them by position."""
    bt = block_table.clamp(0, pages.shape[0] - 1).long()
    return pages[bt].reshape(b, -1, *pages.shape[2:])


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M,K) @ (K,N) with f32 accumulation, output in ``a.dtype``."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def bias_add_rows(m: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """The paper's matrixPlusVectorRows functor: m[i,:] + vec."""
    return m + vec[None, :]


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Row RMSNorm in f32, cast to ``x.dtype``, then the weight multiply
    (the order of ``repro/kernels/rmsnorm.py:25``)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     *, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query row per sequence against a (B,Smax,Hkv,D) cache
    (``repro/kernels/ops.py:_attention_decode_ref``)."""
    b, hq, d = q.shape
    smax = k_cache.shape[1]
    # per-row valid lengths (continuous batching: rows at different depths)
    lens = _rows(cache_len, b, q.device)
    kpos = torch.arange(smax, device=q.device)
    mask = kpos[None, :] < lens[:, None]                    # (B, Smax)
    if window is not None:
        mask &= kpos[None, :] >= lens[:, None] - window
    hkv = k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * (
        scale if scale is not None else 1.0 / math.sqrt(d)
    )
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, hq, d)


def attention_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, cache_len,
                           block_table: torch.Tensor, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One query row per sequence against a (P,page,Hkv,D) page pool
    through a (B,max_blocks) block table
    (``repro/kernels/ops.py:_attention_decode_paged_ref``)."""
    b = q.shape[0]
    return attention_decode(q, _gather_pages(k_pages, block_table, b),
                            _gather_pages(v_pages, block_table, b),
                            cache_len, window=window, scale=scale)


def attention_prefill_chunk(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, start, width, *,
                            window: Optional[int] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """C query rows per sequence against a (B,Smax,Hkv,D) cache holding
    the chunk's own K/V (``repro/kernels/ops.py:_attention_prefill_chunk_ref``).
    Query ``i`` of row ``b`` sits at ``start + min(i, width - 1)``:
    padding rows alias the last real position, so every softmax row keeps
    a finite score."""
    b, c, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    starts = _rows(start, b, q.device)
    widths = _rows(width, b, q.device)
    i = torch.arange(c, device=q.device)[None, :]
    qpos = starts[:, None] + torch.minimum(i, widths[:, None] - 1)  # (B, C)
    kpos = torch.arange(smax, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]                 # (B,C,S)
    if window is not None:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    qg = q.reshape(b, c, hkv, g, d)
    s = torch.einsum("bchgd,bshd->bchgs", qg.float(), k_cache.float()) * (
        scale if scale is not None else 1.0 / math.sqrt(d)
    )
    s = s.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bchgs,bshd->bchgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, c, hq, d)


def attention_prefill_chunk_paged(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor, start, width,
                                  block_table: torch.Tensor, *,
                                  window: Optional[int] = None,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """The chunk math over the page pool
    (``repro/kernels/ops.py:_attention_prefill_chunk_paged_ref``)."""
    b = q.shape[0]
    return attention_prefill_chunk(
        q, _gather_pages(k_pages, block_table, b),
        _gather_pages(v_pages, block_table, b), start, width,
        window=window, scale=scale)
