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
    lens = torch.as_tensor(cache_len, dtype=torch.int32,
                           device=q.device).reshape(-1).expand(b)
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
