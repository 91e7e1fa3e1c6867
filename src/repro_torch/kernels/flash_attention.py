"""Decode attention over the contiguous KV cache — Hopper kernel.

Replaces ``repro/kernels/flash_attention.py:flash_decode_pallas``.  The
kernel (``csrc/flash_attention.cu``) reads the ``(B, Smax, Hkv, D)`` cache
in place by its strides (the TPU wrapper transposed and padded it on every
call); one block per (row, kv head) walks the valid key range in tiles with
an f32 online softmax, the GQA group folded into the block's rows.  Tiles
past the row's valid length or before the window are skipped, and a row
with no valid key returns zeros.  Bound by bytes (each live K/V element read
once); at decode the grid is only ``B * Hkv`` blocks.

The paged and chunked-prefill kernels of the same JAX module come with the
next slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import attention_decode as flash_decode_ref

MAX_HEAD_DIM = 128
MAX_GROUP = 8


def _lens(cache_len, b: int, device: torch.device) -> torch.Tensor:
    """Per-row valid lengths as a (B,) int32 device tensor (no host sync)."""
    if isinstance(cache_len, torch.Tensor):
        lens = cache_len.to(device=device, dtype=torch.int32).reshape(-1)
        return lens.expand(b).contiguous()
    return torch.full((b,), int(cache_len), dtype=torch.int32, device=device)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len, *,
                 window: Optional[int] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Hq,D) against a (B,Smax,Hkv,D) cache; ``cache_len`` () or (B,).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if not q.is_cuda:
        return flash_decode_ref(q, k_cache, v_cache, cache_len,
                                window=window, scale=scale)
    b, hq, d = q.shape
    _, smax, hkv, d2 = k_cache.shape
    if v_cache.shape != k_cache.shape or d2 != d or hq % hkv:
        raise ValueError(
            f"flash_decode: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
            f"v {tuple(v_cache.shape)}"
        )
    g = hq // hkv
    if d > MAX_HEAD_DIM or g > MAX_GROUP:
        raise ValueError(
            f"flash_decode: head dim {d} > {MAX_HEAD_DIM} or group {g} > "
            f"{MAX_GROUP} not supported"
        )
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode: dtypes {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if q.stride(2) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("flash_decode: head dim needs unit stride")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("flash_decode: q and caches on different devices")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    lens = _lens(cache_len, b, q.device)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    rc = _build.lib().repro_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lens.data_ptr(), out.data_ptr(), b, smax, hkv, g, d,
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        out.stride(0), out.stride(1),
        -1 if window is None else int(window), float(scale),
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
