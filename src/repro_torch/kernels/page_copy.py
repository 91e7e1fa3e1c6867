"""Whole-page moves between a device pool and its host tier
(``csrc/page_copy.cu``): the data plane of the serving engine's spill and
restore.

Replaces no TPU kernel.  JAX's ``repro/serving/pager.py:copy_pages`` is a
``jnp`` gather and scatter that XLA keeps on the device, where the host
tier is an ordinary array.  On the card the host tier's payloads live in
pinned host memory, and the ``(src, dst)`` ids of a move are computed on
the device by ``pager.spill_rows`` / ``restore_rows``.  A torch
composition would have to read the ids on the host (a sync outside the
harvest) or stage the whole worst case, so the move is one kernel a pool:
it reads the id pairs from device memory, skips the sentinels, and copies
whole pages in vectors of up to 16 bytes between device memory and the
pinned pool, which it addresses through its UVA device pointer.  Bound by
the host link where one side is pinned, by device-memory bytes where both
sides are on the card.

``copy_pages(dst_pool, src_pool, src, dst, axis=)`` has JAX's signature:
``axis`` is the page axis, 1 for KV and scale pools (``(stacks, n + 1,
...)``), 0 for snapshot pools (``(n + 1, ...)``).  Every pool carries the
port's trailing sentinel page; an id equal to (or past) a pool's real page
count is a sentinel.  The kernel never touches a sentinel page; the plain
version (``copy_pages_ref``: ``index_select`` then ``index_copy_``) lets
its sentinel copies land in the destination's sentinel page, which no
reader sees.  CPU pools and ids take the plain version; as soon as one of
them lies on the card the kernel runs, and a host pool that is not pinned
(so not device-addressable) raises: nothing falls back to torch or to a
staged copy.  ``dst_pool`` is written in place and returned.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build


def copy_pages_ref(dst_pool: torch.Tensor, src_pool: torch.Tensor,
                   src: torch.Tensor, dst: torch.Tensor, *,
                   axis: int = 1) -> torch.Tensor:
    """The plain version: page ``src[i]`` of ``src_pool`` to page ``dst[i]``
    of ``dst_pool`` along ``axis``, in place; sentinel ids read and write
    the pools' sentinel pages.  Pools on two devices (the card and its
    host tier) go through a staged, synchronous copy."""
    src_ids = src.long().to(src_pool.device).clamp(0, src_pool.shape[axis] - 1)
    dst_ids = dst.long().to(dst_pool.device).clamp(0, dst_pool.shape[axis] - 1)
    content = src_pool.index_select(axis, src_ids)
    dst_pool.index_copy_(axis, dst_ids,
                         content.to(dst_pool.device, dst_pool.dtype))
    return dst_pool


def copy_pages(dst_pool: torch.Tensor, src_pool: torch.Tensor,
               src: torch.Tensor, dst: torch.Tensor, *,
               axis: int = 1) -> torch.Tensor:
    """Move pages ``src[i]`` -> ``dst[i]`` between two pools of one page
    shape; see the module docstring.  One launch on the card."""
    if axis not in (0, 1):
        raise ValueError(f"copy_pages: unsupported page axis {axis}")
    tensors = (dst_pool, src_pool, src, dst)
    if not any(t.is_cuda for t in tensors):
        return copy_pages_ref(dst_pool, src_pool, src, dst, axis=axis)
    if (dst_pool.dtype != src_pool.dtype
            or dst_pool.shape[:axis] != src_pool.shape[:axis]
            or dst_pool.shape[axis + 1:] != src_pool.shape[axis + 1:]):
        raise ValueError(
            f"copy_pages: pools {tuple(src_pool.shape)} {src_pool.dtype} -> "
            f"{tuple(dst_pool.shape)} {dst_pool.dtype} differ beyond the "
            f"page axis {axis}")
    for pool in (dst_pool, src_pool):
        if not pool.is_contiguous():
            raise ValueError("copy_pages: pools must be contiguous")
        if not pool.is_cuda and not pool.is_pinned():
            raise RuntimeError(
                "copy_pages: a host pool must be pinned memory, which the "
                "kernel addresses from the card; this one is pageable")
    ids = (src, dst)
    if any(not t.is_cuda or t.dtype != torch.int64 or t.dim() != 1
           or not t.is_contiguous() for t in ids) or src.shape != dst.shape:
        raise ValueError("copy_pages: src and dst must be equal-length "
                         "contiguous int64 vectors on the card")
    device = src.device
    if any(p.is_cuda and p.device != device for p in (dst_pool, src_pool)):
        raise ValueError("copy_pages: pools and ids on different cards")
    stacks = 1 if axis == 0 else src_pool.shape[0]
    page_bytes = math.prod(src_pool.shape[axis + 1:]) * src_pool.element_size()
    n_src, n_dst = src_pool.shape[axis] - 1, dst_pool.shape[axis] - 1
    if src.numel() == 0 or page_bytes == 0 or stacks == 0:
        return dst_pool
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _build.lib().repro_page_copy(
        src_pool.data_ptr(), dst_pool.data_ptr(), src.data_ptr(),
        dst.data_ptr(), src.numel(), stacks, page_bytes, n_src, n_dst,
        (n_src + 1) * page_bytes, (n_dst + 1) * page_bytes, stream)
    _build.check(rc, "copy_pages")
    copy_pages.launches += 1
    return dst_pool


copy_pages.launches = 0
