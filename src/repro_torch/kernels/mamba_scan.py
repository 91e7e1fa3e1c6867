"""Mamba-2 SSD chunked scan — Hopper kernel.

Replaces ``repro/kernels/mamba_scan.py:ssd_scan_pallas``.  The kernel
(``csrc/ssd_scan.cu``) runs one block per (row, head): the (P, N) f32
state stays in shared memory while the block walks the chunks in order,
computing each chunk's intra-chunk term, its carried-state term and the
state it passes on (the TPU kernel's sequential grid axis becomes a loop
in the block).  ``x``, ``dt``, ``B_`` and ``C`` are read in place by their
strides: the model passes B and C as column slices of the in_proj output,
which are never copied.  Bound by bytes at decode (a read and a write of
the state); a long chunk's O(L^2 N) products run as scalar f32 FMAs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import DTYPES

MAX_CHUNK = 128
MAX_SMEM = 232448          # bytes of shared memory a Hopper block may use
_TT = 16                   # y rows per tile (csrc/ssd_scan.cu: kTT)


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Dynamic shared memory of one block (``csrc/ssd_scan.cu``'s
    ``smem_floats``)."""
    tt = min(chunk, _TT)
    return 4 * (p * (n + 1) + chunk * (n + 1) + chunk * p + 2 * tt * n
                + tt * chunk + 3 * chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C: torch.Tensor, *, chunk: int = 64,
             initial_state: Optional[torch.Tensor] = None,
             final_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, B_/C (B,S,1,N), optional
    state (B,H,P,N) f32 -> (y (B,S,H,P) in ``x.dtype``, final state
    (B,H,P,N) f32).  The kernel writes the final state into
    ``final_state`` where one is given (it may be ``initial_state``: each
    block reads its (row, head) state in full before it writes it), else
    into a new tensor.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not x.is_cuda:
        return ref.ssd_scan(x, dt, A, B_, C, chunk=chunk,
                            initial_state=initial_state,
                            final_state=final_state)
    _build.guard_grad("ssd_scan", x, dt, A, B_, C, initial_state)
    b, s, h, p = x.shape
    if B_.dim() != 4 or B_.shape[2] != 1:
        raise ValueError(f"ssd_scan: B_ {tuple(B_.shape)}: the kernel takes "
                         "one state group (n_groups == 1)")
    n = B_.shape[3]
    if (dt.shape != (b, s, h) or A.shape != (h,) or B_.shape[:2] != (b, s)
            or C.shape != B_.shape):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}"
                         f", A {tuple(A.shape)}, B_ {tuple(B_.shape)}, C "
                         f"{tuple(C.shape)}")
    if x.dtype not in DTYPES or B_.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan: dtypes {x.dtype}, {B_.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("ssd_scan: dt and A must be float32")
    if x.stride(3) != 1 or B_.stride(3) != 1 or C.stride(3) != 1:
        raise ValueError("ssd_scan: x, B_ and C need unit stride on the "
                         "last axis")
    tensors = [x, dt, A, B_, C]
    if initial_state is not None:
        if (initial_state.shape != (b, h, p, n)
                or initial_state.dtype != torch.float32
                or not initial_state.is_contiguous()):
            raise ValueError("ssd_scan: initial_state must be a contiguous "
                             f"(B,H,P,N) = {(b, h, p, n)} float32 tensor")
        tensors.append(initial_state)
    if final_state is not None:
        if (final_state.shape != (b, h, p, n)
                or final_state.dtype != torch.float32
                or not final_state.is_contiguous()):
            raise ValueError("ssd_scan: final_state must be a contiguous "
                             f"(B,H,P,N) = {(b, h, p, n)} float32 tensor")
        tensors.append(final_state)
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: operands on different devices")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} outside 1..{MAX_CHUNK}")
    chunk = min(chunk, s)
    if smem_bytes(p, n, chunk) > MAX_SMEM:
        raise ValueError(f"ssd_scan: P {p}, N {n}, chunk {chunk} need "
                         f"{smem_bytes(p, n, chunk)} bytes of shared memory")
    A = A.contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    hf = (torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
          if final_state is None else final_state)
    rc = _build.lib().repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
        C.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), hf.data_ptr(), b, s, h, p, n, chunk,
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        B_.stride(0), B_.stride(1), C.stride(0), C.stride(1),
        y.stride(0), y.stride(1), y.stride(2),
        DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, hf


ssd_scan.launches = 0
