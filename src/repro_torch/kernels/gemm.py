"""GEMM — the Hopper kernels behind every projection, the LM head and both
products of every training backward.

Replaces ``repro/kernels/gemm.py:gemm_pallas``.  Three kernels, all with
f32 accumulation, picked by ``plan`` from the dtype, the shape and the
operands' alignment (never by trying one and catching):

* ``skinny`` (``csrc/gemm.cu``): at M <= ``SKINNY_MAX_M[dtype]`` (decode,
  chunked prefill) a streaming GEMM, bound by reading the weight once from
  device memory, each weight byte loaded once as part of a 16-byte vector
  and multiplied into at most 8 row accumulators in registers.
* ``tc`` / ``tc_splitk`` (``csrc/gemm_tc.cu``): above that M, or with an A
  read along M, in bf16 with 16-byte aligned operands whose leading
  dimensions are multiples of 8: a tensor-core GEMM (mma.sync, 128 x 128
  tiles, a 4-stage cp.async ring), whose K is split into slices summed by
  a second kernel in a fixed order where the output tiles cannot fill the
  card (``split_k``).
* ``tiled`` (``csrc/gemm.cu``): the same M in f32, or a bf16 operand the
  tensor-core kernel cannot read with 16-byte copies: a shared-memory
  tiled GEMM of scalar FMAs, 64 x 64 output tiles.  f32 stays IEEE, never
  TF32, as the JAX reference computes it.

Both operands are read in place by their strides: ``b`` with unit stride
along N (the projection weights) or along K (the tied LM head ``embed.T``
and the ``W.T`` of an input gradient), ``a`` along K or, for the tiled
and tensor-core kernels, along M (the ``x.T`` of a weight gradient); no
transpose is copied.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import gemm as gemm_ref

# The largest M the skinny kernel takes, per dtype; above it, the tiled
# kernels.  Set from the skinny kernel's crossover with the tensor-core
# kernel (bf16) and with the scalar tiled kernel (f32) over one
# qwen2.5-3b forward's products (36 layers and the head), which
# chip_smoke.py's phase 3 measures (PERF.md).
SKINNY_MAX_M = {torch.bfloat16: 0, torch.float32: 128}

# the tensor-core kernel's block tile and K step (csrc/gemm_tc.cu), the
# card's SMs, and the fewest K steps a split-K slice takes: a shallower
# slice writes and re-reads more partial sums than it saves in time
TC_TILE_M, TC_TILE_N, TC_TILE_K = 128, 128, 32
N_SMS = 132
MIN_SLICE_STEPS = 8

ROUTES = ("skinny", "tiled", "tc", "tc_splitk")


class GemmPlan(NamedTuple):
    route: str     # one of ROUTES
    splits: int    # K slices (tc_splitk: > 1)
    slice_k: int   # K of each slice but the last (a multiple of 32)


def split_k(m: int, n: int, k: int):
    """(splits, slice_k) of the tensor-core kernel for an (m, k) @ (k, n)
    product.  Where the output's 128 x 128 tiles already fill the 132 SMs
    K stays whole; otherwise K is cut into the slice count that brings
    tiles x slices nearest two blocks an SM (two fit an SM at once),
    each slice a whole number of 32-deep steps and at least
    ``MIN_SLICE_STEPS`` of them.  The slices cover ``[0, k)`` exactly:
    slice z is ``[z * slice_k, min(k, (z + 1) * slice_k))``."""
    tiles = math.ceil(m / TC_TILE_M) * math.ceil(n / TC_TILE_N)
    steps = math.ceil(k / TC_TILE_K)
    if tiles >= N_SMS:
        return 1, k
    want = max(1, round(2 * N_SMS / tiles))
    splits = max(1, min(want, steps // MIN_SLICE_STEPS))
    per = math.ceil(steps / splits)          # steps per slice
    splits = math.ceil(steps / per)          # no empty slice
    if splits == 1:
        return 1, k
    return splits, per * TC_TILE_K


def plan(m: int, n: int, k: int, dtype: torch.dtype, *,
         a_m_contiguous: bool, tc_aligned: bool) -> GemmPlan:
    """The route of an (m, k) @ (k, n) product in ``dtype``: the skinny
    kernel at m <= ``SKINNY_MAX_M[dtype]`` with A read along K; else the
    tensor-core kernel for bf16 operands it can copy 16 bytes at a time
    (``tc_aligned``: 16-byte aligned bases, leading dimensions multiples
    of 8), split along K by ``split_k``; else the scalar tiled kernel."""
    if m <= SKINNY_MAX_M[dtype] and not a_m_contiguous:
        return GemmPlan("skinny", 1, k)
    if dtype == torch.bfloat16 and tc_aligned:
        splits, slice_k = split_k(m, n, k)
        return GemmPlan("tc_splitk" if splits > 1 else "tc", splits, slice_k)
    return GemmPlan("tiled", 1, k)


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(M,K) @ (K,N) -> (M,N) in ``a.dtype`` (the only ``out_dtype`` the
    kernels write).  CPU tensors take the plain version; CUDA tensors
    launch the kernel ``plan`` picks or raise."""
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
    p = plan(m, n, k, a.dtype, a_m_contiguous=bool(a_m_contiguous),
             tc_aligned=vec_ok)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if p.route in ("tc", "tc_splitk"):
        ws = (torch.empty((p.splits, m, n), dtype=torch.float32,
                          device=a.device) if p.splits > 1 else None)
        rc = _build.lib().repro_gemm_tc(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, k, lda,
            a_m_contiguous, ldb, b_k_contiguous, p.splits, p.slice_k, stream)
    else:
        # the C launcher takes the skinny kernel at M <= its cutoff: M for
        # the skinny route, 0 for the tiled one
        rc = _build.lib().repro_gemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            lda, a_m_contiguous, ldb, b_k_contiguous, DTYPES[a.dtype],
            int(vec_ok), m if p.route == "skinny" else 0, stream)
    _build.check(rc, "gemm")
    gemm.launches += 1
    gemm.routes[p.route] += 1
    return out


gemm.launches = 0
# launches per route, beside the total
gemm.routes = dict.fromkeys(ROUTES, 0)
