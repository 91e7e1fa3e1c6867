"""GEMM — the Hopper kernels behind every projection, the LM head, the
Caffe nets' convolutions and inner products, and both products of every
training backward.

Replaces ``repro/kernels/gemm.py:gemm_pallas``.  Four kernels, all with
f32 accumulation, picked by ``plan`` from the dtype, the shape and the
operands' layout and alignment (never by trying one and catching):

* ``f32_small`` / ``f32_splitk`` (``csrc/gemm_f32.cu``): f32 at M <=
  ``SMALL_MAX_M`` (64) with A read along M, or along K where the skinny
  kernel would leave its lanes idle (K <= ``SMALL_MAX_SPAN`` with B read
  along N, N <= it with B read along K): the Caffe nets' products -- every
  LeNet forward convolution (K = 25-800), every weight gradient dy_flat @
  cols^T (N = 25-800, K up to 65536), the inner products' forward and input
  gradient.  32 or 64 x 64 tiles of scalar IEEE FMAs through a cp.async
  ring, K split into slices summed in a fixed order by a second kernel
  where the tiles cannot fill the card (``split_k``).
* ``skinny`` (``csrc/gemm.cu``): the other products at M <=
  ``SKINNY_MAX_M[dtype]`` with A read along K (f32 decode and chunked
  prefill, K >= 2048 over wide weights): a streaming GEMM, bound by
  reading the weight once from device memory, each weight byte loaded
  once as part of a 16-byte vector and multiplied into at most 8 row
  accumulators in registers.
* ``tc`` / ``tc_splitk`` (``csrc/gemm_tc.cu``): bf16 with 16-byte aligned
  operands whose leading dimensions are multiples of 8: a tensor-core GEMM
  (mma.sync, 128 x 128 tiles, a 4-stage cp.async ring), its K split as
  above.
* ``tiled`` (``csrc/gemm.cu``): the rest -- f32 above those M (training's
  products, the check's forward, the Caffe nets' dcols and their inner
  products' x^T @ g above 64 rows), or a bf16 operand the tensor-core
  kernel cannot read with 16-byte copies: a shared-memory tiled GEMM of
  scalar FMAs, 64 x 64 output tiles.

f32 stays IEEE everywhere, never TF32, as the JAX reference computes it.
Both operands are read in place by their strides: ``b`` with unit stride
along N (the projection weights, im2col's columns) or along K (the tied
LM head ``embed.T``, the ``W.T`` of an input gradient, the ``cols.T`` of
a weight gradient), ``a`` along K or, except on the skinny kernel, along
M (the ``x.T`` of a weight gradient); no transpose is copied.
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

# The f32 small-M kernel (csrc/gemm_f32.cu): its tile is 32 or 64 rows
# (``small_tile_m``) by ``SMALL_TILE_N`` columns, K in steps of
# ``SMALL_TILE_K``.  It takes f32 products with A read along M at M <=
# ``SMALL_MAX_M``, and those with A read along K where the skinny kernel
# spreads at most ``SMALL_MAX_SPAN`` over its lanes: K with B read along N
# (its 128 K lanes, in chunks of 1024, idle at the convolutions' K =
# 25-800) or N with B read along K (its warps of 4 columns, 3-25 blocks at
# the weight gradients' N = 25-800).  Set from phase 3 of chip_smoke.py,
# which times both kernels at every LeNet product and at qwen2.5-3b's f32
# decode and prefill products (PERF.md).
SMALL_TILE_N, SMALL_TILE_K = 64, 16
SMALL_MAX_M = 64
SMALL_MAX_SPAN = 1024
# its fewest K steps a split-K slice takes (64 of K): the inner products'
# few tiles gain from slices that short, their K = 64 products lose
SMALL_MIN_SLICE_STEPS = 4

ROUTES = ("skinny", "tiled", "tc", "tc_splitk", "f32_small", "f32_splitk")


class GemmPlan(NamedTuple):
    route: str     # one of ROUTES
    splits: int    # K slices (tc_splitk, f32_splitk: > 1)
    slice_k: int   # K of each slice but the last (a multiple of the step)
    tile_m: int    # the f32 small-M kernel's tile rows (32 or 64), else 0


def small_tile_m(m: int) -> int:
    """The f32 small-M kernel's tile rows for an M-row product."""
    return 32 if m <= 32 else 64


def split_k(m: int, n: int, k: int, tile_m: int = TC_TILE_M,
            tile_n: int = TC_TILE_N, step: int = TC_TILE_K,
            min_steps: int = MIN_SLICE_STEPS):
    """(splits, slice_k) of a split-K kernel with ``tile_m`` x ``tile_n``
    output tiles and K steps of ``step`` (by default the tensor-core
    kernel's) for an (m, k) @ (k, n) product.  Where the output tiles
    already fill the 132 SMs K stays whole; otherwise K is cut into the
    slice count that brings tiles x slices nearest two blocks an SM, each
    slice a whole number of steps and at least ``min_steps`` of them.  The
    slices cover ``[0, k)`` exactly: slice z is ``[z * slice_k, min(k,
    (z + 1) * slice_k))``."""
    tiles = math.ceil(m / tile_m) * math.ceil(n / tile_n)
    steps = math.ceil(k / step)
    if tiles >= N_SMS:
        return 1, k
    want = max(1, round(2 * N_SMS / tiles))
    splits = max(1, min(want, steps // min_steps))
    per = math.ceil(steps / splits)          # steps per slice
    splits = math.ceil(steps / per)          # no empty slice
    if splits == 1:
        return 1, k
    return splits, per * step


def plan(m: int, n: int, k: int, dtype: torch.dtype, *,
         a_m_contiguous: bool, b_k_contiguous: bool,
         tc_aligned: bool) -> GemmPlan:
    """The route of an (m, k) @ (k, n) product in ``dtype``: the f32
    small-M kernel where the module's thresholds above say, split along K
    by ``split_k`` at its tile; else the skinny kernel at m <=
    ``SKINNY_MAX_M[dtype]`` with A read along K; else the tensor-core
    kernel for bf16 operands it can copy 16 bytes at a time
    (``tc_aligned``: 16-byte aligned bases, leading dimensions multiples of
    8), split along K by ``split_k``; else the scalar tiled kernel."""
    span = n if b_k_contiguous else k
    if dtype == torch.float32 and m <= SMALL_MAX_M and (
            a_m_contiguous or span <= SMALL_MAX_SPAN):
        tile_m = small_tile_m(m)
        splits, slice_k = split_k(m, n, k, tile_m, SMALL_TILE_N,
                                  SMALL_TILE_K, SMALL_MIN_SLICE_STEPS)
        return GemmPlan("f32_splitk" if splits > 1 else "f32_small", splits,
                        slice_k, tile_m)
    if m <= SKINNY_MAX_M[dtype] and not a_m_contiguous:
        return GemmPlan("skinny", 1, k, 0)
    if dtype == torch.bfloat16 and tc_aligned:
        splits, slice_k = split_k(m, n, k)
        return GemmPlan("tc_splitk" if splits > 1 else "tc", splits, slice_k,
                        0)
    return GemmPlan("tiled", 1, k, 0)


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
    # 16-byte copies: per operand for the f32 small-M kernel, both at once
    # for the others
    vec = 16 // a.element_size()
    a_vec = a.data_ptr() % 16 == 0 and lda % vec == 0
    b_vec = b.data_ptr() % 16 == 0 and ldb % vec == 0
    p = plan(m, n, k, a.dtype, a_m_contiguous=bool(a_m_contiguous),
             b_k_contiguous=bool(b_k_contiguous), tc_aligned=a_vec and b_vec)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ws = (torch.empty((p.splits, m, n), dtype=torch.float32, device=a.device)
          if p.splits > 1 else None)
    ws_ptr = None if ws is None else ws.data_ptr()
    if p.route in ("f32_small", "f32_splitk"):
        rc = _build.lib().repro_gemm_f32(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), ws_ptr, m, n, k, lda,
            a_m_contiguous, ldb, b_k_contiguous, int(a_vec), int(b_vec),
            p.tile_m, p.splits, p.slice_k, stream)
    elif p.route in ("tc", "tc_splitk"):
        rc = _build.lib().repro_gemm_tc(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), ws_ptr, m, n, k, lda,
            a_m_contiguous, ldb, b_k_contiguous, p.splits, p.slice_k, stream)
    else:
        # the C launcher takes the skinny kernel at M <= its cutoff: M for
        # the skinny route, 0 for the tiled one
        rc = _build.lib().repro_gemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            lda, a_m_contiguous, ldb, b_k_contiguous, DTYPES[a.dtype],
            int(a_vec and b_vec), m if p.route == "skinny" else 0, stream)
    _build.check(rc, "gemm")
    gemm.launches += 1
    gemm.routes[p.route] += 1
    return out


gemm.launches = 0
# launches per route, beside the total
gemm.routes = dict.fromkeys(ROUTES, 0)
