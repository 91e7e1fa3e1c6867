"""RMSNorm and its backward — Hopper kernels.

Replaces ``repro/kernels/rmsnorm.py:rmsnorm_pallas`` and
``rmsnorm_bwd_pallas``.  The forward (``csrc/rmsnorm.cu``): f32 sum of
squares, ``x * (1 / sqrt(mean + eps))`` cast to the storage dtype, then
the weight multiply — the order of ``rmsnorm.py:25``.  Both bound by
bytes: one read and one write of each row.

The forward has two routes, picked by ``fwd_plan`` from dtype, width and
alignment (never by trying a kernel) and counted in ``rmsnorm.routes``
beside ``launches``:

* "vec": rows whose width and strides are multiples of 16 bytes, up to
  ``FWD_MAX_VECS`` vectors.  A group of warps owns a row (``fwd_rows``:
  enough warps that a lane holds at most ``FWD_VECS`` vectors, more while
  the call's warps stay within ``FWD_TARGET``, up to ``FWD_GROUP``), every
  lane loads its 16-byte vectors of x and w before the first sum, keeps x
  in registers, sums by shuffles and a barrier of the group alone, and
  stores 16 bytes at a time; ``FWD_WARPS`` warps a block, one row a group.
* "scalar": the first port's kernel, one block a row, for every other
  width and alignment.

The backward has two routes, picked by ``bwd_plan`` from dtype, width and
alignment (never by trying a kernel) and counted in
``rmsnorm_bwd.routes`` beside ``launches``:

* "vec": rows whose width and strides are multiples of 16 bytes, up to
  ``MAX_BWD_WIDTH``.  A group of warps owns a row (``bwd_rows``: the
  fewest warps whose registers hold it, at most ``BWD_GROUP``), loads x,
  dy and w once in 16-byte vectors, keeps them in registers through both
  row sums and the dx write, and adds dy * xhat into its own f32 row of
  shared memory; a block (``BWD_WARPS`` warps, its rows contiguous) then
  writes its groups' rows summed in group order as one f32 partial.
* "scalar": the first port's kernel, a block of 4 rows walked one after
  another, for every other width and alignment up to
  ``SCALAR_MAX_WIDTH``.

Both end in the same hand-written second kernel, which sums the f32
partials in a fixed order (``SUM_SLICES`` slices of rows in row order,
then the slices in order) and writes dw in w's dtype: two launches a
call, no torch reduction, the same bits on every call (JAX sums its
partials outside the kernel, ``rmsnorm.py:108``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import rmsnorm as rmsnorm_ref
from repro_torch.kernels.ref import rmsnorm_bwd as rmsnorm_bwd_ref

FWD_ROUTES = ("vec", "scalar")
# the forward's "vec" kernel (csrc/rmsnorm.cu): 16-byte vectors of x (and
# of w) a lane holds at most (kFwdVecs, fixed at compile time), the warps
# a row may be spread over (1, 2, 4 or 8), the warps a block (at most 8:
# kMaxFwdWarps), and the warps a call aims for when it spreads rows.
# Swept on the H100 (chip_smoke.py phase 3, "rmsnorm sweep"): rows spread
# to one vector a lane were first or within 4% at 4, 64 and 512 rows of
# 2048 bf16 (512 rows on one warp each took 0.0086 ms, on 8 warps 0.0077)
FWD_VECS = 8
FWD_GROUP = 8
FWD_WARPS = 8
FWD_TARGET = 4096
# the widest row of whole vectors the "vec" kernel holds in registers
# (bf16 16384, f32 8192); wider rows take "scalar"
FWD_MAX_VECS = 32 * 8 * FWD_VECS
BWD_ROUTES = ("vec", "scalar")
# the "vec" kernel (csrc/rmsnorm.cu): 16-byte vectors of each of x, dy and
# w a lane holds (kVecs), the warps a block (at most 8: kMaxBwdWarps) and
# a row (1, 2, 4 or 8: BWD_GROUP caps it), and the blocks its row
# partition aims for.  Swept on the H100 (chip_smoke.py phase 3,
# "rmsnorm_bwd sweep"): 8 warps a block and a target of 256 blocks put
# the planner's plan first at 512 rows of 2048 and of 5120.
BWD_VECS = 4
BWD_WARPS = 8
BWD_GROUP = 8
BWD_BLOCKS = 256
# shared memory the "vec" block may take for its groups' f32 dw rows
# (kMaxBwdSmem: 227 KB less 1 KB), so one group's row bounds the width (a
# multiple of 32 vectors of either dtype: no padding at the limit)
BWD_SMEM = 227 * 1024 - 1024
MAX_BWD_WIDTH = BWD_SMEM // 4
# the "scalar" kernel: rows a block (kBwdRows), and the widest row its f32
# dw row and 8-float reduction scratch fit in 48 KB of shared memory:
# (48 * 1024 - 8 * 4) / 4
SCALAR_ROWS = 4
SCALAR_MAX_WIDTH = 12280
# warps of the dw sum's block (kSumSlices): each adds a slice of the rows
SUM_SLICES = 8


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if not x.is_cuda:
        return rmsnorm_ref(x, w, eps)
    _build.guard_grad("rmsnorm", x, w)
    d = x.shape[-1]
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm: dtypes {x.dtype}, {w.dtype} not supported")
    if w.shape != (d,) or not w.is_contiguous() or w.device != x.device:
        raise ValueError(f"rmsnorm: weight {tuple(w.shape)} for width {d}")
    x2 = x.reshape(-1, d)
    if x2.stride(1) != 1:
        raise ValueError("rmsnorm: rows need unit stride")
    rows = x2.shape[0]
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(x.shape)
    route = fwd_plan(x.dtype, d, _build.aligned16(
        x2, w, out, elems=_elems(x.dtype)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "vec":
        group, warps, blocks = fwd_rows(x.dtype, rows, d)
        rc = _build.lib().repro_rmsnorm_vec(
            x2.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
            x2.stride(0), float(eps), group, warps, blocks, DTYPES[x.dtype],
            stream)
    else:
        rc = _build.lib().repro_rmsnorm(
            x2.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
            x2.stride(0), float(eps), DTYPES[x.dtype], stream)
    _build.check(rc, "rmsnorm")
    rmsnorm.launches += 1
    rmsnorm.routes[route] += 1
    return out.reshape(x.shape)


def _elems(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in 16 bytes."""
    return 16 // torch.tensor([], dtype=dtype).element_size()


def fwd_plan(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The forward's route: "vec" for rows of ``d`` that are whole
    16-byte vectors (``d`` a multiple of 8 bf16 or 4 f32, at most
    ``FWD_MAX_VECS`` of them) with ``aligned`` operands (16-byte aligned
    bases of x, w and out, x's row stride a multiple of 16 bytes);
    "scalar" for every other row."""
    e = _elems(dtype)
    return ("vec" if aligned and d % e == 0 and d // e <= FWD_MAX_VECS
            else "scalar")


def fwd_rows(dtype: torch.dtype, rows: int, d: int) -> Tuple[int, int, int]:
    """(group, warps, blocks) of the forward's "vec" kernel for ``rows``
    rows of ``d`` (a width ``fwd_plan`` sends there): ``group`` warps a
    row, the fewest (a power of two) whose lanes hold the row in
    ``FWD_VECS`` vectors each, doubled up to ``FWD_GROUP`` while every
    lane keeps a vector and the call's warps (``rows * group``) stay
    within ``FWD_TARGET`` (a few rows spread over more warps: a shorter
    chain of loads a lane); ``warps // group`` groups a block,
    ``FWD_WARPS`` warps (at least one group) or fewer where there are
    fewer rows, one row a group.  Block ``i``'s group ``k`` owns row
    ``i * groups + k``."""
    nvec = d // _elems(dtype)
    group = 1
    while 32 * group * FWD_VECS < nvec:
        group *= 2
    while (group < FWD_GROUP and 32 * group < nvec
           and 2 * group * rows <= FWD_TARGET):
        group *= 2
    groups = max(1, min(FWD_WARPS // group, rows))
    return group, groups * group, -(-rows // groups)


def bwd_plan(dtype: torch.dtype, d: int, aligned: bool) -> str:
    """The backward's route: "vec" for rows of ``d`` that are whole
    16-byte vectors (``d`` a multiple of 8 bf16 or 4 f32, at most
    ``MAX_BWD_WIDTH``) with ``aligned`` operands (16-byte aligned bases,
    row strides multiples of 16 bytes); "scalar" for every other row."""
    return ("vec" if aligned and d % _elems(dtype) == 0
            and d <= MAX_BWD_WIDTH else "scalar")


def bwd_rows(dtype: torch.dtype, rows: int,
             d: int) -> Tuple[int, int, int, int]:
    """(group, warps, rows a block, blocks) of the "vec" kernel for
    ``rows`` rows of ``d``: ``group`` warps a row, the fewest (a power of
    two up to ``BWD_GROUP``) whose ``BWD_VECS`` vectors a lane hold the
    row, wider rows walked in chunks; ``warps // group`` groups a block,
    ``BWD_WARPS`` warps (at least one group) as far as their f32 dw rows
    (``dw_row``) fit ``BWD_SMEM``; each block ``rows_per_block``
    contiguous rows, at least one a group, so the blocks come near
    ``BWD_BLOCKS``.  Block
    ``i`` owns rows ``[i * rpb, min((i + 1) * rpb, rows))``; its group
    ``k`` walks rows ``i * rpb + k``, ``+ groups``, ..."""
    per_warp = 32 * BWD_VECS * _elems(dtype)
    group = 1
    while group < BWD_GROUP and group * per_warp < d:
        group *= 2
    fit = BWD_SMEM // (4 * dw_row(dtype, d))
    groups = max(1, min(BWD_WARPS // group, fit))
    rpb = max(groups, -(-rows // BWD_BLOCKS))
    return group, groups * group, rpb, -(-rows // rpb)


def dw_row(dtype: torch.dtype, d: int) -> int:
    """Floats of a lane-major f32 dw row of ``d`` columns in the "vec"
    kernel (``csrc/rmsnorm.cu:padded_row``): whole runs of 32 16-byte
    vectors."""
    run = 32 * _elems(dtype)
    return -(-d // run) * run


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in ``x.dtype``, dw in ``w.dtype``) of RMSNorm over the last
    axis, on the route ``bwd_plan`` picks.  CPU tensors take the plain
    version; CUDA tensors launch the kernels or raise."""
    if not x.is_cuda:
        return rmsnorm_bwd_ref(x, w, dy, eps)
    _build.guard_grad("rmsnorm_bwd", x, w, dy)
    d = x.shape[-1]
    if x.dtype not in DTYPES or w.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(f"rmsnorm_bwd: dtypes {x.dtype}, {w.dtype}, "
                        f"{dy.dtype} not supported")
    if (w.shape != (d,) or not w.is_contiguous() or dy.shape != x.shape
            or w.device != x.device or dy.device != x.device):
        raise ValueError(f"rmsnorm_bwd: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, dy {tuple(dy.shape)}")
    x2, dy2 = x.reshape(-1, d), dy.reshape(-1, d)
    e = _elems(x.dtype)
    route = bwd_plan(x.dtype, d, _build.aligned16(x2, dy2, w, elems=e))
    limit = MAX_BWD_WIDTH if route == "vec" else SCALAR_MAX_WIDTH
    if d > limit:
        raise ValueError(f"rmsnorm_bwd: width {d} > {limit}"
                         + ("" if route == "vec" else
                            f" (rows that are not whole 16-byte vectors, or "
                            f"unaligned; aligned rows of a multiple of {e} "
                            f"take up to {MAX_BWD_WIDTH})"))
    if x2.stride(1) != 1 or dy2.stride(1) != 1:
        raise ValueError("rmsnorm_bwd: rows need unit stride")
    rows = x2.shape[0]
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    if dx.numel() == 0:
        return dx.reshape(x.shape), torch.zeros_like(w)
    dw = torch.empty_like(w)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "vec":
        group, warps, rpb, nb = bwd_rows(x.dtype, rows, d)
        dwp = torch.empty((nb, dw_row(x.dtype, d)), dtype=torch.float32,
                          device=x.device)
        rc = _build.lib().repro_rmsnorm_bwd_vec(
            x2.data_ptr(), w.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
            dwp.data_ptr(), dw.data_ptr(), rows, d, x2.stride(0),
            dy2.stride(0), float(eps), group, warps, rpb, DTYPES[x.dtype],
            stream)
    else:
        dwp = torch.empty((-(-rows // SCALAR_ROWS), d), dtype=torch.float32,
                          device=x.device)
        rc = _build.lib().repro_rmsnorm_bwd(
            x2.data_ptr(), w.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
            dwp.data_ptr(), dw.data_ptr(), rows, d, x2.stride(0),
            dy2.stride(0), float(eps), DTYPES[x.dtype], stream)
    _build.check(rc, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    rmsnorm_bwd.routes[route] += 1
    return dx.reshape(x.shape), dw


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
# launches per route, beside the total
rmsnorm.routes = dict.fromkeys(FWD_ROUTES, 0)
rmsnorm_bwd.routes = dict.fromkeys(BWD_ROUTES, 0)
