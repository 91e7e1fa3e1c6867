"""Elementwise Hopper kernels (``csrc/eltwise.cu``): bias over rows (the
paper's ``matrixPlusVectorRows``), Caffe's leaky ReLU and its backward.

Replace ``repro/kernels/eltwise.py:bias_add_rows_pallas``, ``relu_pallas``
and ``relu_bwd_pallas``.  Each kernel is one elementwise pass in f32,
rounded to the storage dtype; bound by bytes.  The ReLU's slope is
rounded to the storage dtype before its product, as JAX's weakly typed
``slope * x`` rounds it.

The bias over rows has two routes, picked by ``bias_plan`` from dtype,
width and alignment and counted in ``bias_add_rows.routes``: "vec" where
N and m's row stride are whole 16-byte vectors on aligned bases (a 2-D
grid of row tiles and column vectors, ``bias_grid``: each thread loads
its bias vector once and up to ``BIAS_ROWS`` rows' vectors of m before its
first store); else the first port's kernel, "scalar" (one element a
thread).

The ReLU and its backward have two routes each, picked by ``relu_plan``
and ``relu_bwd_plan`` from dtype, shape, strides and alignment (never by
trying a kernel) and counted in ``relu.routes`` and ``relu_bwd.routes``
beside ``launches``.  "vec" for one dense layout with 16-byte aligned
bases (x alone for the forward, x and dy sharing it for the backward):
storage walked in memory order, ``RELU_VECS`` 16-byte vectors of each
operand a thread in flight, ``relu_vec_grid``'s blocks.  Else the first
port's kernels: the forward's "scalar" (one element a thread, for a
misaligned base), the backward's "strided" (each operand addressed by its
own strides, up to 4 axes, for mixed layouts).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import bias_add_rows as bias_add_rows_ref
from repro_torch.kernels.ref import relu as relu_ref
from repro_torch.kernels.ref import relu_bwd as relu_bwd_ref


def bias_add_rows(m: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """(M,N) + (N,) broadcast over rows.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if not m.is_cuda:
        return bias_add_rows_ref(m, vec)
    _build.guard_grad("bias_add_rows", m, vec)
    if m.dim() != 2 or vec.shape != (m.shape[1],):
        raise ValueError(
            f"bias_add_rows: shapes {tuple(m.shape)} + {tuple(vec.shape)}"
        )
    if m.dtype not in DTYPES or vec.dtype != m.dtype:
        raise TypeError(f"bias_add_rows: dtypes {m.dtype}, {vec.dtype}")
    if m.stride(1) != 1 or not vec.is_contiguous() or vec.device != m.device:
        raise ValueError("bias_add_rows: rows and vector need unit stride")
    out = torch.empty(m.shape, dtype=m.dtype, device=m.device)
    if out.numel() == 0:
        return out
    rows, n = m.shape
    route = bias_plan(m.dtype, n, _build.aligned16(
        m, vec, out, elems=_elems(m.dtype)))
    stream = torch.cuda.current_stream(m.device).cuda_stream
    if route == "vec":
        rc = _build.lib().repro_bias_add_rows_vec(
            m.data_ptr(), vec.data_ptr(), out.data_ptr(), rows, n,
            m.stride(0), *bias_grid(m.dtype, rows, n), DTYPES[m.dtype],
            stream)
    else:
        rc = _build.lib().repro_bias_add_rows(
            m.data_ptr(), vec.data_ptr(), out.data_ptr(), rows, n,
            m.stride(0), DTYPES[m.dtype], stream)
    _build.check(rc, "bias_add_rows")
    bias_add_rows.launches += 1
    bias_add_rows.routes[route] += 1
    return out


BIAS_ROUTES = ("vec", "scalar")
# the "vec" bias (csrc/eltwise.cu:bias_add_rows_vec_kernel): rows of m a
# thread (1, 2, 4 or 8: kBiasRows, each count its own instance), the
# threads a block (at most kThreads), and the blocks below which a thread
# takes fewer rows, then a block fewer row tiles
BIAS_ROWS = 4
BIAS_THREADS = 256
BIAS_BLOCKS = 132


def _elems(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in 16 bytes."""
    return 16 // torch.tensor([], dtype=dtype).element_size()


def bias_plan(dtype: torch.dtype, n: int, aligned: bool) -> str:
    """The bias's route: "vec" where N is whole 16-byte vectors (a
    multiple of 8 bf16 or 4 f32) and ``aligned`` (16-byte aligned bases of
    m, v and out, m's row stride a multiple of 16 bytes); "scalar" for
    every other (LeNet's N = 10 in f32, a view offset by one element)."""
    return "vec" if aligned and n % _elems(dtype) == 0 else "scalar"


def bias_grid(dtype: torch.dtype, m: int,
              n: int) -> Tuple[int, int, int, int, int]:
    """(rows a thread, bx, by, gx, gy) of the "vec" bias for (m, n): a
    block of ``bx`` threads across column vectors (the power of two that
    covers them, at most ``BIAS_THREADS``) by ``by`` across row tiles
    (the rest of ``BIAS_THREADS``); ``gx`` blocks cover the vectors,
    ``gy`` the row tiles of ``rows`` rows a thread.  While the grid has
    fewer than ``BIAS_BLOCKS`` blocks, first ``rows`` (from
    ``BIAS_ROWS``), then ``by`` is halved: few rows spread over more
    blocks.  Thread (tx, ty) of the block at (column block i, row block k)
    owns column vector ``i * bx + tx`` and rows ``(k * by + ty) * rows``
    .. ``+ rows - 1``."""
    nvec = n // _elems(dtype)
    bx = 1
    while bx < nvec and bx < BIAS_THREADS:
        bx *= 2
    by = BIAS_THREADS // bx
    gx = -(-nvec // bx)
    rpt = BIAS_ROWS

    def blocks():
        return gx * -(-m // (by * rpt))

    while rpt > 1 and blocks() < BIAS_BLOCKS:
        rpt //= 2
    while by > 1 and blocks() < BIAS_BLOCKS:
        by //= 2
    return rpt, bx, by, gx, -(-m // (by * rpt))


bias_add_rows.launches = 0
# launches per route, beside the total
bias_add_rows.routes = dict.fromkeys(BIAS_ROUTES, 0)


def _dense_like(x: torch.Tensor, what: str) -> torch.Tensor:
    """An empty tensor in ``x``'s layout: contiguous, or a permuted dense
    layout (a column-major blob) kept as it is."""
    if x.is_contiguous():
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    if out.stride() != x.stride():
        raise ValueError(f"{what}: strides {x.stride()} are not a dense "
                         f"layout of {tuple(x.shape)}")
    return out


RELU_ROUTES = ("vec", "scalar")
RELU_BWD_ROUTES = ("vec", "strided")
# both "vec" kernels (one walk, csrc/eltwise.cu:relu_vec_kernel): 16-byte
# vectors of each operand a thread loads before it uses any (kVecs, fixed
# at compile time), the threads of a block (kThreads), and the most
# blocks: one wave of 8 blocks on each of the H100's 132 SMs
RELU_VECS = 2
RELU_THREADS = 256
RELU_BLOCKS = 8 * 132


def _dense(shape: Sequence[int], strides: Sequence[int]) -> bool:
    """The strides lay ``shape`` out in one dense block of storage, in
    some order of the axes (axes of extent 1 play no part)."""
    expect = 1
    for st, size in sorted((s, d) for d, s in zip(shape, strides) if d != 1):
        if st != expect:
            return False
        expect *= size
    return True


def relu_plan(dtype: torch.dtype, shape: Sequence[int],
              strides: Sequence[int], aligned: bool) -> str:
    """The forward's route: "vec" where x is one dense layout (row-major,
    or the column-major blob of the transposed boundary mode) and
    ``aligned`` (16-byte aligned bases of x and out); "scalar" for every
    other (a view offset by one element)."""
    return "vec" if aligned and _dense(shape, strides) else "scalar"


def relu(x: torch.Tensor, negative_slope: float = 0.0) -> torch.Tensor:
    """``where(x > 0, x, negative_slope * x)`` of any dense layout, on the
    route ``relu_plan`` picks; the output keeps ``x``'s strides.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if not x.is_cuda:
        return relu_ref(x, negative_slope)
    _build.guard_grad("relu", x)
    if x.dtype not in DTYPES:
        raise TypeError(f"relu: dtype {x.dtype} not supported")
    out = _dense_like(x, "relu")
    if out.numel() == 0:
        return out
    route = relu_plan(x.dtype, x.shape, x.stride(),
                      _build.aligned16(x, out, elems=1))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "vec":
        rc = _build.lib().repro_relu_vec(
            x.data_ptr(), out.data_ptr(), x.numel(), float(negative_slope),
            relu_vec_grid(x.dtype, x.numel()), DTYPES[x.dtype], stream)
    else:
        rc = _build.lib().repro_relu(
            x.data_ptr(), out.data_ptr(), x.numel(), float(negative_slope),
            DTYPES[x.dtype], stream)
    _build.check(rc, "relu")
    relu.launches += 1
    relu.routes[route] += 1
    return out


relu.launches = 0
# launches per route, beside the total
relu.routes = dict.fromkeys(RELU_ROUTES, 0)


def relu_bwd_plan(dtype: torch.dtype, shape: Sequence[int],
                  x_strides: Sequence[int], dy_strides: Sequence[int],
                  aligned: bool) -> str:
    """The backward's route: "vec" where x and dy have identical strides
    over one dense layout (row-major, or a column-major blob whose dy is
    column-major too) and ``aligned`` (16-byte aligned bases of x, dy and
    dx); "strided" for every other pair."""
    return ("vec" if aligned and tuple(x_strides) == tuple(dy_strides)
            and _dense(shape, x_strides) else "strided")


def relu_vec_grid(dtype: torch.dtype, n: int) -> int:
    """Blocks of either ReLU "vec" kernel for ``n`` elements: enough for
    each thread to take its ``RELU_VECS`` vectors once, at most
    ``RELU_BLOCKS`` (then the threads loop)."""
    per_block = RELU_THREADS * RELU_VECS * _elems(dtype)
    return max(1, min(-(-n // per_block), RELU_BLOCKS))


def relu_bwd(x: torch.Tensor, dy: torch.Tensor,
             negative_slope: float = 0.0) -> torch.Tensor:
    """``where(x > 0, dy, negative_slope * dy)`` in ``x``'s dtype and
    layout, any shape (up to 4 axes where x and dy differ in layout); x
    and dy are read by their own strides, on the route ``relu_bwd_plan``
    picks.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if not x.is_cuda:
        return relu_bwd_ref(x, dy, negative_slope)
    _build.guard_grad("relu_bwd", x, dy)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"relu_bwd: x {tuple(x.shape)} {x.dtype} and dy "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"relu_bwd: dtype {x.dtype} not supported")
    out = _dense_like(x, "relu_bwd")
    if out.numel() == 0:
        return out
    route = relu_bwd_plan(x.dtype, x.shape, x.stride(), dy.stride(),
                          _build.aligned16(x, dy, out, elems=1))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "vec":
        rc = _build.lib().repro_relu_bwd_vec(
            x.data_ptr(), dy.data_ptr(), out.data_ptr(), x.numel(),
            float(negative_slope), relu_vec_grid(x.dtype, x.numel()),
            DTYPES[x.dtype], stream)
    else:
        if x.dim() > 4:
            raise ValueError(f"relu_bwd: at most 4 axes where x and dy "
                             f"differ in layout, got {x.dim()}")
        pad = 4 - x.dim()
        shape = (1,) * pad + tuple(x.shape)
        strides = [(0,) * pad + t.stride() for t in (x, dy, out)]
        rc = _build.lib().repro_relu_bwd(
            x.data_ptr(), dy.data_ptr(), out.data_ptr(), x.numel(),
            *shape[1:], *strides[0], *strides[1], *strides[2],
            float(negative_slope), DTYPES[x.dtype], stream)
    _build.check(rc, "relu_bwd")
    relu_bwd.launches += 1
    relu_bwd.routes[route] += 1
    return out


relu_bwd.launches = 0
# launches per route, beside the total
relu_bwd.routes = dict.fromkeys(RELU_BWD_ROUTES, 0)
