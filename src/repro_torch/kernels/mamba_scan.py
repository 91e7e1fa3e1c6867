"""Mamba-2 SSD chunked scan — Hopper kernels.

Replaces ``repro/kernels/mamba_scan.py:ssd_scan_pallas``.  ``x``, ``dt``,
``B_`` and ``C`` are read in place by their strides: the model passes B
and C as column slices of the in_proj output, which are never copied.
Three routes (``csrc/ssd_scan.cu``), picked by ``ssd_plan`` from the
dtype, the shape, B's and C's row strides and the bases' alignment (never
by trying a kernel) and counted in ``ssd_scan.routes`` beside
``launches``:

* "step": S = 1, every decode call.  The f32 state streams once through
  registers: a group of lanes owns whole state rows, read and written as
  16-byte vectors, C.B and C.h summed by shuffles; no shared memory, no
  barrier.  ``ssd_step`` fixes the lanes a row, the rows a group holds at
  once and the warps a block.
* "split": S > 1 (chunked prefill, the whole-sequence forward).  The
  chunk algorithm with each head's P state rows split across blocks, the
  rows' state in registers from the first chunk to the last, the cumsum a
  warp scan, each chunk's intra-chunk matrix recomputed by every block of
  a head.  ``ssd_split`` fixes the rows a block from B * H * P and the
  chunk length.
* "block": the first port's kernel, one block per (row, head) with the
  state in shared memory, for B or C slices whose base or row stride
  breaks the 16-byte vectors and for an N the routes above do not take.

Bound by bytes at decode (a read and a write of the state); a long
chunk's O(L^2 N) products run as scalar f32 FMAs.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._build import DTYPES

MAX_CHUNK = 128
MAX_SMEM = 232448          # bytes of shared memory a Hopper block may use
_TT = 16                   # y rows per tile (csrc/ssd_scan.cu: kTT)

ROUTES = ("step", "split", "block")
# the (lanes a state row, 16-byte vectors a lane) pairs that
# csrc/ssd_scan.cu instantiates (REPRO_SSD_LANES): N = 4 * lanes * vectors
LANES = ((4, 1), (8, 1), (8, 2), (8, 4), (16, 1), (16, 2), (32, 1))
SSD_N = tuple(sorted({4 * g * v for g, v in LANES}))
# the step kernel (csrc/ssd_scan.cu:ssd_step_kernel): rows x vectors a
# lane holds at most (kStepMaxRows), threads a block at most (kMaxThreads,
# the split kernel's too); the lanes a row each N takes, the rows a lane
# group holds at once (their loads in flight), the warps a block, and the
# blocks the grid must reach where the shape allows (one an SM)
STEP_MAX_ROWS = 4
MAX_THREADS = 512
STEP_LANES = {16: (4, 1), 32: (8, 1), 64: (8, 2), 128: (32, 1)}
STEP_ROWS = 2
STEP_WARPS = 2
STEP_BLOCKS = 132
# the split kernel (ssd_split_kernel): y positions a tile folds (kTile),
# registers a thread (its launch bounds: two blocks of MAX_THREADS an
# SM); the lanes a row each N takes; a block's state rows are at least
# SPLIT_ROWS x the chunk length (every block of a head recomputes the
# chunk's L^2 N / 2 products of C B^T, the rows' own work is 2 L N a row),
# and the rows are halved, down to that floor, while the grid takes fewer
# than SPLIT_WAVES waves of the blocks the SMs hold at once.  Swept on the
# H100 (chip_smoke.py phase 3, "ssd_scan split sweep"): 16 rows a block
# of 16 lanes x 2 vectors at C = 16 (0.0437 ms against 0.0496 for 8 x 4),
# 32 rows at chunk 128 (0.4015 against 0.5176 for a whole head)
SPLIT_TILE = 16
SPLIT_REGS = 64
SPLIT_LANES = {16: (4, 1), 32: (8, 1), 64: (8, 2), 128: (16, 2)}
SPLIT_ROWS = 1.0
SPLIT_WAVES = 4
# an H100 SM: blocks, threads, 32-bit registers and bytes of shared memory
# it holds at once (1 KB the system keeps per block included)
SMS, SM_BLOCKS, SM_THREADS, SM_SMEM = 132, 32, 2048, 228 * 1024
SM_REGS = 65536


class Step(NamedTuple):
    """A "step" launch: ``lanes`` a state row, ``vecs`` 16-byte vectors a
    lane, ``rows`` a lane group holds at once, ``warps`` a block, and the
    grid's ``blocks``."""
    lanes: int
    vecs: int
    rows: int
    warps: int
    blocks: int


class Split(NamedTuple):
    """A "split" launch: ``lanes`` a state row, ``vecs`` 16-byte vectors
    a lane, ``rows`` state rows a block (one lane group each), ``slices``
    blocks a head, ``threads`` a block, its dynamic shared memory
    ``smem`` and the grid's ``blocks``."""
    lanes: int
    vecs: int
    rows: int
    slices: int
    threads: int
    smem: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(p: int, n: int, chunk: int) -> int:
    """Dynamic shared memory of one block (``csrc/ssd_scan.cu``'s
    ``smem_floats``)."""
    tt = min(chunk, _TT)
    return 4 * (p * (n + 1) + chunk * (n + 1) + chunk * p + 2 * tt * n
                + tt * chunk + 3 * chunk)


def split_smem(n: int, chunk: int, rows: int, lanes: int) -> int:
    """Dynamic shared memory of one "split" block (``csrc/ssd_scan.cu``'s
    ``split_floats``; the kernel declares no static shared memory): B of
    the chunk in rows padded by a vector, a tile's C rows and intra-chunk
    matrix, the block's x rows padded by ``lanes``, and four (L,)
    vectors."""
    tt = min(chunk, SPLIT_TILE)
    return 4 * (chunk * (n + 4) + tt * n + tt * (chunk + 1)
                + rows * (chunk + lanes) + 4 * chunk)


def ssd_plan(dtype: torch.dtype, shape: Sequence[int],
             strides: Sequence[int], n: int, aligned: bool) -> str:
    """The route for x of ``shape`` (B, S, H, P) and state width ``n``:
    B's and C's row ``strides`` (b_sb, b_ss, c_sb, c_ss) must be whole
    16-byte vectors of ``dtype`` (the sequence stride only where S > 1),
    and ``aligned`` says the bases of B, C and the f32 states are on 16
    bytes; then "step" at S = 1 (fewer than 2^31 state rows) and "split"
    above, for an N of ``SSD_N`` whose split block fits the shared memory
    at the longest chunk.
    Everything else takes "block"."""
    _, s, _, _ = shape
    b_sb, b_ss, c_sb, c_ss = strides
    ve = 16 // dtype.itemsize
    rows_ok = b_sb % ve == 0 and c_sb % ve == 0 and (
        s == 1 or (b_ss % ve == 0 and c_ss % ve == 0))
    if not (aligned and rows_ok and n in SSD_N):
        return "block"
    if s == 1:
        b, _, h, p = shape
        return "step" if b * h * p < 2 ** 31 else "block"
    g, _ = SPLIT_LANES[n]
    fits = split_smem(n, MAX_CHUNK, 32 // g, g) <= MAX_SMEM
    return "split" if fits else "block"


def ssd_step(shape: Sequence[int], n: int) -> Step:
    """The "step" grid for x of ``shape`` (B, 1, H, P) and state width
    ``n``: ``STEP_LANES[n]``, ``STEP_ROWS`` rows a group at once (no more
    than ``STEP_MAX_ROWS`` vectors a lane) and ``STEP_WARPS`` a block;
    while the grid has fewer than ``STEP_BLOCKS`` blocks the rows, then
    the warps, are halved."""
    b, _, h, p = shape
    g, v = STEP_LANES[n]
    rows_total, rg = b * h * p, 32 // g
    k, w = max(1, min(STEP_ROWS, STEP_MAX_ROWS // v)), STEP_WARPS

    def blocks(k, w):
        return _cdiv(rows_total, w * rg * k)

    while blocks(k, w) < STEP_BLOCKS and k > 1:
        k //= 2
    while blocks(k, w) < STEP_BLOCKS and w > 1:
        w //= 2
    return Step(g, v, k, w, blocks(k, w))


def ssd_split(shape: Sequence[int], n: int, chunk: int) -> Split:
    """The "split" grid for x of ``shape`` (B, S, H, P), state width ``n``
    and ``chunk`` (clamped to S): ``SPLIT_LANES[n]``; a block first takes
    a whole head's P rows (rounded up to a warp's groups, at most
    ``MAX_THREADS`` threads), then halves them while the grid has fewer
    than ``SPLIT_WAVES`` waves of the blocks the SMs hold at once and the
    half stays at least ``SPLIT_ROWS`` x the chunk (and one warp), or
    while the block's shared memory passes ``MAX_SMEM``.  Memoized on the
    shape and the knobs (a prefill step asks for the same grid per
    layer)."""
    b, s, h, p = shape
    return _split_grid(b, h, p, n, min(chunk, s), SPLIT_LANES[n],
                       SPLIT_ROWS, SPLIT_WAVES, MAX_SMEM)


@functools.lru_cache(maxsize=256)
def _split_grid(b, h, p, n, L, lanes, rows_per_chunk, waves, max_smem):
    g, v = lanes
    rg = 32 // g
    rows = min(_cdiv(p, rg) * rg, MAX_THREADS // 32 * rg)
    floor = max(rg, _cdiv(math.ceil(rows_per_chunk * L), rg) * rg)

    def blocks(rows):
        return b * h * _cdiv(p, rows)

    def wave(rows):
        threads = 32 * rows // rg
        return SMS * min(SM_BLOCKS, SM_THREADS // threads,
                         SM_REGS // (SPLIT_REGS * threads),
                         SM_SMEM // (split_smem(n, L, rows, g) + 1024))

    while rows > rg and (split_smem(n, L, rows, g) > max_smem or (
            blocks(rows) < waves * wave(rows)
            and _cdiv(rows // 2, rg) * rg >= floor)):
        rows = _cdiv(rows // 2, rg) * rg
    return Split(g, v, rows, _cdiv(p, rows), 32 * rows // rg,
                 split_smem(n, L, rows, g), blocks(rows))


def _aligned(*tensors: Optional[torch.Tensor]) -> bool:
    """The bases of B, C and the states on 16 bytes (their row strides are
    ``ssd_plan``'s to check)."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


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
    A = A.contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    hf = (torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
          if final_state is None else final_state)
    h0 = None if initial_state is None else initial_state.data_ptr()
    route = ssd_plan(x.dtype, x.shape, (B_.stride(0), B_.stride(1),
                                        C.stride(0), C.stride(1)), n,
                     _aligned(B_, C, initial_state, hf))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.lib()
    if route == "step":
        g = ssd_step(x.shape, n)
        rc = lib.repro_ssd_scan_step(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C.data_ptr(), h0, y.data_ptr(), hf.data_ptr(), b, h, p, n,
            x.stride(0), x.stride(2), dt.stride(0), dt.stride(2),
            B_.stride(0), C.stride(0), y.stride(0), y.stride(2),
            g.lanes, g.vecs, g.rows, g.warps, DTYPES[x.dtype], stream)
    else:
        args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
                C.data_ptr(), h0, y.data_ptr(), hf.data_ptr(), b, s, h, p,
                n, chunk, x.stride(0), x.stride(1), x.stride(2),
                dt.stride(0), dt.stride(1), dt.stride(2),
                B_.stride(0), B_.stride(1), C.stride(0), C.stride(1),
                y.stride(0), y.stride(1), y.stride(2))
        if route == "split":
            g = ssd_split(x.shape, n, chunk)
            rc = lib.repro_ssd_scan_split(*args, g.lanes, g.vecs, g.rows,
                                          DTYPES[x.dtype], stream)
        else:
            if smem_bytes(p, n, chunk) > MAX_SMEM:
                raise ValueError(f"ssd_scan: P {p}, N {n}, chunk {chunk} "
                                 f"need {smem_bytes(p, n, chunk)} bytes of "
                                 "shared memory on the block route")
            rc = lib.repro_ssd_scan(*args, DTYPES[x.dtype], stream)
    _build.check(rc, "ssd_scan")
    ssd_scan.launches += 1
    ssd_scan.routes[route] += 1
    return y, hf


ssd_scan.launches = 0
# launches per route, beside the total
ssd_scan.routes = dict.fromkeys(ROUTES, 0)
