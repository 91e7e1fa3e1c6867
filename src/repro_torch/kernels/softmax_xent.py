"""Row softmax, fused softmax + cross-entropy and its backward — the
Hopper kernels of Caffe's Softmax and SoftmaxWithLoss.

Replace ``repro/kernels/softmax_xent.py:softmax_pallas``,
``softmax_xent_pallas`` and ``softmax_xent_bwd_pallas``.  The first
kernel template (``csrc/softmax_xent.cu``): one warp per row, max and sum
of exponentials in f32; softmax writes ``e / sum(e)``, softmax_xent
``exp(logp)`` and each row's NLL in f32, whose mean over all B rows is
taken after it (JAX takes it outside its kernel too:
``softmax_xent.py:107``; the "rows" route below fuses it).  A label
outside [0, V) gives its
row an NLL of 0, the rule of JAX's Pallas kernel (its one-hot never
matches such a label; JAX's oracle wraps -1 to the last class instead),
and the mean still divides by B.  The backward writes ``(p - onehot) /
B`` from the saved probs, rounded to their dtype, times the loss's
cotangent ``g`` where the caller gives one (``XentFn``: read from device
memory and rounded to the probs' dtype, as torch's multiply by a 0-d f32
tensor rounds it on the card, the product rounded again: bit for bit the
kernel-then-``* g`` composition, in one launch); such a row's one-hot is
empty, so it gets ``p / B``.

softmax has two routes, picked by ``softmax_plan`` from the layout and
alignment (never by trying a kernel) and counted in ``softmax.routes``
beside ``launches``:

* "rows": rows of unit stride on a 16-byte aligned base.  Each row is
  read once into registers by a sub-warp, a warp or several warps
  (``softmax_rows``), as 16-byte vectors where the row stride and V are
  whole vectors, else element by element; exp once per element, max and
  sum by shuffle trees, ``e / sum(e)`` stored from the registers.
* "strided": the kernel above (rows of any stride, the transposed
  crossing's column-major blob; a base off 16 bytes).

softmax_xent has the same two routes, picked by ``softmax_xent_plan``
(the same rule) and counted in ``softmax_xent.routes``:

* "rows": the register-row kernel with the loss fused in
  (``softmax_xent_rows``): ``logp = (x - max) - lse`` once per element,
  ``exp(logp)`` stored from the registers, the label's lane giving the
  row's NLL to shared memory, and the block's NLLs summed in a fixed
  order (no atomics, no (B,) NLL tensor).  Where the whole batch fits one
  block (LeNet's 64 x 10) that block writes the mean: one launch.  Past
  one block each block writes a partial and a one-block second kernel
  sums them in block order and divides by B: two launches.
* "strided": the first kernel, then the mean of its (B,) NLLs
  (``nll.mean()``, a second launch).

softmax_xent_bwd has the same two routes, picked by
``softmax_xent_bwd_plan`` (the same rule) and counted in
``softmax_xent_bwd.routes``, each one launch with ``g`` folded in:

* "rows": the forward's register rows without the reductions
  (``softmax_xent_bwd_rows``: LeNet's 64 x 10 in one block, 8 lanes of 2
  elements a row), every item loaded before the first store.
* "strided": the first port's kernel, one warp a row, p read by its
  strides (a column-major probs, a base off 16 bytes, an empty batch).

Labels are read as int64; labels that are int64 already and contiguous
(LeNet's: ``data/synthetic.py``) are passed as they are, with no copy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPES
from repro_torch.kernels.ref import softmax as softmax_ref
from repro_torch.kernels.ref import softmax_xent as softmax_xent_ref
from repro_torch.kernels.ref import softmax_xent_bwd as softmax_xent_bwd_ref


def _rows(name: str, x: torch.Tensor, labels=None):
    """Launch the row kernel on a (rows, V) matrix read by its strides;
    returns (probs, nll or None)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    rows, v = x.shape
    probs = torch.empty((rows, v), dtype=x.dtype, device=x.device)
    nll = None
    if labels is not None:
        nll = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if probs.numel() == 0:
        return probs, nll
    rc = _build.lib().repro_softmax_rows(
        x.data_ptr(), None if labels is None else labels.data_ptr(),
        probs.data_ptr(), None if nll is None else nll.data_ptr(), rows, v,
        x.stride(0), x.stride(1), DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, name)
    return probs, nll


ROUTES = ("rows", "strided")
# the "rows" kernel (csrc/softmax_xent.cu:softmax_reg_kernel): the items a
# lane it is instantiated for (kPer) and a block's most threads
# (kRowsMaxThreads); the items (16-byte vectors, or elements) a lane aims
# at, the threads a block aims at, and the blocks the grid must reach
# where the rows allow (one an SM).  Swept on the H100 (chip_smoke.py
# phase 3, "softmax rows sweep"): one item a lane is first or tied at 64 x
# 10 and 256 x 1000 in f32 and bf16 (bf16 256 x 1000: 0.0070 ms against
# 0.0077 at two)
ROWS_PER = (1, 2, 4, 8)
ROWS_MAX_THREADS = 512
SOFTMAX_ITEMS = 1
SOFTMAX_THREADS = 128
SOFTMAX_BLOCKS = 132
# softmax_xent's "rows" grid (softmax_xent_rows): softmax's, packed into
# one block for the whole batch where a lane then holds at most XENT_PACK
# items (LeNet's 64 x 10: 8 lanes a row, 2 elements a lane); the second
# pass's threads (csrc/softmax_xent.cu:kXentSumThreads).  Swept on the
# H100 (chip_smoke.py phase 3, "softmax_xent rows sweep"): at 64 x 10
# every one-block plan tied (0.0064-0.0066 ms), the 32-block plan and its
# second launch took 0.0086
XENT_PACK = 2
XENT_SUM_THREADS = 256


class Rows(NamedTuple):
    """A "rows" launch: ``tpr`` threads a row, ``rows`` a block, ``per``
    items a lane, 16-byte items (``vec``) or single elements, the block's
    ``threads`` and the grid's ``blocks``."""
    tpr: int
    rows: int
    per: int
    vec: bool
    threads: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _items(dtype: torch.dtype, shape: Sequence[int],
           strides: Sequence[int], aligned: bool) -> Tuple[int, bool]:
    """A row's items and whether they are 16-byte vectors: the base on 16
    bytes (``aligned``), the row stride (where there are several rows) and
    V whole vectors."""
    rows, v = shape
    ve = 16 // dtype.itemsize
    vec = aligned and v % ve == 0 and (rows == 1 or strides[0] % ve == 0)
    return (v // ve if vec else v), vec


def softmax_plan(dtype: torch.dtype, shape: Sequence[int],
                 strides: Sequence[int], aligned: bool) -> str:
    """The route of a (rows, V) matrix: "rows" where its rows have unit
    stride (or one element), its base is on 16 bytes (``aligned``) and a
    row's items fit ``ROWS_PER[-1]`` a lane of ``ROWS_MAX_THREADS``;
    "strided" for every other layout (a column-major blob) and base."""
    rows, v = shape
    unit = strides[1] == 1 or v == 1
    items, _ = _items(dtype, shape, strides, aligned)
    fits = items <= ROWS_PER[-1] * ROWS_MAX_THREADS
    return "rows" if unit and aligned and fits and rows < 2 ** 31 \
        else "strided"


def softmax_rows(dtype: torch.dtype, shape: Sequence[int],
                 strides: Sequence[int], aligned: bool) -> Rows:
    """The "rows" grid: the threads a row are the power of two that gives
    a lane at most ``SOFTMAX_ITEMS`` items (at most
    ``ROWS_MAX_THREADS``; whole warps past 32), a lane's items the least
    of ``ROWS_PER`` that holds the rest; a block takes ``SOFTMAX_THREADS``
    threads' worth of rows (at least a warp's), halved while the grid has
    fewer than ``SOFTMAX_BLOCKS`` blocks (down to a warp)."""
    rows, _ = shape
    items, vec = _items(dtype, shape, strides, aligned)
    tpr = 1
    while tpr < ROWS_MAX_THREADS and tpr * SOFTMAX_ITEMS < items:
        tpr *= 2
    per = next(p for p in ROWS_PER if p * tpr >= items)
    least = max(1, 32 // tpr)
    rpb = max(least, SOFTMAX_THREADS // tpr)
    while _cdiv(rows, rpb) < SOFTMAX_BLOCKS and rpb > least:
        rpb //= 2
    return Rows(tpr, rpb, per, vec, tpr * rpb, _cdiv(rows, rpb))


def softmax_xent_plan(dtype: torch.dtype, shape: Sequence[int],
                      strides: Sequence[int], aligned: bool) -> str:
    """softmax_xent's route: ``softmax_plan``'s rule ("rows" for rows of
    unit stride on a 16-byte aligned base that the registers hold), and
    "strided" for an empty batch or row, whose mean the plain ``.mean()``
    takes."""
    rows, v = shape
    if rows < 1 or v < 1:
        return "strided"
    return softmax_plan(dtype, shape, strides, aligned)


def softmax_xent_rows(dtype: torch.dtype, shape: Sequence[int],
                      strides: Sequence[int], aligned: bool) -> Rows:
    """softmax_xent's "rows" grid.  One block for the whole batch where it
    fits: from ``softmax_rows``' threads a row, halved while the batch
    passes ``ROWS_MAX_THREADS`` threads and a lane would hold at most
    ``XENT_PACK`` items; if the batch then fits, one block of it (rows
    rounded up to whole warps), whose kernel writes the mean: one launch.
    Else ``softmax_rows``' grid, each block a partial, summed by a second
    launch."""
    rows, _ = shape
    items, _ = _items(dtype, shape, strides, aligned)
    g = softmax_rows(dtype, shape, strides, aligned)
    tpr = g.tpr
    while rows * tpr > ROWS_MAX_THREADS and tpr > 1 \
            and _cdiv(items, tpr // 2) <= XENT_PACK:
        tpr //= 2
    if rows * tpr > ROWS_MAX_THREADS:
        return g
    per = next(p for p in ROWS_PER if p * tpr >= items)
    threads = _cdiv(rows * tpr, 32) * 32
    return Rows(tpr, threads // tpr, per, g.vec, threads, 1)


def softmax_xent_bwd_plan(dtype: torch.dtype, shape: Sequence[int],
                          strides: Sequence[int], aligned: bool) -> str:
    """softmax_xent_bwd's route, from the probs' shape, strides and
    alignment: ``softmax_xent_plan``'s rule ("rows" for rows of unit stride
    on a 16-byte aligned base that the registers hold; "strided" for other
    layouts, bases and an empty batch or row)."""
    return softmax_xent_plan(dtype, shape, strides, aligned)


def softmax_xent_bwd_rows(dtype: torch.dtype, shape: Sequence[int],
                          strides: Sequence[int], aligned: bool) -> Rows:
    """softmax_xent_bwd's "rows" grid: the forward's
    (``softmax_xent_rows``), so that LeNet's whole batch is one block; past
    one block the kernel needs no second pass, as it writes no sum."""
    return softmax_xent_rows(dtype, shape, strides, aligned)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, any leading rank, f32 inside, in
    ``x.dtype``, on the route ``softmax_plan`` picks.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if not x.is_cuda:
        return softmax_ref(x)
    _build.guard_grad("softmax", x)
    if x.dim() == 0:
        raise ValueError("softmax: needs at least one axis")
    x2 = x if x.dim() == 2 else x.reshape(-1, x.shape[-1])
    if x2.dtype not in DTYPES:
        raise TypeError(f"softmax: dtype {x2.dtype} not supported")
    aligned = x2.data_ptr() % 16 == 0
    route = softmax_plan(x2.dtype, x2.shape, x2.stride(), aligned)
    if route == "rows":
        rows, v = x2.shape
        probs = torch.empty((rows, v), dtype=x2.dtype, device=x2.device)
        if probs.numel():
            g = softmax_rows(x2.dtype, x2.shape, x2.stride(), aligned)
            rc = _build.lib().repro_softmax_reg(
                x2.data_ptr(), probs.data_ptr(), rows, v, x2.stride(0),
                g.tpr, g.rows, g.per, int(g.vec), DTYPES[x2.dtype],
                torch.cuda.current_stream(x2.device).cuda_stream)
            _build.check(rc, "softmax")
    else:
        probs, _ = _rows("softmax", x2)
    softmax.launches += 1
    softmax.routes[route] += 1
    return probs.reshape(x.shape)


def _check_labels(name: str, x: torch.Tensor, labels: torch.Tensor):
    if x.dim() != 2 or labels.shape != (x.shape[0],):
        raise ValueError(f"{name}: shapes {tuple(x.shape)}, "
                         f"{tuple(labels.shape)}")
    if labels.dtype.is_floating_point or labels.dtype.is_complex \
            or labels.device != x.device:
        raise TypeError(f"{name}: labels must be integers on {x.device}, "
                        f"got {labels.dtype} on {labels.device}")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,V) logits, (B,) int labels -> (mean NLL f32 scalar, probs in the
    logits' dtype).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if not logits.is_cuda:
        return softmax_xent_ref(logits, labels)
    _build.guard_grad("softmax_xent", logits)
    _check_labels("softmax_xent", logits, labels)
    if logits.dtype not in DTYPES:
        raise TypeError(f"softmax_xent: dtype {logits.dtype} not supported")
    lab = labels.to(torch.int64).contiguous()
    aligned = logits.data_ptr() % 16 == 0
    route = softmax_xent_plan(logits.dtype, logits.shape, logits.stride(),
                              aligned)
    if route == "rows":
        rows, v = logits.shape
        g = softmax_xent_rows(logits.dtype, logits.shape, logits.stride(),
                              aligned)
        probs = torch.empty((rows, v), dtype=logits.dtype,
                            device=logits.device)
        loss = torch.empty((), dtype=torch.float32, device=logits.device)
        part = None if g.blocks == 1 else torch.empty(
            (g.blocks,), dtype=torch.float32, device=logits.device)
        rc = _build.lib().repro_softmax_xent_reg(
            logits.data_ptr(), lab.data_ptr(), probs.data_ptr(),
            None if part is None else part.data_ptr(), loss.data_ptr(),
            rows, v, logits.stride(0), g.tpr, g.rows, g.per, int(g.vec),
            DTYPES[logits.dtype],
            torch.cuda.current_stream(logits.device).cuda_stream)
        _build.check(rc, "softmax_xent")
    else:
        probs, nll = _rows("softmax_xent", logits, lab)
        loss = nll.mean()
    softmax_xent.launches += 1
    softmax_xent.routes[route] += 1
    return loss, probs


def softmax_xent_bwd(probs: torch.Tensor, labels: torch.Tensor,
                     g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,V) probs, (B,) int labels -> ``(probs - onehot) / B`` in the
    probs' dtype, contiguous, times ``g`` (the loss's f32 scalar cotangent,
    on the probs' device) where given: ``softmax_xent_bwd(p, y, g)`` is
    ``softmax_xent_bwd(p, y) * g`` bit for bit, in one launch.  CPU tensors
    take the plain version; CUDA tensors launch the kernel on the route
    ``softmax_xent_bwd_plan`` picks, or raise."""
    if not probs.is_cuda:
        out = softmax_xent_bwd_ref(probs, labels)
        return out if g is None else out * g
    _build.guard_grad("softmax_xent_bwd", probs)
    _check_labels("softmax_xent_bwd", probs, labels)
    if probs.dtype not in DTYPES:
        raise TypeError(f"softmax_xent_bwd: dtype {probs.dtype} not "
                        "supported")
    if g is not None and (g.dtype != torch.float32 or g.numel() != 1
                          or g.device != probs.device):
        raise TypeError("softmax_xent_bwd: g must be one f32 element on "
                        f"{probs.device}, got {g.dtype} {tuple(g.shape)} on "
                        f"{g.device}")
    rows, v = probs.shape
    out = torch.empty((rows, v), dtype=probs.dtype, device=probs.device)
    if out.numel() == 0:
        return out
    lab = labels.to(torch.int64).contiguous()
    gp = None if g is None else g.data_ptr()
    stream = torch.cuda.current_stream(probs.device).cuda_stream
    aligned = probs.data_ptr() % 16 == 0
    route = softmax_xent_bwd_plan(probs.dtype, probs.shape, probs.stride(),
                                  aligned)
    if route == "rows":
        grid = softmax_xent_bwd_rows(probs.dtype, probs.shape,
                                     probs.stride(), aligned)
        rc = _build.lib().repro_softmax_xent_bwd_reg(
            probs.data_ptr(), lab.data_ptr(), gp, out.data_ptr(), rows, v,
            probs.stride(0), grid.tpr, grid.rows, grid.per, int(grid.vec),
            1.0 / rows, DTYPES[probs.dtype], stream)
    else:
        rc = _build.lib().repro_softmax_xent_bwd(
            probs.data_ptr(), lab.data_ptr(), gp, out.data_ptr(), rows, v,
            probs.stride(0), probs.stride(1), 1.0 / rows,
            DTYPES[probs.dtype], stream)
    _build.check(rc, "softmax_xent_bwd")
    softmax_xent_bwd.launches += 1
    softmax_xent_bwd.routes[route] += 1
    return out


softmax.launches = 0
# launches per route, beside the total
softmax.routes = dict.fromkeys(ROUTES, 0)
softmax_xent.launches = 0
softmax_xent.routes = dict.fromkeys(ROUTES, 0)
softmax_xent_bwd.launches = 0
softmax_xent_bwd.routes = dict.fromkeys(ROUTES, 0)
