"""The bias over rows' routes on the CPU, and a plain emulation of what
its vector kernel computes, against the JAX package.

``kernels/eltwise.py`` picks the route in pure Python, and the card's
kernels follow it: ``bias_plan`` (N whole 16-byte vectors on 16-byte
aligned bases and a row stride of whole vectors -> the "vec" kernel of
``csrc/eltwise.cu``; every other N or alignment -> the first port's
"scalar" kernel) and ``bias_grid`` (the vec kernel's rows a thread, block
and grid, from M and N).  Held here: the routes at every path width in
both dtypes (qwen2.5-3b's q, k and v biases, LeNet's inner products) and
at the edges; a walk of the grid that reaches every (row, 16-byte
vector) exactly once, at the planner's grids and at swept ones; the C
signatures of both launchers against their ctypes ones; and an emulation
of that walk, each vector of m added to the thread's bias vector in f32 and
rounded to the storage dtype, bit-exact against the plain version and
against ``bias_add_rows_pallas`` in interpret mode on the same numpy
inputs, in bf16 and f32 (``chip_smoke.py``'s phase-3 ``TOL`` is 0).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clear_tuning  # noqa: E402
from repro.kernels.eltwise import bias_add_rows_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import eltwise as EW  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


def _elems(dtype):
    return 16 // torch.tensor([], dtype=dtype).element_size()


def _route(m, v):
    """The route the wrapper picks for m (M, N) and v (N,)."""
    out = torch.empty(m.shape, dtype=m.dtype)
    return EW.bias_plan(m.dtype, m.shape[1], _build.aligned16(
        m, v, out, elems=_elems(m.dtype)))


# qwen2.5-3b's 2048 and 256 and LeNet's 500 and 64 on vec in both dtypes
# (500 bf16 is not whole vectors); LeNet's 10, a ragged 2050 on scalar
@pytest.mark.parametrize("dtype,n,route", [
    (BF16, 2048, "vec"), (BF16, 256, "vec"), (F32, 2048, "vec"),
    (F32, 256, "vec"), (F32, 500, "vec"), (F32, 64, "vec"),
    (BF16, 64, "vec"), (BF16, 151936, "vec"), (F32, 10, "scalar"),
    (BF16, 10, "scalar"), (BF16, 500, "scalar"), (BF16, 2050, "scalar"),
    (F32, 2050, "scalar"), (F32, 2, "scalar")])
def test_bias_plan(dtype, n, route):
    m, v = torch.zeros((4, n), dtype=dtype), torch.zeros(n, dtype=dtype)
    assert _route(m, v) == route
    assert EW.bias_plan(dtype, n, False) == "scalar"


def test_bias_route_of_views():
    """A row stride past N of whole vectors keeps vec; an odd row stride
    or a base offset by one element does not, nor a bias vector offset by
    one."""
    v = torch.zeros(2048, dtype=BF16)
    assert _route(torch.zeros((4, 2064), dtype=BF16)[:, :2048], v) == "vec"
    assert _route(torch.zeros((4, 2052), dtype=BF16)[:, :2048],
                  v) == "scalar"
    assert _route(torch.zeros(4 * 2048 + 1, dtype=BF16)[1:].view(4, 2048),
                  v) == "scalar"
    assert _route(torch.zeros((4, 2048), dtype=BF16),
                  torch.zeros(2049, dtype=BF16)[1:]) == "scalar"
    assert _route(torch.zeros((4, 2052), dtype=F32)[:, :2048],
                  v.float()) == "vec"


def _walk(dtype, m, n, grid):
    """For each (row, 16-byte vector) of out, the threads that store it
    (``csrc/eltwise.cu:bias_add_rows_vec_kernel``): thread (tx, ty) of
    the block at (column block i, row block k) owns vector i * bx + tx (if
    below N's) and rows (k * by + ty) * rows + u, u < rows, below M."""
    rpt, bx, by, gx, gy = grid
    nvec = n // _elems(dtype)
    seen = np.zeros((m, nvec), np.int64)
    for i in range(gx):
        j = i * bx + np.arange(bx)
        j = j[j < nvec]
        for k in range(gy):
            for ty in range(by):
                for u in range(rpt):
                    r = (k * by + ty) * rpt + u
                    if r < m:
                        seen[r, j] += 1
    return seen


# (dtype, M, N): qwen's decode, prefill and train rows of 2048 and 256,
# LeNet's batch of 64 at 500 and 64, the vocabulary's width (gx > 1), odd
# row counts
PATH = [(BF16, 4, 2048), (BF16, 4, 256), (BF16, 64, 2048), (BF16, 64, 256),
        (BF16, 512, 2048), (BF16, 512, 256), (F32, 64, 500), (F32, 64, 64),
        (BF16, 4, 151936), (F32, 77, 12), (BF16, 1, 8), (F32, 1000, 2048)]


@pytest.mark.parametrize("dtype,m,n", PATH)
def test_grid_reaches_every_vector_once(dtype, m, n):
    grid = EW.bias_grid(dtype, m, n)
    rpt, bx, by, gx, gy = grid
    assert rpt in (1, 2, 4, 8) and bx * by <= EW.BIAS_THREADS
    assert gx * bx >= n // _elems(dtype) > (gx - 1) * bx
    assert gy * by * rpt >= m > (gy - 1) * by * rpt   # no empty row block
    assert (_walk(dtype, m, n, grid) == 1).all()


# the kernel's other instances (rows a thread 1, 2, 8) and smaller blocks,
# as the sweep of chip_smoke.py's phase 3 sets them
@pytest.mark.parametrize("rows,threads", [(1, 256), (2, 64), (8, 128),
                                          (8, 64)])
def test_swept_grids_reach_every_vector_once(monkeypatch, rows, threads):
    monkeypatch.setattr(EW, "BIAS_ROWS", rows)
    monkeypatch.setattr(EW, "BIAS_THREADS", threads)
    monkeypatch.setattr(EW, "BIAS_BLOCKS", 1)
    for dtype, m, n in ((BF16, 515, 2048), (F32, 64, 500), (BF16, 9, 256)):
        grid = EW.bias_grid(dtype, m, n)
        assert grid[0] == rows and grid[1] * grid[2] == threads
        assert (_walk(dtype, m, n, grid) == 1).all()


def test_grid_at_the_path_shapes():
    # (rows a thread, bx, by, gx, gy): a decode or prefill bias one row a
    # thread and a block a row; a train step's 512 rows of 2048 two rows a
    # thread, of 256 two rows a block
    assert EW.bias_grid(BF16, 4, 2048) == (1, 256, 1, 1, 4)
    assert EW.bias_grid(BF16, 4, 256) == (1, 32, 1, 1, 4)
    assert EW.bias_grid(BF16, 64, 256) == (1, 32, 1, 1, 64)
    assert EW.bias_grid(BF16, 512, 2048) == (2, 256, 1, 1, 256)
    assert EW.bias_grid(BF16, 512, 256) == (1, 32, 2, 1, 256)
    assert EW.bias_grid(F32, 64, 500) == (1, 128, 1, 1, 64)
    # enough blocks already: neither rows a thread nor by is cut
    assert EW.bias_grid(BF16, 8192, 2048) == (4, 256, 1, 1, 2048)


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


@pytest.mark.parametrize("name", ["repro_bias_add_rows",
                                  "repro_bias_add_rows_vec"])
def test_launchers_match_their_ctypes_signatures(name):
    src = (_build.CSRC / "eltwise.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = []
    for p in params.split(","):
        p = " ".join(p.split())
        kinds.append(_CTYPES["void*" if "*" in p else
                             " ".join(p.split()[:-1])])
    assert kinds == _build._SIGNATURES[name]


def _vec_emulation(m, v, grid):
    """The vec kernel's walk: each thread's bias vector, then each of its
    rows' vector of m added to it in f32, rounded to the storage dtype and
    stored into out (every (row, vector) once, as the walk test holds)."""
    rpt, bx, by, gx, gy = grid
    rows, n = m.shape
    e = _elems(m.dtype)
    nvec = n // e
    mv = m.float().reshape(rows, nvec, e)
    vv = v.float().reshape(nvec, e)
    out = torch.full((rows, nvec, e), float("nan"), dtype=m.dtype)
    for i in range(gx):
        j = i * bx + torch.arange(bx)
        j = j[j < nvec]
        b = vv[j]                       # loaded once, before the rows
        for t in range(-(-rows // rpt)):   # the row tiles, each once
            r = torch.arange(t * rpt, min(rows, (t + 1) * rpt))
            out[r[:, None], j[None, :]] = (mv[r[:, None], j[None, :]]
                                           + b).to(m.dtype)
    return out.reshape(rows, n)


# (dtype, M, N, row pad): qwen's widths in both dtypes, LeNet's f32 500
# and 64, a row stride past N, odd row counts
CASES = [(BF16, 4, 2048, 0), (BF16, 64, 256, 8), (BF16, 33, 64, 0),
         (F32, 64, 500, 0), (F32, 64, 64, 4), (F32, 9, 2048, 0)]


@pytest.mark.parametrize("dtype,rows,n,pad", CASES)
def test_vec_emulation_is_exact_against_jax(dtype, rows, n, pad):
    clear_tuning()
    rng = np.random.default_rng(rows * 7 + n + pad)
    mw = torch.from_numpy(rng.standard_normal((rows, n + pad)).astype(
        np.float32)).to(dtype)
    m = mw[:, :n]
    # a bias of every scale, from far below m's to far above it
    v = torch.from_numpy((rng.standard_normal(n) * 10.0 ** rng.integers(
        -4, 4, n)).astype(np.float32)).to(dtype)
    assert _route(m, v) == "vec"
    got = _vec_emulation(m, v, EW.bias_grid(dtype, rows, n))
    assert got.dtype == dtype and not got.isnan().any()
    assert torch.equal(got, ref.bias_add_rows(m, v))
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    want = bias_add_rows_pallas(
        jnp.asarray(m.float().numpy()).astype(jdt),
        jnp.asarray(v.float().numpy()).astype(jdt), interpret=True)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def test_cpu_tensors_take_the_plain_version():
    m, v = torch.randn(7, 64), torch.randn(64)
    before = dict(EW.bias_add_rows.routes), EW.bias_add_rows.launches
    assert torch.equal(EW.bias_add_rows(m, v), ref.bias_add_rows(m, v))
    assert (dict(EW.bias_add_rows.routes),
            EW.bias_add_rows.launches) == before
