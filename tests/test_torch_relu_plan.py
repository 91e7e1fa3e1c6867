"""The ReLU's and its backward's routes on the CPU, and a plain emulation
of what their vector kernels compute, against the JAX package.

``kernels/eltwise.py`` picks the route in pure Python, and the card's
kernels follow it: ``relu_bwd_plan`` (x and dy with identical strides over
one dense layout and 16-byte aligned bases -> the "vec" kernel of
``csrc/eltwise.cu``; mixed layouts or an unaligned operand -> the
"strided" kernel) and ``relu_vec_grid`` (the vec kernel's blocks, from
the element count; its vectors a thread are the kernel's compile-time
``kVecs``, ``RELU_VECS``).  Held here: the routes as the
wrapper hands them to the planner (row-major, both column-major, the
transposed boundary mode's column-major x and row-major dy, an operand
offset by one element); a walk of the vec kernel's blocks, threads and
vectors that reaches every 16-byte vector once and the tail's elements
once; the C signatures of both launchers against their ctypes ones; and
an emulation of that walk, the kernel's arithmetic on each element (dx =
dy where x > 0, else the slope rounded to the storage dtype times dy in
f32, rounded to the storage dtype, a NaN in x taking the slope), exact
against the plain version and against ``relu_bwd_pallas`` in interpret
mode on the same numpy inputs, odd lengths and a slope that bf16 cannot
hold included.  The forward likewise: ``relu_plan`` (x of a dense layout
with 16-byte aligned bases of x and out -> the forward's "vec" kernel,
the backward's walk with x in place of dy; a view offset by one element
-> the "scalar" kernel), whose blocks are ``relu_vec_grid``'s too; its
routes (row-major, column-major, offset by one element), both launchers'
signatures, and the emulation exact against ``ref.relu`` and
``relu_pallas`` in interpret mode, odd lengths, NaNs and a slope bf16
cannot hold included.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clear_tuning  # noqa: E402
from repro.kernels.eltwise import relu_bwd_pallas, relu_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import eltwise as EW  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


def _route(x, dy):
    """The route the wrapper picks for x and dy (dx in x's layout)."""
    out = torch.empty_like(x)
    return EW.relu_bwd_plan(x.dtype, x.shape, x.stride(), dy.stride(),
                            _build.aligned16(x, dy, out, elems=1))


def _col(t):
    """``t``'s values in a column-major layout (the boundary mode's
    crossing: ``core.container.as_layout``)."""
    perm = tuple(reversed(range(t.dim())))
    return t.permute(perm).contiguous().permute(perm)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape", [(2, 500), (2, 32, 15, 15), (2, 64, 7, 7),
                                   (3, 5, 7), (2, 1, 3, 1, 5)])
def test_plan(dtype, shape):
    x, dy = torch.zeros(shape, dtype=dtype), torch.ones(shape, dtype=dtype)
    assert _route(x, dy) == "vec"                  # row-major
    assert _route(_col(x), _col(dy)) == "vec"      # both column-major
    # the transposed boundary mode: a column-major x meets a row-major dy
    assert _route(_col(x), dy) == "strided"
    assert _route(x, _col(dy)) == "strided"
    # an operand offset by one element: its base is not 16-byte aligned
    n = x.numel()
    buf = torch.zeros(n + 1, dtype=dtype)
    off = buf[1:].view(shape)
    assert _route(off, dy) == "strided" and _route(x, off) == "strided"
    assert _route(buf[:n].view(shape), dy) == "vec"


def test_plan_needs_one_dense_layout():
    x = torch.zeros((8, 6))
    assert EW.relu_bwd_plan(F32, (8, 6), (6, 1), (6, 1), True) == "vec"
    assert EW.relu_bwd_plan(F32, (8, 6), (1, 8), (1, 8), True) == "vec"
    # a sliced (gapped) layout, overlapping strides, mixed layouts
    assert EW.relu_bwd_plan(F32, (8, 6), (12, 1), (12, 1), True) == "strided"
    assert EW.relu_bwd_plan(F32, (8, 6), (0, 1), (0, 1), True) == "strided"
    assert EW.relu_bwd_plan(F32, (8, 6), (6, 1), (1, 8), True) == "strided"
    assert EW.relu_bwd_plan(F32, (8, 6), (6, 1), (6, 1), False) == "strided"
    # an axis of extent 1 plays no part in the layout
    assert EW.relu_bwd_plan(F32, (8, 1, 6), (6, 99, 1), (6, 99, 1),
                            True) == "vec"
    assert _route(x, x) == "vec"


def _walk(dtype, n):
    """The vec kernels' visits: for each 16-byte vector, how many threads
    store it, and for each tail element, how many store it
    (``csrc/eltwise.cu:relu_vec_kernel``)."""
    vecs, blocks = EW.RELU_VECS, EW.relu_vec_grid(dtype, n)
    e = 16 // torch.tensor([], dtype=dtype).element_size()
    nv, thr = n // e, EW.RELU_THREADS
    seen = np.zeros(nv, np.int64)
    span = blocks * thr * vecs
    for b in range(blocks):
        for v0 in range(b * thr * vecs, nv, span):
            for u in range(vecs):
                v = v0 + u * thr + np.arange(thr)
                np.add.at(seen, v[v < nv], 1)
    tail = np.zeros(n - nv * e, np.int64)
    tail += 1                                   # block 0, one a thread
    return seen, tail, vecs, blocks


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("n", [64 * 500, 64 * 32 * 15 * 15, 64 * 64 * 7 * 7,
                               105, 3, 8 * 1056 * 256 * 2 + 5])
def test_grid_reaches_every_vector_once(dtype, n):
    seen, tail, vecs, blocks = _walk(dtype, n)
    assert (seen == 1).all() and (tail == 1).all()
    assert len(tail) < 16 // torch.tensor([], dtype=dtype).element_size()
    assert 1 <= blocks <= EW.RELU_BLOCKS
    assert EW.RELU_BLOCKS == 8 * 132
    # the kernel's vectors a thread and threads a block, as the walk has
    src = (_build.CSRC / "eltwise.cu").read_text()
    assert int(re.search(r"constexpr int kVecs = (\d+);", src).group(1)) \
        == vecs
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) \
        == EW.RELU_THREADS


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


@pytest.mark.parametrize("name", ["repro_relu_bwd", "repro_relu_bwd_vec",
                                  "repro_relu", "repro_relu_vec"])
def test_launchers_match_their_ctypes_signatures(name):
    src = (_build.CSRC / "eltwise.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = []
    for p in params.split(","):
        p = " ".join(p.split())
        kinds.append(_CTYPES["void*" if "*" in p else
                             " ".join(p.split()[:-1])])
    assert kinds == _build._SIGNATURES[name]


def _vec_emulation(x, dy, slope):
    """The vec kernel over x and dy's storage in memory order: the walk of
    ``_walk`` on whole vectors, then the tail, each element dy where x > 0
    and else the slope (rounded to the storage dtype) times dy in f32,
    rounded to the storage dtype.  The forward's kernel is this walk with
    x as dy."""
    n, dtype = x.numel(), x.dtype
    flat_x, flat_g = x.reshape(-1), dy.reshape(-1)
    out = torch.empty_like(flat_x)
    s = torch.tensor(slope, dtype=dtype).float()

    def elems(idx):
        xv, gv = flat_x[idx].float(), flat_g[idx]
        out[idx] = torch.where(xv > 0, gv, (s * gv.float()).to(dtype))

    vecs, blocks = EW.RELU_VECS, EW.relu_vec_grid(dtype, n)
    e = 16 // x.element_size()
    nv, thr = n // e, EW.RELU_THREADS
    for b in range(blocks):
        for v0 in range(b * thr * vecs, nv, blocks * thr * vecs):
            for u in range(vecs):
                v = v0 + u * thr + torch.arange(thr)
                v = v[v < nv]
                elems((v[:, None] * e + torch.arange(e)).reshape(-1))
    elems(torch.arange(nv * e, n))
    return out.reshape(x.shape)


# the Caffe train step's CIFAR shape at batch 2, an odd length (a tail)
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("slope", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(2, 32, 15, 15), (3, 5, 7)])
def test_vec_emulation_exact_against_pallas(dtype, slope, shape):
    """Exact against the plain version and against JAX's Pallas kernel,
    in bf16 at 0.1 too, a slope bf16 cannot hold: JAX's weakly typed
    ``slope * dy`` rounds the slope to bf16 before the product, and so
    do the port's kernels and plain version."""
    clear_tuning()
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::17] = np.nan
    x.reshape(-1)[::13] = 0.0
    dy = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    want = np.asarray(relu_bwd_pallas(xj, gj, slope, interpret=True)
                      .astype(jnp.float32))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(dtype)
    gt = torch.tensor(np.asarray(gj.astype(jnp.float32))).to(dtype)
    assert _route(xt, gt) == "vec"
    got = _vec_emulation(xt, gt, slope)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.relu_bwd(xt, gt, slope).float().numpy())
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the same walk over a column-major pair (both column-major: one
    # layout, walked in its memory order)
    rev = tuple(reversed(range(xt.dim())))
    xc, gc = _col(xt), _col(gt)
    assert _route(xc, gc) == "vec"
    flat = _vec_emulation(xc.permute(rev), gc.permute(rev), slope)
    np.testing.assert_array_equal(flat.permute(rev).float().numpy(),
                                  got.float().numpy())


@pytest.mark.parametrize("fn", ["relu", "relu_bwd"])
def test_plain_versions_exact_against_pallas_in_bf16(fn):
    """Both plain versions round the slope to bf16 before the product, as
    JAX's weakly typed ``slope * x`` does, so a slope bf16 cannot hold
    gives JAX's bits."""
    from repro.kernels.eltwise import relu_pallas

    clear_tuning()
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((4, 37)), jnp.bfloat16)
    dy = jnp.asarray(rng.standard_normal((4, 37)), jnp.bfloat16)
    xt, gt = (torch.tensor(np.asarray(a.astype(jnp.float32))).to(BF16)
              for a in (x, dy))
    for slope in (0.1, 0.3, 1 / 3):
        if fn == "relu":
            want = relu_pallas(x, slope, interpret=True)
            got = ref.relu(xt, slope)
        else:
            want = relu_bwd_pallas(x, dy, slope, interpret=True)
            got = ref.relu_bwd(xt, gt, slope)
        assert got.dtype == BF16
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the forward


def _fwd_route(x):
    """The route the forward's wrapper picks for x (out in x's layout)."""
    out = torch.empty_like(x)
    return EW.relu_plan(x.dtype, x.shape, x.stride(),
                        _build.aligned16(x, out, elems=1))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape", [(2, 500), (2, 32, 15, 15), (2, 64, 7, 7),
                                   (3, 5, 7), (2, 1, 3, 1, 5)])
def test_fwd_plan(dtype, shape):
    x = torch.zeros(shape, dtype=dtype)
    assert _fwd_route(x) == "vec"                  # row-major
    assert _fwd_route(_col(x)) == "vec"            # the crossing's blob
    n = x.numel()
    buf = torch.zeros(n + 1, dtype=dtype)
    assert _fwd_route(buf[1:].view(shape)) == "scalar"
    assert _fwd_route(buf[:n].view(shape)) == "vec"


def test_fwd_plan_needs_a_dense_aligned_layout():
    assert EW.relu_plan(F32, (8, 6), (6, 1), True) == "vec"
    assert EW.relu_plan(F32, (8, 6), (1, 8), True) == "vec"
    assert EW.relu_plan(F32, (8, 6), (6, 1), False) == "scalar"
    assert EW.relu_plan(F32, (8, 6), (12, 1), True) == "scalar"
    assert EW.relu_plan(F32, (8, 1, 6), (6, 99, 1), True) == "vec"


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("slope", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(2, 500), (2, 32, 15, 15), (3, 5, 7),
                                   (1, 13)])
def test_fwd_vec_emulation_exact_against_pallas(dtype, slope, shape):
    """Exact against the plain version and against JAX's Pallas kernel,
    NaNs and zeros included, in bf16 at 0.1 too (rounded to bf16 before
    the product, as JAX's weakly typed ``slope * x``)."""
    clear_tuning()
    rng = np.random.default_rng(sum(shape) + 7)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::17] = np.nan
    x.reshape(-1)[::13] = 0.0
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    want = np.asarray(relu_pallas(xj, slope, interpret=True)
                      .astype(jnp.float32))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(dtype)
    assert _fwd_route(xt) == "vec"
    got = _vec_emulation(xt, xt, slope)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.relu(xt, slope).float().numpy())
    np.testing.assert_array_equal(got.float().numpy(), want)
    # a column-major x: one dense layout, walked in its memory order
    rev = tuple(reversed(range(xt.dim())))
    xc = _col(xt)
    assert _fwd_route(xc) == "vec"
    flat = _vec_emulation(xc.permute(rev), xc.permute(rev), slope)
    np.testing.assert_array_equal(flat.permute(rev).float().numpy(),
                                  got.float().numpy())
