"""The row softmax's routes on the CPU, and a plain emulation of what its
"rows" kernel computes, against the JAX package.

``kernels/softmax_xent.py`` picks the route in pure Python, and the card's
kernels follow it: ``softmax_plan`` (rows of unit stride on a 16-byte
aligned base -> the "rows" kernel, ``csrc/softmax_xent.cu:
softmax_reg_kernel``; every other layout and base -> the first port's
"strided" kernel) and ``softmax_rows`` (threads a row, rows a block,
items a lane, 16-byte items or elements).  Held here: the routes and
grids at the path shapes (the deploy form's 64 x 10 and the 256 x 1000
yardstick, f32 and bf16), the layout, alignment and width edges, the
route of the deploy net's Softmax in each boundary mode from a CPU walk
of its crossings, the C signature of the new launcher and the kernel's
constants against the planner's, and an emulation in plain PyTorch of
the kernel's arithmetic order (each lane's items in order, the max and
sum shuffle trees, the warps of a wide row merged in order, ``e /
sum(e)``) against ``softmax_pallas`` in interpret mode (1e-6) and the
plain version (1e-5), a row of -inf giving NaN on every side.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.softmax_xent import softmax_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import softmax_xent as SX  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


def _plan(x):
    aligned = x.data_ptr() % 16 == 0
    return (SX.softmax_plan(x.dtype, x.shape, x.stride(), aligned),
            SX.softmax_rows(x.dtype, x.shape, x.stride(), aligned))


# (shape, dtype) -> the grid: 64 x 10 in elements (40 or 20 bytes a row),
# 16 lanes of one a row, two rows a warp-sized block; 256 x 1000 in
# 16-byte vectors (250 f32, 125 bf16), a block a row
PATH = {((64, 10), F32): SX.Rows(16, 2, 1, False, 32, 32),
        ((64, 10), BF16): SX.Rows(16, 2, 1, False, 32, 32),
        ((256, 1000), F32): SX.Rows(256, 1, 1, True, 256, 256),
        ((256, 1000), BF16): SX.Rows(128, 1, 1, True, 128, 256)}


@pytest.mark.parametrize("shape,dtype", list(PATH))
def test_plan_path_shapes(shape, dtype):
    x = torch.zeros(shape, dtype=dtype)
    route, g = _plan(x)
    assert route == "rows" and g == PATH[(shape, dtype)]
    rows, v = shape
    e = 16 // dtype.itemsize if g.vec else 1
    # every element of a row is one lane's item, and a block is whole warps
    assert g.per * g.tpr * e >= v > (g.per * g.tpr - g.tpr) * e or \
        g.per == SX.ROWS_PER[0]
    assert g.threads % 32 == 0 and g.threads <= SX.ROWS_MAX_THREADS
    # the grid reaches one block an SM where the rows allow: else a block
    # is one warp of rows already
    assert g.blocks * g.rows >= rows
    assert g.blocks >= SX.SOFTMAX_BLOCKS or g.rows == max(1, 32 // g.tpr)


def test_plan_layouts_and_edges():
    x = torch.zeros((64, 10))
    # the transposed crossing's column-major blob: "strided"
    col = torch.zeros((10, 64)).T
    assert col.stride() == (1, 64) and _plan(col)[0] == "strided"
    # a base off 16 bytes: "strided"
    buf = torch.zeros(64 * 10 + 4)
    assert _plan(buf[1:641].view(64, 10))[0] == "strided"
    assert _plan(buf[4:644].view(64, 10))[0] == "rows"
    # rows of unit stride whose stride is no whole vector: elements
    wide = torch.zeros((8, 68))[:, :64]
    route, g = _plan(wide)
    assert route == "rows" and g.vec
    wide = torch.zeros((8, 66))[:, :64]
    route, g = _plan(wide)
    assert route == "rows" and not g.vec
    assert _plan(x)[1].vec is False            # 40-byte rows
    # one row: its stride is never read
    assert _plan(torch.zeros((1, 8)))[1].vec
    # the widest rows the registers hold: 8 items of 512 threads
    most = SX.ROWS_PER[-1] * SX.ROWS_MAX_THREADS
    for v, route in ((4 * most, "rows"), (4 * most + 4, "strided")):
        assert SX.softmax_plan(F32, (2, v), (v, 1), True) == route
    for v, route in ((most, "rows"), (most + 2, "strided")):
        # odd widths in elements (no vectors)
        assert SX.softmax_plan(F32, (2, v + 1), (v + 1, 1), True) == \
            ("rows" if v + 1 <= most else "strided")
    assert SX.softmax_rows(F32, (2, 4 * most), (4 * most, 1), True).per \
        == SX.ROWS_PER[-1]


def test_deploy_routes_from_the_crossing():
    """The deploy net's Softmax bottom as each boundary mode hands it over
    (a CPU walk at batch 64): rows of unit stride in the fused and
    ``transfer`` modes, a column-major blob in ``transfer+transpose``,
    which is what chip_smoke.py's ``caffe_softmax_routes`` asserts on the
    card."""
    from repro_torch.caffe import LayerSpec, Net, Solver
    from repro_torch.caffe import lenet_mnist, lenet_mnist_solver
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.kernels import ops

    spec = lenet_mnist()
    spec = dataclasses.replace(
        spec, name="lenet-mnist-deploy", layers=spec.layers + (LayerSpec(
            name="prob", type="Softmax", bottoms=("ip2",),
            tops=("prob",)),))
    params = Solver(Net(spec), lenet_mnist_solver()).init(
        torch.Generator().manual_seed(0), device="cpu")["params"]
    data, _ = mnist_like(64, seed=0, device="cpu").batch(0)
    seen = []
    real = ops.softmax

    def spy(x, dim=-1):
        seen.append(_plan(x)[0])
        return real(x, dim)
    for boundary, want in ((None, "rows"), ("transfer", "rows"),
                           ("transfer+transpose", "strided")):
        seen.clear()
        ops.softmax = spy
        try:
            with torch.no_grad():
                Net(spec, boundary=boundary).forward(params, data)
        finally:
            ops.softmax = real
        assert seen == [want], boundary


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


@pytest.mark.parametrize("name", ["repro_softmax_reg", "repro_softmax_rows"])
def test_launchers_match_their_ctypes_signatures(name):
    src = (_build.CSRC / "softmax_xent.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = []
    for prm in params.split(","):
        prm = " ".join(prm.split())
        kinds.append(_CTYPES["void*" if "*" in prm else
                             " ".join(prm.split()[:-1])])
    assert kinds == _build._SIGNATURES[name]


def test_kernel_constants_are_the_planners():
    src = (_build.CSRC / "softmax_xent.cu").read_text()
    assert int(re.search(r"constexpr int kRowsMaxThreads = (\d+);",
                         src).group(1)) == SX.ROWS_MAX_THREADS
    inst = re.search(r"\n  (X\(\d+\)(?: X\(\d+\))*)\n", src).group(1)
    assert tuple(int(p) for p in re.findall(r"\d+", inst)) == SX.ROWS_PER


def _rows_emulation(x, g):
    """The rows kernel on x (rows, V): lane j of a row holds items j + i
    tpr (i < per; 16-byte vectors or elements), its max and its sum in
    item order, the xor trees over the lanes of a warp, the warps of a
    wide row in order; p = e / sum, rounded once to x's dtype."""
    rows, v = x.shape
    e = 16 // x.dtype.itemsize if g.vec else 1
    items = v // e
    xf = x.float()
    vals = torch.full((rows, g.tpr, g.per, e), float("-inf"))
    valid = torch.zeros((g.tpr, g.per), dtype=torch.bool)
    for j in range(g.tpr):
        for i in range(g.per):
            idx = j + i * g.tpr
            if idx < items:
                vals[:, j, i] = xf[:, idx * e:(idx + 1) * e]
                valid[j, i] = True
    m = vals.amax(dim=(1, 2, 3))                   # order-free
    ex = torch.where(valid[None, :, :, None],
                     torch.exp(vals - m[:, None, None, None]), 0.0)
    s = torch.zeros((rows, g.tpr))
    for i in range(g.per):
        for k in range(e):
            s = torch.where(valid[None, :, i], s + ex[:, :, i, k], s)
    span = min(g.tpr, 32)
    o = span // 2
    while o:
        s = s + s[:, torch.arange(g.tpr) ^ o]
        o //= 2
    tot = s[:, 0]
    for w in range(1, g.tpr // 32):
        tot = tot + s[:, 32 * w]
    p = ex / tot[:, None, None, None]
    out = torch.empty((rows, v))
    for j in range(g.tpr):
        for i in range(g.per):
            idx = j + i * g.tpr
            if idx < items:
                out[:, idx * e:(idx + 1) * e] = p[:, j, i]
    return out.to(x.dtype)


# (rows, V, knobs): the deploy form's 64 x 10 at the planner's grid and at
# 8 lanes of two a row, 16-byte rows, a ragged width, two warps a row
# (merged in shared memory) and a row past 32 lanes of vectors
EMULATED = [(64, 10, {}), (64, 10, {"SOFTMAX_ITEMS": 2}), (8, 64, {}),
            (5, 33, {}), (6, 64, {"SOFTMAX_ITEMS": 1}),
            (3, 48, {"SOFTMAX_ITEMS": 1})]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rows,v,knobs", EMULATED)
def test_emulation_against_pallas(dtype, rows, v, knobs, monkeypatch):
    rng = np.random.default_rng(rows * v)
    a = (3 * rng.standard_normal((rows, v))).astype(np.float32)
    a[1] = -np.inf
    x = torch.from_numpy(a).to(dtype)
    if knobs.get("SOFTMAX_ITEMS") == 1 and v == 64 and rows == 6:
        # elements, not vectors: a row stride off the vectors, and 64
        # lanes a row (two warps)
        x = torch.nn.functional.pad(x, (0, 1))[:, :v]
    for k, val in knobs.items():
        monkeypatch.setattr(SX, k, val)
    route, g = _plan(x)
    assert route == "rows"
    got = _rows_emulation(x, g)
    want = ref.softmax(x)
    pal = torch.from_numpy(np.array(softmax_pallas(
        jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == BF16 else jnp.float32),
        interpret=True).astype(jnp.float32)))
    nan = torch.isnan(want)
    assert nan[1].all() and torch.isnan(got[1]).all() and \
        torch.isnan(pal[1]).all()
    ok = ~nan.any(-1)
    tol = dict(atol=2 ** -8, rtol=2 ** -7) if dtype == BF16 else {}
    torch.testing.assert_close(got[ok].float(), want[ok].float(),
                               **(tol or dict(atol=1e-5, rtol=1e-5)))
    torch.testing.assert_close(got[ok].float(), pal[ok],
                               **(tol or dict(atol=1e-6, rtol=1e-6)))
    if knobs.get("SOFTMAX_ITEMS") == 1 and v == 64 and rows == 6:
        assert g.tpr == 64 and not g.vec
