"""The max-pool backward's routes on the CPU, and a plain emulation of what
its window-owner kernel computes, against the JAX package.

``kernels/pooling.py`` picks the route in pure Python, and the card's
kernels follow it: ``maxpool_bwd_plan`` (dy's and the argmax's rows of unit
stride and a stride the kernel is instantiated for, 2 or 3 -> the
"window" kernel of ``csrc/pooling.cu``; every other layout and stride ->
the first port's "pixel" kernel) and ``maxpool_bwd_band`` (the block's
vectors, window rows and planes, the grid, and the 16-byte stores, from
shapes alone).  Held here: the routes for each layout and stride, the
blocks at MNIST's two pools, at a 3/3 pool of CIFAR's pool1 input and at
odd shapes, and the route of every MNIST pool backward in each boundary
mode from a CPU walk of a train step; a walk of the grid that writes every
input pixel exactly once (k2 s2, k3 s3, k2 s3; pads 0 and 1; odd H and W;
W not a whole number of vectors) and loads only windows that exist; the C
signature of the new launcher and the kernel's constants and
instantiated strides against the planner's; and an emulation in numpy of
the kernel's stores (each thread's windows loaded once, each element dy
where its padded index is one of their argmaxes, else 0), exact against
``maxpool_bwd_pallas`` in interpret mode and ``ref.maxpool_bwd`` on the
same numpy inputs, ties included, f32 and bf16.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.pooling import maxpool_bwd_pallas  # noqa: E402
from repro_torch.core.container import MajorOrder, as_layout  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import pooling as PO  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ref import conv_out_size  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


def _route(dy, arg, shape, k, s, p):
    return PO.maxpool_bwd_plan(dy.dtype, shape, dy.stride(), arg.stride(),
                               k, s, p)


def _dy_arg(shape, k, s, p, dtype=F32):
    n, c, h, w = shape
    oh, ow = conv_out_size(h, k, s, p), conv_out_size(w, k, s, p)
    return (torch.zeros((n, c, oh, ow), dtype=dtype),
            torch.zeros((n, c, oh, ow), dtype=torch.int32))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape,k,s,p", [((64, 20, 24, 24), 2, 2, 0),
                                         ((64, 50, 8, 8), 2, 2, 0),
                                         ((2, 3, 9, 9), 2, 3, 1),
                                         ((2, 3, 9, 9), 3, 3, 0)])
def test_plan_layouts(dtype, shape, k, s, p):
    dy, arg = _dy_arg(shape, k, s, p, dtype)
    # row-major dy and argmax (the fused step's, and the crossings')
    assert _route(dy, arg, shape, k, s, p) == "window"
    # a channel slice of dy: row-major, not contiguous
    n, c, oh, ow = dy.shape
    wide = torch.zeros((n, c + 2, oh, ow), dtype=dtype)[:, 1:1 + c]
    assert not wide.is_contiguous()
    assert _route(wide, arg, shape, k, s, p) == "window"
    # a column-major dy or argmax: "pixel"
    col = as_layout(dy, MajorOrder.ROW, MajorOrder.COLUMN)
    assert _route(col, arg, shape, k, s, p) == "pixel"
    cola = as_layout(arg, MajorOrder.ROW, MajorOrder.COLUMN)
    assert _route(dy, cola, shape, k, s, p) == "pixel"


def test_plan_strides_and_limits():
    # the instantiated strides, any k <= stride: 2 and 3
    assert PO.BWD_STRIDES == (2, 3)
    for k, s, route in ((1, 1, "pixel"), (2, 2, "window"), (1, 2, "window"),
                        (3, 3, "window"), (2, 3, "window"),
                        (4, 4, "pixel"), (2, 4, "pixel")):
        shape = (2, 3, 12, 12)
        dy, arg = _dy_arg(shape, k, s, 0)
        assert _route(dy, arg, shape, k, s, 0) == route, (k, s)
    # one output column: its rows' stride is never read
    shape = (2, 3, 2, 2)
    assert PO.maxpool_bwd_plan(F32, shape, (3, 1, 1, 7), (3, 1, 1, 7), 2, 2,
                               0) == "window"
    # more window rows than the grid's y extent holds: "pixel"
    h = 2 * PO.BWD_MAX_BANDS + 2
    assert PO.maxpool_bwd_plan(F32, (1, 1, h, 4), (h // 2 * 2,) * 3 + (1,),
                               (h // 2 * 2,) * 3 + (1,), 2, 2, 0) == "pixel"


# (shape, k, stride, pad) -> the block: MNIST pool1 (12 window rows of 6
# f32 vectors: 3 planes a block, 427 blocks) and pool2 (4 rows of 2: 16
# planes, 200 blocks), a 3/3 pool of CIFAR's pool1 input (11 rows of 8)
BANDS = {
    (((64, 20, 24, 24), 2, 2, 0), F32): PO.BwdBand(6, 12, 3, 216, True, 427),
    (((64, 20, 24, 24), 2, 2, 0), BF16): PO.BwdBand(3, 12, 7, 252, True,
                                                     183),
    (((64, 50, 8, 8), 2, 2, 0), F32): PO.BwdBand(2, 4, 16, 128, True, 200),
    (((64, 50, 8, 8), 2, 2, 0), BF16): PO.BwdBand(1, 4, 16, 64, True, 200),
    (((64, 32, 32, 32), 3, 3, 0), F32): PO.BwdBand(8, 11, 2, 176, True,
                                                    1024),
}


@pytest.mark.parametrize("case,dtype", list(BANDS))
def test_band_path_shapes(case, dtype):
    shape, k, s, p = case
    b = PO.maxpool_bwd_band(dtype, shape, s, p)
    assert b == BANDS[(case, dtype)]
    assert b.threads <= PO.BWD_THREADS and b.planes <= PO.BWD_MAX_PLANES
    # the grid reaches one block an SM
    assert b.blocks >= PO.BWD_BLOCKS


@pytest.mark.parametrize("units,blocks", [(64, 132), (512, 132),
                                          (256, 1056), (128, 528)])
def test_swept_bands_stay_in_the_limits(units, blocks, monkeypatch):
    """Every block the sweep on the card can reach is one the extern
    takes: within the block's thread and plane limits, no extent past the
    plane's."""
    monkeypatch.setattr(PO, "BWD_UNITS", units)
    monkeypatch.setattr(PO, "BWD_BLOCKS", blocks)
    for (shape, k, s, p), dtype in BANDS:
        b = PO.maxpool_bwd_band(dtype, shape, s, p)
        e = 16 // dtype.itemsize
        assert b.threads == b.cols * b.groups * b.planes <= PO.BWD_THREADS
        assert 1 <= b.planes <= PO.BWD_MAX_PLANES
        assert 1 <= b.cols <= -(-shape[3] // e)
        assert 1 <= b.groups <= PO.window_rows(shape[2], s, p)


def _window_kernel(dy, arg, shape, s, p, band):
    """The window kernel over its grid (``csrc/pooling.cu:
    maxpool_bwd_window_kernel``) on numpy arrays: dy as raw bits (uint32
    or uint16), the argmax int32, both (N, C, OH, OW).  Returns the output
    bits and how many times each input pixel was stored; asserts that only
    windows that exist are loaded."""
    n, c, h, w = shape
    oh, ow = dy.shape[2:]
    P = n * c
    e = 16 // dy.dtype.itemsize
    nw = (e + s - 2) // s + 1
    g0 = p // s
    G = PO.window_rows(h, s, p)
    nv = -(-w // e)
    wp = w + 2 * p
    out = np.full((P, h, w), 0xAB, dy.dtype)     # garbage unless stored
    stores = np.zeros((P, h, w), np.int64)
    dyf, argf = dy.reshape(P, oh, ow), arg.reshape(P, oh, ow)
    pgroups = -(-P // band.planes)
    bands = -(-G // band.groups)
    assert band.blocks == pgroups * bands
    for bx in range(pgroups):
        for by in range(bands):
            gb = by * band.groups
            ga, p0 = min(band.groups, G - gb), bx * band.planes
            pa = min(band.planes, P - p0)
            for q in range(pa):                     # tz, on by blockDim.z
                pl = p0 + q
                for gi in range(ga):                # ty
                    g = g0 + gb + gi
                    for v in range(nv):             # tx
                        x0 = v * e
                        ox0 = (x0 + p) // s
                        a = [-1] * nw
                        d = [0] * nw
                        if g < oh:
                            for wi in range(nw):
                                ox = ox0 + wi
                                if ox < ow and ox * s - p < x0 + e:
                                    a[wi], d[wi] = argf[pl, g, ox], \
                                        dyf[pl, g, ox]
                        for i in range(s):
                            y = g * s - p + i
                            if not 0 <= y < h:
                                continue
                            at = (y + p) * wp + p + x0
                            for el in range(e):
                                if x0 + el >= w:
                                    continue       # a row's ragged end
                                o = 0
                                for wi in range(nw):
                                    if a[wi] == at + el:
                                        o = d[wi]
                                out[pl, y, x0 + el] = o
                                stores[pl, y, x0 + el] += 1
    return out.reshape(shape), stores


def _bits(t):
    return t.contiguous().view(
        torch.int32 if t.dtype == F32 else torch.int16).numpy().view(
        np.uint32 if t.dtype == F32 else np.uint16)


# (shape, k, stride, pad): MNIST's pools at batch 2, k3 s3, k2 s3 (a gap
# column and row between windows), pad 1, odd H and W, W not a whole
# number of vectors (9, 13; 12 in bf16), a window wholly in the padding
# (pad 2), rim rows and columns no window covers (H + 2 pad - k not a
# multiple of the stride)
WALKED = [((2, 20, 24, 24), 2, 2, 0), ((2, 50, 8, 8), 2, 2, 0),
          ((2, 3, 9, 9), 3, 3, 0), ((2, 3, 9, 9), 2, 3, 1),
          ((2, 3, 11, 13), 2, 3, 0), ((2, 3, 10, 11), 2, 2, 1),
          ((3, 5, 7, 13), 3, 3, 0), ((1, 2, 4, 4), 2, 2, 2),
          ((2, 4, 12, 12), 2, 2, 1), ((1, 3, 17, 20), 3, 3, 1)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape,k,s,p", WALKED)
def test_emulation_walk_and_pallas(dtype, shape, k, s, p):
    rng = np.random.default_rng(sum(shape) * 31 + k * 7 + s * 3 + p)
    # exact ties (-1, 0, 1) in half the planes, random values in the rest
    x = rng.standard_normal(shape).astype(np.float32)
    x[:, ::2] = rng.integers(-1, 2, x[:, ::2].shape)
    xt = torch.from_numpy(x).to(dtype)
    out, arg = ref.maxpool(xt, k, s, p)
    dy = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(dtype)
    assert _route(dy, arg, shape, k, s, p) == "window"
    band = PO.maxpool_bwd_band(dtype, shape, s, p)
    got_bits, stores = _window_kernel(_bits(dy), arg.numpy(), shape, s, p,
                                      band)
    # every input pixel stored exactly once
    assert (stores == 1).all()
    want = ref.maxpool_bwd(dy, arg, shape, k, s, p)
    np.testing.assert_array_equal(got_bits, _bits(want))
    pal = maxpool_bwd_pallas(
        jnp.asarray(dy.float().numpy()).astype(
            jnp.bfloat16 if dtype == BF16 else jnp.float32),
        jnp.asarray(arg.numpy()), shape, k, s, p, interpret=True)
    pal = torch.from_numpy(np.array(pal.astype(jnp.float32))).to(dtype)
    np.testing.assert_array_equal(got_bits, _bits(pal))


@pytest.mark.parametrize("units,blocks", [(32, 132), (64, 1056)])
def test_walk_at_swept_bands(units, blocks, monkeypatch):
    """Smaller blocks split a plane's window rows into bands, several
    bands and planes looping: still every pixel once, still exact."""
    monkeypatch.setattr(PO, "BWD_UNITS", units)
    monkeypatch.setattr(PO, "BWD_BLOCKS", blocks)
    shape, k, s, p = (2, 4, 24, 24), 2, 2, 0
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    _, arg = ref.maxpool(x, k, s, p)
    dy = torch.randn(arg.shape, generator=torch.Generator().manual_seed(2))
    band = PO.maxpool_bwd_band(F32, shape, s, p)
    assert band.groups < PO.window_rows(24, 2, 0)
    got, stores = _window_kernel(_bits(dy), arg.numpy(), shape, s, p, band)
    assert (stores == 1).all()
    np.testing.assert_array_equal(
        got, _bits(ref.maxpool_bwd(dy, arg, shape, k, s, p)))


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


@pytest.mark.parametrize("name", ["repro_maxpool_bwd_window",
                                  "repro_maxpool_bwd"])
def test_launchers_match_their_ctypes_signatures(name):
    src = (_build.CSRC / "pooling.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = []
    for prm in params.split(","):
        prm = " ".join(prm.split())
        kinds.append(_CTYPES["void*" if "*" in prm else
                             " ".join(prm.split()[:-1])])
    assert kinds == _build._SIGNATURES[name]


def test_kernel_constants_are_the_planners():
    src = (_build.CSRC / "pooling.cu").read_text()
    assert int(re.search(r"constexpr int kBwdThreads = (\d+);",
                         src).group(1)) == PO.BWD_THREADS
    assert int(re.search(r"constexpr int kBwdMaxPlanes = (\d+);",
                         src).group(1)) == PO.BWD_MAX_PLANES
    assert re.search(r"bands > (\d+)", src).group(1) == \
        str(PO.BWD_MAX_BANDS)
    body = src[src.index("cudaError_t launch_bwd_window("):]
    inst = tuple(int(v) for v in re.findall(
        r"if \(stride == (\d+)\)\n    return launch_bwd_window_s", body))
    assert inst == PO.BWD_STRIDES


def test_pool_bwd_routes_from_the_crossing(monkeypatch):
    """dy and the argmax of each MNIST pool backward as each boundary mode
    hands them over (a CPU walk of a LeNet-MNIST train step at batch 64,
    the autograd Functions' hopper branch forced: on the CPU each wrapper
    takes its plain version): rows of unit stride in all three modes
    (the argmax is the forward kernel's contiguous output; dy comes back
    from the next layer's backward row-major, through the crossing's
    transpose too), so every MNIST pool backward takes "window", which is
    what chip_smoke.py's ``caffe_pool_bwd_routes`` asserts on the card."""
    from repro_torch.caffe import Net, Solver
    from repro_torch.caffe import lenet_mnist, lenet_mnist_solver
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.kernels import ops

    spec = lenet_mnist()
    params = Solver(Net(spec), lenet_mnist_solver()).init(
        torch.Generator().manual_seed(0), device="cpu")["params"]
    data, label = mnist_like(64, seed=0, device="cpu").batch(0)
    seen = []
    real = ops.maxpool_bwd_hopper

    def spy(dy, arg, x_shape, k, stride, pad=0):
        seen.append(_route(dy, arg, tuple(x_shape), k, stride, pad))
        return real(dy, arg, x_shape, k, stride, pad)
    monkeypatch.setattr(ops, "maxpool_bwd_hopper", spy)
    monkeypatch.setattr(ops, "use_hopper", lambda t: True)
    for boundary in (None, "transfer", "transfer+transpose"):
        seen.clear()
        leaves = {n: {k: v.detach().requires_grad_(True)
                      for k, v in p.items()} for n, p in params.items()}
        Net(spec, boundary=boundary).forward_loss(leaves, data,
                                                  label).backward()
        assert seen == ["window", "window"], boundary
