"""The fused softmax + cross-entropy's routes on the CPU, and a plain
emulation of what its "rows" kernel computes, against the JAX package.

``kernels/softmax_xent.py`` picks the route in pure Python, and the card's
kernels follow it: ``softmax_xent_plan`` (rows of unit stride on a 16-byte
aligned base -> the register-row kernel with the mean fused in,
``csrc/softmax_xent.cu:softmax_reg_kernel`` with ``kXent``; every other
layout, base and an empty batch -> the first port's "strided" kernel and
``nll.mean()``) and ``softmax_xent_rows`` (threads a row, rows a block,
items a lane, 16-byte items or elements, and one block for the whole
batch where it fits).  Held here: the routes and grids at the path shapes
(LeNet's 64 x 10 loss, one block in f32 and bf16; the 256 x 1000
yardstick, two launches), the layout, alignment and label edges, the
route of the loss in each boundary mode from a CPU walk of a train step,
a walk of the grid that writes every element of probs once and every
row's NLL once (labels -1 and V too), the C signature of the new launcher
and the kernel's constants against the planner's, and an emulation in
plain PyTorch of the kernel's order of work (each lane's items in order,
the max and sum shuffle trees, ``logp = s - lse`` once per element, the
block's NLLs summed lane-strided then by the xor tree, the partials of
several blocks summed by the second pass) against ``softmax_xent_pallas``
in interpret mode: probs and the mean within 1e-5 in f32 (bf16 probs
within one bf16 ulp), labels -1 and V included, B inside and past the
one-block cap.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.softmax_xent import softmax_xent_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import softmax_xent as SX  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


def _plan(x):
    aligned = x.data_ptr() % 16 == 0
    return (SX.softmax_xent_plan(x.dtype, x.shape, x.stride(), aligned),
            SX.softmax_xent_rows(x.dtype, x.shape, x.stride(), aligned))


# (shape, dtype) -> the grid: LeNet's loss (both nets: 64 x 10, 40 or 20
# bytes a row, elements) in one block of 64 rows at 8 lanes of two; the
# 256 x 1000 yardstick in 16-byte vectors (250 f32, 125 bf16), a block a
# row, then the second pass over 256 partials
PATH = {((64, 10), F32): SX.Rows(8, 64, 2, False, 512, 1),
        ((64, 10), BF16): SX.Rows(8, 64, 2, False, 512, 1),
        ((256, 1000), F32): SX.Rows(256, 1, 1, True, 256, 256),
        ((256, 1000), BF16): SX.Rows(128, 1, 1, True, 128, 256)}


@pytest.mark.parametrize("shape,dtype", list(PATH))
def test_plan_path_shapes(shape, dtype):
    x = torch.zeros(shape, dtype=dtype)
    route, g = _plan(x)
    assert route == "rows" and g == PATH[(shape, dtype)]
    rows, v = shape
    e = 16 // dtype.itemsize if g.vec else 1
    # every element of a row is one lane's item, and a block whole warps
    assert g.per * g.tpr * e >= v and g.per in SX.ROWS_PER
    assert g.threads == g.tpr * g.rows and g.threads % 32 == 0
    assert g.threads <= SX.ROWS_MAX_THREADS
    assert g.blocks * g.rows >= rows > (g.blocks - 1) * g.rows


def test_plan_layouts_and_edges():
    x = torch.zeros((64, 10))
    # the transposed crossing's column-major blob: "strided"
    col = torch.zeros((10, 64)).T
    assert col.stride() == (1, 64) and _plan(col)[0] == "strided"
    # a base off 16 bytes: "strided"; on 16 bytes: "rows"
    buf = torch.zeros(64 * 10 + 4)
    assert _plan(buf[1:641].view(64, 10))[0] == "strided"
    assert _plan(buf[4:644].view(64, 10))[0] == "rows"
    # an empty batch or row: "strided" (its mean is the plain NaN)
    assert SX.softmax_xent_plan(F32, (0, 10), (10, 1), True) == "strided"
    assert SX.softmax_xent_plan(F32, (4, 0), (0, 1), True) == "strided"
    # a row too long for the registers: "strided"
    most = SX.ROWS_PER[-1] * SX.ROWS_MAX_THREADS
    for v, route in ((4 * most, "rows"), (4 * most + 4, "strided")):
        assert SX.softmax_xent_plan(F32, (2, v), (v, 1), True) == route
    # rows of unit stride whose stride is no whole vector: elements
    assert not _plan(torch.zeros((8, 66))[:, :64])[1].vec
    assert _plan(torch.zeros((8, 68))[:, :64])[1].vec
    # the labels do not enter the plan: -1 and V are the kernel's to zero
    assert _plan(x)[0] == "rows"


@pytest.mark.parametrize("rows,v,one", [
    (64, 10, True),       # LeNet: 8 lanes of 2, 512 threads
    (65, 10, False),      # one row past the one-block cap at V = 10
    (600, 10, False),
    (256, 3, True),       # 2 lanes of 2 elements, 512 threads
    (257, 3, False),
    (10, 10, True),       # 16 lanes of 1, rounded up to 160 threads
    (1, 4000, True),      # 512 lanes of 2 vectors
    (2, 4000, False),
    (7, 33, True)])
def test_one_block_cap(rows, v, one):
    g = SX.softmax_xent_rows(F32, (rows, v), (v, 1), True)
    assert (g.blocks == 1) == one
    if one:
        assert g.rows >= rows and g.threads % 32 == 0
        assert g.threads <= SX.ROWS_MAX_THREADS
        e = 4 if g.vec else 1
        assert -(-v // e) <= g.per * g.tpr


@pytest.mark.parametrize("knobs", [{}, {"XENT_PACK": 1}, {"XENT_PACK": 8},
                                   {"SOFTMAX_ITEMS": 4,
                                    "SOFTMAX_THREADS": 256},
                                   {"SOFTMAX_BLOCKS": 1024}])
def test_knobs_keep_grids_valid(knobs, monkeypatch):
    """Every plan the sweep on the card can reach is a launch the extern
    takes (``reg_ok``): a power-of-two tpr, whole warps within the
    block's limit, every element a lane's item."""
    for k, val in knobs.items():
        monkeypatch.setattr(SX, k, val)
    for rows, v, dt in ((64, 10, F32), (64, 10, BF16), (256, 1000, F32),
                        (256, 1000, BF16), (65, 10, F32), (3, 4000, F32)):
        x = torch.zeros((rows, v), dtype=dt)
        g = _plan(x)[1]
        e = 16 // dt.itemsize if g.vec else 1
        assert g.tpr & (g.tpr - 1) == 0 and g.threads == g.tpr * g.rows
        assert g.threads % 32 == 0 and g.threads <= SX.ROWS_MAX_THREADS
        assert g.per * g.tpr * e >= v
        assert g.blocks == -(-rows // g.rows)
    if knobs == {"XENT_PACK": 1}:
        # no packing: 64 x 10 takes 32 blocks of 2 rows and the second pass
        assert _plan(torch.zeros((64, 10)))[1].blocks == 32


def _walk(rows, v, labels, g):
    """The rows kernel's visits over the grid ``g``: how many threads
    store each element of probs, how many write each row's NLL (the
    label's lane, or lane 0 for a label outside [0, V)), and how many
    blocks' partials each row enters."""
    e = 4 if g.vec else 1
    items = v // e
    probs = np.zeros((rows, v), np.int64)
    nll = np.zeros(rows, np.int64)
    summed = np.zeros(rows, np.int64)
    for b in range(g.blocks):
        for t in range(g.threads):
            j, row = t % g.tpr, b * g.rows + t // g.tpr
            if row >= rows:
                continue
            y = labels[row]
            found = False
            for i in range(g.per):
                idx = j + i * g.tpr
                if idx < items:
                    probs[row, idx * e:(idx + 1) * e] += 1
                    found |= idx * e <= y < (idx + 1) * e
            if found or (j == 0 and not 0 <= y < v):
                nll[row] += 1
        ra = min(g.rows, rows - b * g.rows)
        for q in range(ra):            # warp 0's lanes, rows q = l + 32 i
            summed[b * g.rows + q] += 1
    return probs, nll, summed


@pytest.mark.parametrize("rows,v,vec", [(64, 10, False), (65, 10, False),
                                        (5, 64, True), (3, 96, True),
                                        (33, 7, False)])
def test_walk_writes_each_once(rows, v, vec):
    stride = v if vec else v + 1           # vectors, or a padded stride
    g = SX.softmax_xent_rows(F32, (rows, v), (stride, 1), True)
    assert g.vec == vec
    labels = np.arange(rows) % (v + 2) - 1   # -1 .. V, every class
    probs, nll, summed = _walk(rows, v, labels, g)
    assert (probs == 1).all() and (nll == 1).all() and (summed == 1).all()


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


@pytest.mark.parametrize("name", ["repro_softmax_xent_reg",
                                  "repro_softmax_reg",
                                  "repro_softmax_rows"])
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
    assert int(re.search(r"constexpr int kXentSumThreads = (\d+);",
                         src).group(1)) == SX.XENT_SUM_THREADS
    inst = re.search(r"\n  (X\(\d+\)(?: X\(\d+\))*)\n", src).group(1)
    assert tuple(int(p) for p in re.findall(r"\d+", inst)) == SX.ROWS_PER
    # the one-block case writes the mean, the others their partials, and
    # the wrapper gives a partials buffer exactly when there are several
    assert "if (gridDim.x == 1)" in src
    assert "!kXent || blocks == 1" in src


def _xor_tree(s, width):
    """``s`` (..., width) reduced as the kernel's xor shuffles: lane l
    adds lane l ^ o for o = width / 2 .. 1; lane 0's value."""
    o = width // 2
    while o:
        s = s + s[..., torch.arange(width) ^ o]
        o //= 2
    return s[..., 0]


def _xent_emulation(x, labels, g):
    """The rows kernel with the loss on x (rows, V): lane j of a row holds
    items j + i tpr (i < per; 16-byte vectors or elements), s = x - max,
    its sum of exp(s) in item order, the xor tree over the lanes of a warp
    and the warps of a wide row in order, lse = log(sum), logp = s - lse,
    probs exp(logp) rounded once to x's dtype, the row's NLL -logp at its
    label (0 outside [0, V)); each block's NLLs: lane l of warp 0 sums
    rows l, l + 32, ... in order, then the xor tree; one block divides by
    B, several write partials that the second pass sums (thread t
    partials t, t + 256, ... in order, each warp's xor tree, the warps in
    order) before dividing by B."""
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
    s = vals - m[:, None, None, None]
    ex = torch.where(valid[None, :, :, None], torch.exp(s), 0.0)
    lane = torch.zeros((rows, g.tpr))
    for i in range(g.per):
        for k in range(e):
            lane = torch.where(valid[None, :, i], lane + ex[:, :, i, k],
                               lane)
    span = min(g.tpr, 32)
    warps = lane.view(rows, -1, span)
    tot = _xor_tree(warps, span)                   # (rows, warps a row)
    acc = tot[:, 0]
    for w in range(1, tot.shape[1]):
        acc = acc + tot[:, w]
    logp = s - torch.log(acc)[:, None, None, None]
    flat = torch.empty((rows, v))
    for j in range(g.tpr):
        for i in range(g.per):
            idx = j + i * g.tpr
            if idx < items:
                flat[:, idx * e:(idx + 1) * e] = logp[:, j, i]
    out = torch.exp(flat)
    lab = labels.long()
    inside = (lab >= 0) & (lab < v)
    nll = torch.where(inside, -flat.gather(
        1, lab.clamp(0, v - 1)[:, None])[:, 0], torch.zeros(rows))
    parts = []
    for b in range(g.blocks):
        blk = nll[b * g.rows:(b + 1) * g.rows]
        lanes = torch.zeros(32)
        for q in range(blk.shape[0]):
            lanes[q % 32] = lanes[q % 32] + blk[q]
        parts.append(_xor_tree(lanes, 32))
    if g.blocks == 1:
        loss = parts[0] / rows
    else:
        n_sum = SX.XENT_SUM_THREADS
        threads = torch.zeros(n_sum)
        for i, p in enumerate(parts):
            threads[i % n_sum] = threads[i % n_sum] + p
        sums = _xor_tree(threads.view(-1, 32), 32)
        loss = sums[0]
        for w in range(1, sums.shape[0]):
            loss = loss + sums[w]
        loss = loss / rows
    return loss, out.to(x.dtype)


# (rows, V, knobs): LeNet's loss in one block, one row past the cap (33
# blocks of two rows, then the second pass), a batch of 600 in 150
# blocks, a ragged width in elements, 16-byte rows in one block, two warps
# a row merged in order, and the 256 x 1000 yardstick's width at 16 rows
# (16 blocks, the second pass)
EMULATED = [(64, 10, {}), (65, 10, {}), (600, 10, {}), (7, 33, {}),
            (8, 64, {}), (6, 64, {"XENT_PACK": 1}),
            (16, 1000, {})]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rows,v,knobs", EMULATED)
def test_emulation_against_pallas(dtype, rows, v, knobs, monkeypatch):
    rng = np.random.default_rng(rows * v)
    a = (3 * rng.standard_normal((rows, v))).astype(np.float32)
    y = rng.integers(0, v, rows)
    y[0], y[-1] = -1, v                 # outside [0, V): NLL 0, still / B
    x = torch.from_numpy(a).to(dtype)
    if knobs.get("XENT_PACK") == 1:
        # elements, not vectors: a row stride off the vectors, and 64
        # lanes a row (two warps)
        x = torch.nn.functional.pad(x, (0, 1))[:, :v]
    for k, val in knobs.items():
        monkeypatch.setattr(SX, k, val)
    labels = torch.from_numpy(y)
    route, g = _plan(x)
    assert route == "rows"
    if (rows, v) == (64, 10):
        assert g.blocks == 1
    if rows in (65, 600) or v == 1000:
        assert g.blocks > 1
    if knobs.get("XENT_PACK") == 1:
        assert g.tpr == 64 and not g.vec
    loss, probs = _xent_emulation(x, labels, g)
    want_loss, want_probs = ref.softmax_xent(x, labels)
    pal_loss, pal_probs = softmax_xent_pallas(
        jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == BF16 else jnp.float32),
        jnp.asarray(y.astype(np.int32)), interpret=True)
    pal_probs = torch.from_numpy(np.array(pal_probs.astype(jnp.float32)))
    pal_loss = float(pal_loss)
    tol = (dict(atol=2 ** -8, rtol=2 ** -7) if dtype == BF16
           else dict(atol=1e-5, rtol=1e-5))
    torch.testing.assert_close(probs.float(), pal_probs, **tol)
    torch.testing.assert_close(probs.float(), want_probs.float(), **tol)
    # the mean: f32 inside on every side, another summation order
    assert abs(loss.item() - pal_loss) <= 1e-5 * abs(pal_loss)
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(pal_loss)


def test_row_of_minus_inf_is_nan():
    """A row of -inf gives NaN probs and a NaN loss, as the plain version
    and JAX's kernel do (exp(-inf - -inf))."""
    x = 3 * torch.randn((64, 10), generator=torch.Generator().manual_seed(0))
    x[1] = float("-inf")
    labels = torch.arange(64) % 10
    g = _plan(x)[1]
    loss, probs = _xent_emulation(x, labels, g)
    want_loss, want_probs = ref.softmax_xent(x, labels)
    assert torch.isnan(loss) and torch.isnan(want_loss)
    assert torch.equal(torch.isnan(probs), torch.isnan(want_probs))
    assert torch.isnan(probs[1]).all() and not torch.isnan(probs[0]).any()


def test_loss_routes_from_the_crossing(monkeypatch):
    """The loss's logits as each boundary mode hands them over (a CPU walk
    of a LeNet-MNIST train step at batch 64, the autograd Functions' hopper
    branch forced: on the CPU each wrapper takes its plain version):
    rows of unit stride on an aligned base in the fused and ``transfer``
    modes, a column-major blob in ``transfer+transpose``, which is what
    chip_smoke.py's ``caffe_xent_routes`` asserts on the card.  A forward
    without grad (phase 8) hands the loss the same blob."""
    from repro_torch.caffe import Net, Solver
    from repro_torch.caffe import lenet_mnist, lenet_mnist_solver
    from repro_torch.data.synthetic import mnist_like
    from repro_torch.kernels import ops

    spec = lenet_mnist()
    params = Solver(Net(spec), lenet_mnist_solver()).init(
        torch.Generator().manual_seed(0), device="cpu")["params"]
    data, label = mnist_like(64, seed=0, device="cpu").batch(0)
    assert label.dtype == torch.int64 and label.is_contiguous()
    seen = []
    real = SX.softmax_xent

    def spy(logits, labels):
        seen.append(_plan(logits)[0])
        assert labels.dtype == torch.int64 and labels.is_contiguous()
        return real(logits, labels)
    monkeypatch.setattr(SX, "softmax_xent", spy)
    monkeypatch.setattr(ops, "use_hopper", lambda t: True)
    for boundary, want in ((None, "rows"), ("transfer", "rows"),
                           ("transfer+transpose", "strided")):
        seen.clear()
        leaves = {n: {k: v.detach().requires_grad_(True)
                      for k, v in p.items()} for n, p in params.items()}
        Net(spec, boundary=boundary).forward_loss(leaves, data,
                                                  label).backward()
        assert seen == [want], boundary
