"""The softmax + cross-entropy backward's routes on the CPU, a plain
emulation of what its kernels compute with the loss's cotangent folded in,
and the loss's autograd against the JAX package.

``kernels/softmax_xent.py`` picks the route in pure Python, and the card's
kernels follow it: ``softmax_xent_bwd_plan`` (probs whose rows have unit
stride on a 16-byte aligned base -> the register-row kernel,
``csrc/softmax_xent.cu:xent_bwd_reg_kernel``; every other layout, base and
an empty batch -> the first port's "strided" kernel) and
``softmax_xent_bwd_rows`` (the forward's grid: LeNet's whole 64 x 10 batch
in one block).  Both kernels write ``round(float(t) * g_T)``, ``t = (p -
onehot) / B`` rounded to the probs' dtype and ``g_T`` the f32 cotangent
rounded to it, as torch's multiply by a 0-d f32 tensor rounds it on the
card: the kernel-then-``* g`` composition that ``XentFn.backward`` ran
before, bit for bit, in one launch.  Held here: the routes and grids at the
path shapes and edges, a walk of the grid that writes every element once,
the C signatures of both launchers, the route of the backward in each
boundary mode from a CPU walk of a train step, an emulation of the
kernels' arithmetic exact against that composition in f32 and bf16 (and
against ``softmax_xent_bwd_pallas`` in interpret mode where g = 1), the
wrapper's two forms against the plain version, and ``XentFn`` under a
cotangent of 1.7 with labels -1 and V against ``jax.vjp`` of JAX's loss on
its Pallas backend, within 1e-5 of the largest gradient (the tolerance of
``tests/test_torch_caffe_grad.py``'s loss gradient).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import use_backend as jax_use_backend  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.softmax_xent import softmax_xent_bwd_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import softmax_xent as SX  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
GRAD_REL = 1e-5


def _plan(p):
    aligned = p.data_ptr() % 16 == 0
    return (SX.softmax_xent_bwd_plan(p.dtype, p.shape, p.stride(), aligned),
            SX.softmax_xent_bwd_rows(p.dtype, p.shape, p.stride(), aligned))


# (shape, dtype) -> the grid: LeNet's 64 x 10 (40 or 20 bytes a row,
# elements) in one block of 64 rows at 8 lanes of two; 256 x 1000 in
# 16-byte vectors (250 f32, 125 bf16), a block a row
PATH = {((64, 10), F32): SX.Rows(8, 64, 2, False, 512, 1),
        ((64, 10), BF16): SX.Rows(8, 64, 2, False, 512, 1),
        ((256, 1000), F32): SX.Rows(256, 1, 1, True, 256, 256),
        ((256, 1000), BF16): SX.Rows(128, 1, 1, True, 128, 256)}


@pytest.mark.parametrize("shape,dtype", list(PATH))
def test_plan_path_shapes(shape, dtype):
    p = torch.zeros(shape, dtype=dtype)
    route, g = _plan(p)
    assert route == "rows" and g == PATH[(shape, dtype)]
    rows, v = shape
    e = 16 // dtype.itemsize if g.vec else 1
    assert g.per * g.tpr * e >= v and g.per in SX.ROWS_PER
    assert g.threads == g.tpr * g.rows and g.threads % 32 == 0
    assert g.threads <= SX.ROWS_MAX_THREADS
    assert g.blocks * g.rows >= rows > (g.blocks - 1) * g.rows


def test_plan_layouts_and_edges():
    # the column-major blob of the transposed crossing: "strided"
    col = torch.zeros((10, 64)).T
    assert col.stride() == (1, 64) and _plan(col)[0] == "strided"
    # a base off 16 bytes: "strided"; on 16 bytes: "rows"
    buf = torch.zeros(64 * 10 + 4)
    assert _plan(buf[1:641].view(64, 10))[0] == "strided"
    assert _plan(buf[4:644].view(64, 10))[0] == "rows"
    # an empty batch or row: "strided" (the wrapper launches nothing)
    assert SX.softmax_xent_bwd_plan(F32, (0, 10), (10, 1), True) == "strided"
    assert SX.softmax_xent_bwd_plan(F32, (4, 0), (0, 1), True) == "strided"
    # a row too long for the registers: "strided"
    most = SX.ROWS_PER[-1] * SX.ROWS_MAX_THREADS
    for v, route in ((4 * most, "rows"), (4 * most + 4, "strided")):
        assert SX.softmax_xent_bwd_plan(F32, (2, v), (v, 1), True) == route


@pytest.mark.parametrize("rows,v,one", [(64, 10, True), (65, 10, False),
                                        (10, 10, True), (2, 4000, False)])
def test_one_block_for_the_lenet_batch(rows, v, one):
    g = SX.softmax_xent_bwd_rows(F32, (rows, v), (v, 1), True)
    assert (g.blocks == 1) == one
    assert g.blocks == -(-rows // g.rows)


def _walk(rows, v, g):
    """How many threads of the grid ``g`` store each element."""
    e = 4 if g.vec else 1
    seen = np.zeros((rows, v), np.int64)
    for b in range(g.blocks):
        for t in range(g.threads):
            j, row = t % g.tpr, b * g.rows + t // g.tpr
            if row >= rows:
                continue
            for i in range(g.per):
                idx = j + i * g.tpr
                if idx < v // e:
                    seen[row, idx * e:(idx + 1) * e] += 1
    return seen


@pytest.mark.parametrize("rows,v,vec", [(64, 10, False), (65, 10, False),
                                        (5, 64, True), (33, 7, False),
                                        (3, 1000, True)])
def test_walk_writes_each_once(rows, v, vec):
    stride = v if vec else v + 1           # vectors, or a padded stride
    g = SX.softmax_xent_bwd_rows(F32, (rows, v), (stride, 1), True)
    assert g.vec == vec
    assert (_walk(rows, v, g) == 1).all()


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


@pytest.mark.parametrize("name", ["repro_softmax_xent_bwd",
                                  "repro_softmax_xent_bwd_reg"])
def test_launchers_match_their_ctypes_signatures(name):
    src = (_build.CSRC / "softmax_xent.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = []
    for prm in params.split(","):
        prm = " ".join(prm.replace("const ", "").split())
        kinds.append(_CTYPES["void*" if "*" in prm else
                             " ".join(prm.split()[:-1])])
    assert kinds == _build._SIGNATURES[name]


def test_kernels_fold_g_after_the_first_rounding():
    """Both kernels share one element function: t rounded to T, then
    times g rounded to T; the rows kernel is instantiated at every items a
    lane the planner can give."""
    src = (_build.CSRC / "softmax_xent.cu").read_text()
    assert "to_f32(from_f32<T>((p - (c == y ? 1.f : 0.f)) * scale)) * g" \
        in src
    assert "return g ? to_f32(from_f32<T>(__ldg(g))) : 1.f;" in src
    assert src.count("const float gv = xent_g<T>(g);") == 2
    body = src[src.index("int bwd_reg_launch("):]
    inst = re.search(r"\n  (X\(\d+\)(?: X\(\d+\))*)\n", body).group(1)
    assert tuple(int(p) for p in re.findall(r"\d+", inst)) == SX.ROWS_PER


def _kernel_emulation(p, labels, g):
    """The kernels' arithmetic: t = ((p - onehot) * f32(1/B)) rounded to
    p's dtype, then float(t) * float(g rounded to p's dtype), rounded once
    (no g: t)."""
    rows, v = p.shape
    onehot = (labels.long()[:, None] == torch.arange(v)).float()
    scale = torch.tensor(1.0 / rows, dtype=F32)
    t = ((p.float() - onehot) * scale).to(p.dtype)
    if g is None:
        return t
    return (t.float() * g.to(p.dtype).float()).to(p.dtype)


def _probs(rows, v, dtype, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy((3 * rng.standard_normal((rows, v))).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, v, rows))
    y[0], y[-1] = -1, v                  # outside [0, V): p / B
    return torch.softmax(a, -1).to(dtype), y


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == F32 else
                               torch.int16)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("rows,v", [(64, 10), (65, 10), (7, 33),
                                    (16, 1000)])
def test_emulation_is_the_two_step_composition(dtype, rows, v):
    """Bit for bit the first kernel then ``* g`` with the cotangent in
    the probs' dtype (the card's torch multiply), at g = 1.7, 0.3 and 1;
    with no g (or g = 1) bit for bit ``softmax_xent_bwd_pallas`` in
    interpret mode, which computes ``(p - onehot) * (1/B)`` in f32 and
    rounds once, as the kernels do."""
    p, y = _probs(rows, v, dtype, rows * v)
    t = _kernel_emulation(p, y, None)
    for cot in (1.7, 0.3, 1.0):
        g = torch.tensor(cot)
        assert torch.equal(_bits(_kernel_emulation(p, y, g)),
                           _bits(t * g.to(dtype)))
    assert torch.equal(_bits(_kernel_emulation(p, y, torch.tensor(1.0))),
                       _bits(t))
    pal = softmax_xent_bwd_pallas(
        jnp.asarray(p.float().numpy()).astype(
            jnp.bfloat16 if dtype == BF16 else jnp.float32),
        jnp.asarray(y.numpy().astype(np.int32)), interpret=True)
    pal = torch.from_numpy(np.array(pal.astype(jnp.float32)))
    assert torch.equal(t.float(), pal)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_wrapper_forms_against_the_plain_version(dtype):
    """On the CPU the wrapper takes the plain version: ``g=None`` is
    ``ref.softmax_xent_bwd``, and the g form is that times g."""
    p, y = _probs(64, 10, dtype, 3)
    g = torch.tensor(1.7)
    assert torch.equal(SX.softmax_xent_bwd(p, y), ref.softmax_xent_bwd(p, y))
    assert torch.equal(SX.softmax_xent_bwd(p, y, g),
                       ref.softmax_xent_bwd(p, y) * g)
    # and both within one rounding of the kernels' arithmetic
    tol = 2 ** -7 if dtype == BF16 else 1e-6
    for cot in (None, g):
        got = SX.softmax_xent_bwd(p, y, cot).float()
        want = _kernel_emulation(p, y, cot).float()
        assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("b,v", [(8, 10), (64, 10), (6, 5)])
def test_xent_fn_under_a_cotangent_matches_jax(b, v):
    """``XentFn`` on both lowerings (the hopper one takes the wrappers'
    plain versions on the CPU, the cotangent passed into
    ``softmax_xent_bwd``) under g = 1.7, labels -1 and V included, against
    ``jax.vjp`` of JAX's loss on its Pallas backend (interpret mode), whose
    kernel gives such rows ``p / B`` as the port does."""
    rng = np.random.default_rng(b * v)
    logits = (3 * rng.standard_normal((b, v))).astype(np.float32)
    y = rng.integers(0, v, b).astype(np.int64)
    y[0], y[1] = -1, v
    with jax_use_backend("pallas"):
        _, vjp = jax.vjp(lambda lg: jax_ops.softmax_xent_loss(
            lg, jnp.asarray(y)), jnp.asarray(logits))
        (want,) = vjp(jnp.float32(1.7))
    want = np.asarray(want)
    for hopper in (True, False):
        lg = torch.from_numpy(logits.copy()).requires_grad_(True)
        loss = ops.XentFn.apply(lg, torch.from_numpy(y), hopper)
        (g,) = torch.autograd.grad(loss, [lg], torch.tensor(1.7))
        err = np.abs(g.numpy() - want).max()
        assert err <= GRAD_REL * np.abs(want).max(), (hopper, err)


def test_backward_routes_from_the_crossing(monkeypatch):
    """The probs as each boundary mode hands them to the backward (a CPU
    walk of a LeNet-MNIST train step at batch 64, the Functions' hopper
    branch forced): exactly the forward wrapper's output in all three
    modes, no crossing between them, and the cotangent an f32 scalar.  On
    the card that output is a fresh contiguous (B, V) on both forward
    routes (``torch.empty`` in ``_rows`` and on "rows"), which the spy
    gives it here (the CPU's plain version keeps a column-major logits'
    layout), so the backward takes "rows" in each mode: what
    chip_smoke.py's ``caffe_xent_bwd_routes`` asserts on the card."""
    from repro_torch.caffe import Net, Solver
    from repro_torch.caffe import lenet_mnist, lenet_mnist_solver
    from repro_torch.data.synthetic import mnist_like

    spec = lenet_mnist()
    params = Solver(Net(spec), lenet_mnist_solver()).init(
        torch.Generator().manual_seed(0), device="cpu")["params"]
    data, label = mnist_like(64, seed=0, device="cpu").batch(0)
    made, seen = [], []
    fwd, bwd = SX.softmax_xent, SX.softmax_xent_bwd

    def fwd_spy(logits, labels):
        loss, probs = fwd(logits, labels)
        made.append(torch.empty((64, 10)).copy_(probs))
        return loss, made[-1]

    def bwd_spy(probs, labels, g=None):
        assert probs is made[-1]
        assert g is not None and g.dtype == F32 and g.numel() == 1
        seen.append(_plan(probs)[0])
        return bwd(probs, labels, g)
    monkeypatch.setattr(SX, "softmax_xent", fwd_spy)
    monkeypatch.setattr(SX, "softmax_xent_bwd", bwd_spy)
    monkeypatch.setattr(ops, "use_hopper", lambda t: True)
    for boundary in (None, "transfer", "transfer+transpose"):
        seen.clear()
        leaves = {n: {k: v.detach().requires_grad_(True)
                      for k, v in p.items()} for n, p in params.items()}
        Net(spec, boundary=boundary).forward_loss(leaves, data,
                                                  label).backward()
        assert seen == ["rows"], boundary
