"""The RMSNorm forward's routes on the CPU, and a plain emulation of what
its vector kernel computes, against the JAX package.

``kernels/rmsnorm.py`` picks the route in pure Python, and the card's
kernels follow it: ``fwd_plan`` (rows that are whole 16-byte vectors, at
most ``FWD_MAX_VECS`` of them, with 16-byte aligned bases and row stride
-> the "vec" kernel of ``csrc/rmsnorm.cu``; every other row -> the first
port's "scalar" kernel) and ``fwd_rows`` (the vec kernel's warps a row,
warps a block and blocks, from shapes).  Held here: the routes at every
LM path width in both dtypes and at the edges; row and column partitions
that give every row to exactly one group and every 16-byte vector of a
row to exactly one lane; the C signatures of both forward launchers
against their ctypes ones; and an emulation in plain PyTorch of the vec
kernel's order (each lane's f32 sum of squares over its vectors, the
warp's xor butterfly, the group's warps added in order, inv = 1 /
sqrt(mean + eps), x * inv rounded to the storage dtype, times w rounded
once) against ``rmsnorm_pallas`` in interpret mode on the same numpy
inputs, within ``chip_smoke.py``'s phase-3 ``TOL``: one bf16 ulp of the
largest magnitude in bf16 (both sides round x * inv and the product
once; a sum in another order moves inv by a few f32 ulps, which can flip
a rounding), 1e-6 of it in f32 (the sum's order and 1 / sqrt against
rsqrt: a few f32 ulps of inv).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clear_tuning  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rmsnorm as R  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
TOL = {BF16: 2 ** -7, F32: 1e-6}
# the widest rows the vec kernel takes: FWD_MAX_VECS 16-byte vectors
WIDEST = {BF16: R.FWD_MAX_VECS * 8, F32: R.FWD_MAX_VECS * 4}


def _elems(dtype):
    return 16 // torch.tensor([], dtype=dtype).element_size()


# every LM path width (qwen2.5-3b 2048, mamba2/zamba2 2560 and 5120,
# mixtral 4096) and the smoke widths in both dtypes on vec; a ragged
# vector, an unaligned operand, a row past the registers on scalar
@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("d,aligned,route", [
    (2048, True, "vec"), (2560, True, "vec"), (4096, True, "vec"),
    (5120, True, "vec"), (64, True, "vec"), (80, True, "vec"),
    (2048, False, "scalar"), (2050, True, "scalar"), (2, True, "scalar"),
    ("widest", True, "vec"), ("next", True, "scalar")])
def test_fwd_plan(dtype, d, aligned, route):
    if d == "widest":
        d = WIDEST[dtype]
    elif d == "next":
        d = WIDEST[dtype] + _elems(dtype)
    assert R.fwd_plan(dtype, d, aligned) == route


def test_fwd_route_of_views():
    """What the wrapper hands the planner: a row stride of whole vectors
    keeps vec; an odd row stride or a base offset by one element does
    not."""
    w = torch.zeros(2048, dtype=BF16)
    out = torch.empty((4, 2048), dtype=BF16)

    def route(x):
        return R.fwd_plan(x.dtype, x.shape[-1], _build.aligned16(
            x, w.to(x.dtype), out.to(x.dtype), elems=_elems(x.dtype)))

    assert route(torch.zeros((4, 2048), dtype=BF16)) == "vec"
    assert route(torch.zeros((4, 2064), dtype=BF16)[:, :2048]) == "vec"
    assert route(torch.zeros((4, 2052), dtype=BF16)[:, :2048]) == "scalar"
    assert route(torch.zeros(4 * 2048 + 1, dtype=BF16)[1:].view(
        4, 2048)) == "scalar"
    assert route(torch.zeros((4, 2052), dtype=F32)[:, :2048]) == "vec"


def _instance(dtype, d, group):
    """The kernel instance ``csrc/rmsnorm.cu:fwd_vec`` launches: V, the
    vectors a lane, the least of 1, 2, 4, 8 that holds the row."""
    per_lane = -(-(d // _elems(dtype)) // (32 * group))
    return next(v for v in (1, 2, 4, R.FWD_VECS) if v >= per_lane)


def _walk(dtype, rows, d, plan):
    """How many times the vec kernel reaches each (row, 16-byte vector):
    block i's group k owns row i * groups + k (if below rows); its lane gl
    holds vectors gl + v * 32 * group, v < V (``_instance``), below the
    row's."""
    group, warps, blocks = plan
    groups, nvec = warps // group, d // _elems(dtype)
    seen = np.zeros((rows, nvec), np.int64)
    for i in range(blocks):
        for k in range(groups):
            r = i * groups + k
            if r >= rows:
                continue
            for v in range(_instance(dtype, d, group)):
                j = v * 32 * group + np.arange(32 * group)
                np.add.at(seen[r], j[j < nvec], 1)
    return seen


# (dtype, rows, width): the path shapes (decode 4, prefill 64, train 512
# rows), the smoke widths, ragged row counts, the widest rows
@pytest.mark.parametrize("dtype,rows,d", [
    (BF16, 4, 2048), (BF16, 4, 5120), (BF16, 64, 2560), (BF16, 512, 2048),
    (F32, 4, 5120), (F32, 64, 4096), (F32, 512, 2048), (BF16, 7, 64),
    (F32, 130, 80), (BF16, 1, 8), (BF16, 3, WIDEST[BF16]),
    (F32, 5, WIDEST[F32]), (BF16, 1000, 2048)])
def test_fwd_rows_give_every_row_and_vector_to_one_lane(dtype, rows, d):
    assert R.fwd_plan(dtype, d, True) == "vec"
    plan = R.fwd_rows(dtype, rows, d)
    group, warps, blocks = plan
    groups = warps // group
    assert group in (1, 2, 4, 8) and warps % group == 0 and warps <= 8
    # the row fits the group's registers, as csrc/rmsnorm.cu checks
    assert d // _elems(dtype) <= 32 * group * R.FWD_VECS
    assert (blocks - 1) * groups < rows <= blocks * groups  # no empty block
    assert (_walk(dtype, rows, d, plan) == 1).all()


def test_fwd_rows_at_the_path_shapes():
    # every path shape's rows spread over 8 warps each, one block a row:
    # one vector a lane at 2048 bf16, two or three at 5120 (the plans the
    # sweep of chip_smoke.py's phase 3 put first or tied)
    for rows in (4, 64, 512):
        assert R.fwd_rows(BF16, rows, 2048) == (8, 8, rows)
        assert R.fwd_rows(F32, rows, 2048) == (8, 8, rows)
    assert R.fwd_rows(BF16, 4, 5120) == (8, 8, 4)
    assert R.fwd_rows(BF16, 64, 2560) == (8, 8, 64)
    # f32 5120 takes 5 vectors a lane on 8 warps (the 8-vector instance)
    assert R.fwd_rows(F32, 4, 5120) == (8, 8, 4)
    # past FWD_TARGET warps a call, rows share a block
    assert R.fwd_rows(BF16, 1000, 2048) == (4, 8, 500)


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


@pytest.mark.parametrize("name", ["repro_rmsnorm", "repro_rmsnorm_vec"])
def test_fwd_launchers_match_their_ctypes_signatures(name):
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = []
    for p in params.split(","):
        p = " ".join(p.split())
        kinds.append(_CTYPES["void*" if "*" in p else
                             " ".join(p.split()[:-1])])
    assert kinds == _build._SIGNATURES[name]


def _vec_emulation(x, w, eps, plan):
    """The vec kernel's arithmetic in its order: lane gl of a row's group
    adds x^2 over its vectors gl + v * 32 * group (v < V in order, each
    vector's elements in order) in f32; each warp's 32 partials by the xor
    butterfly (offsets 16, 8, 4, 2, 1); the group's warps in warp order;
    inv = 1 / sqrt(sum / D + eps); out = round(round(x * inv) * w)."""
    group = plan[0]
    rows, d = x.shape
    e = _elems(x.dtype)
    nvec, gth = d // e, 32 * group
    xv = x.float().reshape(rows, nvec, e)
    part = torch.zeros((rows, gth))
    for v in range(_instance(x.dtype, d, group)):
        j = v * gth + torch.arange(gth)
        lanes = j < nvec
        for k in range(e):
            sq = xv[:, j[lanes], k]
            part[:, lanes] = part[:, lanes] + sq * sq
    part = part.reshape(rows, group, 32)
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, :, idx ^ o]
    ss = part[:, 0, 0]
    for i in range(1, group):
        ss = ss + part[:, i, 0]
    inv = 1.0 / torch.sqrt(ss / d + eps)
    y = (x.float() * inv[:, None]).to(x.dtype).float() * w.float()
    return y.to(x.dtype)


def _inputs(dtype, rows, d, pad, seed):
    """x as a (rows, d) view of a (rows, d + pad) array and w (d,), made
    from a seed with numpy and rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    xw = torch.from_numpy(rng.standard_normal((rows, d + pad)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(
        np.float32)).to(dtype)
    return xw[:, :d], w


# (dtype, rows, width, row pad, forced plan (group, warps)): the smoke
# widths and a serving width in both dtypes, ragged blocks, row strides
# past the width, and plans forced onto 1, 2 and 4 warps a row
VEC_CASES = [(BF16, 4, 2048, 0, None), (BF16, 7, 80, 8, None),
             (BF16, 64, 256, 0, (2, 8)), (F32, 5, 2560, 4, None),
             (F32, 130, 64, 0, None), (F32, 9, 512, 0, (1, 4)),
             (BF16, 3, 1024, 0, (4, 4))]


@pytest.mark.parametrize("dtype,rows,d,pad,forced", VEC_CASES)
def test_vec_emulation_matches_jax(dtype, rows, d, pad, forced):
    clear_tuning()
    x, w = _inputs(dtype, rows, d, pad, rows + d + pad)
    out = torch.empty((rows, d), dtype=dtype)
    assert R.fwd_plan(dtype, d, _build.aligned16(
        x, w, out, elems=_elems(dtype))) == "vec"
    if forced is None:
        plan = R.fwd_rows(dtype, rows, d)
    else:
        group, warps = forced
        plan = (group, warps, -(-rows // (warps // group)))
    assert d // _elems(dtype) <= 32 * plan[0] * R.FWD_VECS
    got = _vec_emulation(x, w, 1e-6, plan)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    want = np.asarray(rmsnorm_pallas(
        *(jnp.asarray(t.float().numpy()).astype(jdt) for t in (x, w)),
        interpret=True).astype(jnp.float32))
    assert got.dtype == dtype
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()
    # and the plain version the card holds the kernel to
    ref = R.rmsnorm_ref(x, w).float().numpy()
    assert np.abs(got - ref).max() <= TOL[dtype] * np.abs(ref).max()


def test_cpu_tensors_take_the_plain_version():
    x, w = _inputs(F32, 7, 64, 0, 1)
    before = dict(R.rmsnorm.routes), R.rmsnorm.launches
    assert torch.equal(R.rmsnorm(x, w), R.rmsnorm_ref(x, w))
    assert (dict(R.rmsnorm.routes), R.rmsnorm.launches) == before
