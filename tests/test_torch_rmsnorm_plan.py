"""The RMSNorm backward's routes on the CPU, and a plain emulation of what
its two kernels compute, against the JAX package.

``kernels/rmsnorm.py`` picks the route in pure Python, and the card's
kernels follow it: ``bwd_plan`` (rows that are whole 16-byte vectors with
16-byte aligned bases and row strides -> the "vec" kernel of
``csrc/rmsnorm.cu``; every other row -> the "scalar" kernel) and
``bwd_rows`` (the vec kernel's warps a row, warps a block and rows a
block, from shapes).  Held here: the routes and limits; row partitions
that give every row to exactly one group of one block; the C signatures
of the backward's launchers against their ctypes ones; and an emulation
in plain PyTorch of each route's arithmetic and summation order (the vec
kernel's rows, dy * xhat added per group in row order, the groups in
group order; the scalar kernel's blocks of 4 rows; then the dw sum's
slices of partial rows, each in row order, added in slice order) against
``rmsnorm_bwd_pallas`` in interpret mode on the same numpy inputs: dx and
dw within one bf16 ulp of their largest magnitude in bf16 (both sides
round one f32 value, summed in another order), within 1e-5 of it in f32
(summation order over up to 2048 terms), the tolerances of
``chip_smoke.py``'s phase 3.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clear_tuning  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_bwd_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rmsnorm as R  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
TOL = {BF16: 2 ** -7, F32: 1e-5}


# (dtype, width, aligned, route): whole 16-byte rows, aligned, on vec up
# to MAX_BWD_WIDTH; a ragged vector, an unaligned operand or a wider row on
# scalar
@pytest.mark.parametrize("dtype,d,aligned,route", [
    (BF16, 2048, True, "vec"), (BF16, 5120, True, "vec"),
    (BF16, 64, True, "vec"), (BF16, 80, True, "vec"), (F32, 2048, True, "vec"),
    (F32, 4, True, "vec"), (BF16, R.MAX_BWD_WIDTH, True, "vec"),
    (F32, R.MAX_BWD_WIDTH, True, "vec"),
    (BF16, 2048, False, "scalar"), (BF16, 100, True, "scalar"),
    (F32, 2050, True, "scalar"), (BF16, 4, True, "scalar"),
    (BF16, R.MAX_BWD_WIDTH + 8, True, "scalar")])
def test_bwd_plan(dtype, d, aligned, route):
    assert R.bwd_plan(dtype, d, aligned) == route


def test_bwd_limits():
    # one group's f32 dw row fills the vec block's shared memory; the
    # scalar kernel keeps its 48 KB limit
    assert R.MAX_BWD_WIDTH * 4 <= R.BWD_SMEM < (R.MAX_BWD_WIDTH + 1) * 4
    assert R.MAX_BWD_WIDTH > R.SCALAR_MAX_WIDTH == 12280
    assert R.MAX_BWD_WIDTH % 8 == 0


def test_bwd_route_of_strided_rows():
    """What the wrapper hands the planner: a row stride of 8 bf16 (4 f32)
    elements keeps the vec route, one of 4 bf16 does not."""
    x = torch.zeros((16, 2056), dtype=BF16)[:, :2048]
    odd = torch.zeros((16, 2052), dtype=BF16)[:, :2048]
    w = torch.zeros(2048, dtype=BF16)
    aligned = _build.aligned16
    assert R.bwd_plan(BF16, 2048, aligned(x, x, w, elems=8)) == "vec"
    assert R.bwd_plan(BF16, 2048, aligned(odd, x, w, elems=8)) == "scalar"
    xf = torch.zeros((16, 2052), dtype=F32)[:, :2048]
    assert R.bwd_plan(F32, 2048, aligned(xf, xf, w.float(), elems=4)) == "vec"


# (dtype, rows, width): a training step's 512 rows of 2048 and 5120, the
# smoke widths, ragged row counts, rows wider than 8 warps' registers
@pytest.mark.parametrize("dtype,rows,d", [
    (BF16, 512, 2048), (BF16, 512, 5120), (F32, 512, 2048), (BF16, 7, 64),
    (BF16, 130, 80), (F32, 130, 2048), (BF16, 1, 8), (F32, 4096, 2560),
    (BF16, 64, 20480), (F32, 3, R.MAX_BWD_WIDTH)])
def test_bwd_rows_give_every_row_to_one_group(dtype, rows, d):
    group, warps, rpb, nb = R.bwd_rows(dtype, rows, d)
    groups = warps // group
    assert group in (1, 2, 4, 8) and warps % group == 0 and warps <= 8
    assert groups * R.dw_row(dtype, d) * 4 <= R.BWD_SMEM
    # the fewest warps whose registers hold the row, up to BWD_GROUP
    per_warp = 32 * R.BWD_VECS * (16 // torch.tensor([], dtype=dtype)
                                  .element_size())
    assert group == R.BWD_GROUP or group * per_warp >= d
    assert group == 1 or (group // 2) * per_warp < d
    walked = [r for i in range(nb) for k in range(groups)
              for r in range(i * rpb + k, min(rows, (i + 1) * rpb), groups)]
    assert sorted(walked) == list(range(rows))
    assert (nb - 1) * rpb < rows <= nb * rpb   # no empty block
    assert nb <= max(R.BWD_BLOCKS, -(-rows // groups))


def test_bwd_rows_at_the_training_shape():
    # qwen2.5-3b's 512 rows of 2048: two warps a bf16 row in blocks of 8
    # warps, 4 rows a block in 128 blocks; four warps an f32 row and eight
    # a 5120 bf16 one, 2 rows a block in 256 blocks (the plans the sweep
    # of chip_smoke.py's phase 3 put first)
    assert R.bwd_rows(BF16, 512, 2048) == (2, 8, 4, 128)
    assert R.bwd_rows(F32, 512, 2048) == (4, 8, 2, 256)
    assert R.bwd_rows(BF16, 512, 5120) == (8, 8, 2, 256)


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


@pytest.mark.parametrize("name", ["repro_rmsnorm_bwd",
                                  "repro_rmsnorm_bwd_vec"])
def test_bwd_launchers_match_their_ctypes_signatures(name):
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = []
    for p in params.split(","):
        p = " ".join(p.split())
        kinds.append(_CTYPES["void*" if "*" in p else
                             " ".join(p.split()[:-1])])
    assert kinds == _build._SIGNATURES[name]


def _dw_sum(parts, dtype):
    """The dw sum kernel: ``SUM_SLICES`` slices of the partial rows, each
    added in row order from 0, then the slices added in slice order."""
    nb, d = len(parts), parts[0].shape[0]
    per = -(-nb // R.SUM_SLICES)
    slices = []
    for k in range(R.SUM_SLICES):
        s = torch.zeros(d)
        for b in range(k * per, min(nb, (k + 1) * per)):
            s = s + parts[b]
        slices.append(s)
    t = slices[0]
    for s in slices[1:]:
        t = t + s
    return t.to(dtype)


def _vec_emulation(x, w, dy, eps, plan):
    """The vec kernel: per row f32 sums of x^2 and (dy * w) * x, inv =
    1 / sqrt(mean + eps), mean(dxhat * xhat) = inv * sum / D, dx rounded
    to x's dtype; dy * xhat added per group (group k of block i walks rows
    i * rpb + k, + groups, ...) from 0, the groups' rows added in group
    order, then ``_dw_sum``."""
    group, warps, rpb, nb = plan
    groups = warps // group
    rows, d = x.shape
    xf, wf, gf = x.float(), w.float(), dy.float()
    ss, sdx = (xf * xf).sum(-1), (gf * wf * xf).sum(-1)
    inv = 1.0 / torch.sqrt(ss / d + eps)
    mean = inv * sdx / d
    xh = xf * inv[:, None]
    dx = (inv[:, None] * (gf * wf - xh * mean[:, None])).to(x.dtype)
    contrib = gf * xh
    parts = []
    for i in range(nb):
        acc = []
        for k in range(groups):
            a = torch.zeros(d)
            for r in range(i * rpb + k, min(rows, (i + 1) * rpb), groups):
                a = a + contrib[r]
            acc.append(a)
        t = acc[0]
        for a in acc[1:]:
            t = t + a
        parts.append(t)
    return dx, _dw_sum(parts, w.dtype)


def _scalar_emulation(x, w, dy, eps):
    """The scalar kernel (JAX's order: xhat first, mean(dxhat * xhat)),
    blocks of ``SCALAR_ROWS`` rows added in row order, then
    ``_dw_sum``."""
    rows, d = x.shape
    xf, wf, gf = x.float(), w.float(), dy.float()
    inv = 1.0 / torch.sqrt((xf * xf).sum(-1) / d + eps)
    xh = xf * inv[:, None]
    mean = (gf * wf * xh).sum(-1) / d
    dx = (inv[:, None] * (gf * wf - xh * mean[:, None])).to(x.dtype)
    contrib = gf * xh
    parts = []
    for r0 in range(0, rows, R.SCALAR_ROWS):
        a = torch.zeros(d)
        for r in range(r0, min(rows, r0 + R.SCALAR_ROWS)):
            a = a + contrib[r]
        parts.append(a)
    return dx, _dw_sum(parts, w.dtype)


def _inputs(dtype, rows, d, pad, seed):
    """x and dy as (rows, d) views of (rows, d + pad) arrays (a row stride
    of d + pad), w (d,), made from a seed with numpy and rounded to
    ``dtype``; and their numpy values for JAX."""
    rng = np.random.default_rng(seed)
    xw = torch.from_numpy(rng.standard_normal((rows, d + pad)).astype(
        np.float32)).to(dtype)
    gw = torch.from_numpy(rng.standard_normal((rows, d + pad)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(
        np.float32)).to(dtype)
    x, dy = xw[:, :d], gw[:, :d]
    return x, w, dy


def _jax(x, w, dy, dtype):
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    kx, kw = rmsnorm_bwd_pallas(
        *(jnp.asarray(t.float().numpy()).astype(jdt) for t in (x, w, dy)),
        interpret=True)
    return (np.asarray(kx.astype(jnp.float32)),
            np.asarray(kw.astype(jnp.float32)))


def _close(got, want, tol):
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# (dtype, rows, width, row pad, forced plan (group, warps, rpb)): the smoke
# widths and a training row in both dtypes, ragged last blocks (7, 130
# rows), row strides past the width, and forced plans whose groups walk
# several rows (and a 3-row ragged last block of 1-warp groups)
VEC_CASES = [(BF16, 7, 64, 0, None), (BF16, 130, 80, 8, None),
             (BF16, 130, 2048, 0, None), (F32, 7, 64, 4, None),
             (F32, 130, 80, 0, None), (F32, 130, 2048, 4, None),
             (BF16, 130, 2048, 16, (2, 8, 12)), (F32, 7, 80, 0, (1, 4, 5)),
             (BF16, 300, 64, 0, (1, 8, 40))]


@pytest.mark.parametrize("dtype,rows,d,pad,forced", VEC_CASES)
def test_vec_emulation_matches_jax(dtype, rows, d, pad, forced):
    clear_tuning()
    x, w, dy = _inputs(dtype, rows, d, pad, rows + d + pad)
    assert R.bwd_plan(dtype, d, _build.aligned16(
        x, dy, w, elems=16 // x.element_size())) == "vec"
    if forced is None:
        plan = R.bwd_rows(dtype, rows, d)
    else:
        g, wp, rpb = forced
        plan = (g, wp, rpb, -(-rows // rpb))
    dx, dw = _vec_emulation(x, w, dy, 1e-6, plan)
    kx, kw = _jax(x, w, dy, dtype)
    assert dx.dtype == dtype and dw.dtype == dtype
    _close(dx, kx, TOL[dtype])
    _close(dw, kw, TOL[dtype])


# (dtype, rows, width, row pad): rows the vec kernel does not take (a
# ragged vector, an odd row stride)
SCALAR_CASES = [(BF16, 7, 100, 0), (F32, 130, 66, 0), (BF16, 130, 64, 4)]


@pytest.mark.parametrize("dtype,rows,d,pad", SCALAR_CASES)
def test_scalar_emulation_matches_jax(dtype, rows, d, pad):
    clear_tuning()
    x, w, dy = _inputs(dtype, rows, d, pad, rows * 3 + d + pad)
    assert R.bwd_plan(dtype, d, _build.aligned16(
        x, dy, w, elems=16 // x.element_size())) == "scalar"
    dx, dw = _scalar_emulation(x, w, dy, 1e-6)
    kx, kw = _jax(x, w, dy, dtype)
    _close(dx, kx, TOL[dtype])
    _close(dw, kw, TOL[dtype])


def test_cpu_tensors_take_the_plain_version():
    x, w, dy = _inputs(F32, 7, 64, 0, 1)
    before = dict(R.rmsnorm_bwd.routes), R.rmsnorm_bwd.launches
    dx, dw = R.rmsnorm_bwd(x, w, dy)
    rx, rw = R.rmsnorm_bwd_ref(x, w, dy)
    assert torch.equal(dx, rx) and torch.equal(dw, rw)
    assert (dict(R.rmsnorm_bwd.routes), R.rmsnorm_bwd.launches) == before
