"""The SSD scan's routes on the CPU, and plain emulations of what its
"step" and "split" kernels compute, against the JAX package.

``kernels/mamba_scan.py`` picks the route in pure Python, and the card's
kernels follow it: ``ssd_plan`` (S = 1 -> "step", S > 1 -> "split", where
B's and C's bases and row strides are whole 16-byte vectors and N is one
``csrc/ssd_scan.cu`` instantiates; else the first port's "block" kernel),
``ssd_step`` (lanes a state row, rows a lane group holds, warps a block)
and ``ssd_split`` (state rows a block).  Held here: the routes and
geometry of every path shape (mamba2-2.7b and zamba2-2.7b decode and C =
16 prefill at B = 4, the 2 x 256 forward at chunk 128, over the in_proj
output's column slices, bf16 and f32) and that their grids reach one
block an SM, by arithmetic; the alignment and shared-memory edges; a walk
of both grids that gives every state row to one lane group of one block,
whole; the C signatures of the new launchers and the kernels' constants
against the planner's; and emulations in plain PyTorch of both routes'
arithmetic order (the step kernel's lane partials and xor tree; the split
kernel's warp-scan cumsum, C.B in lane partials folded across 8 lanes,
lane partials of y and
their fold, ordered state update) against ``ssd_scan_pallas`` in
interpret mode (2e-4, as ``tests/test_torch_ssm.py`` holds it) and the
plain version (1e-5), with a row whose dt is 0 keeping its state bit for
bit.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba_scan import ssd_scan_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mamba_scan as M  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
TOL = dict(atol=1e-5, rtol=1e-5)
PALLAS_TOL = dict(atol=2e-4, rtol=2e-4)


def _slices(b, s, h, n, d_inner, dtype=F32):
    """B and C as the model passes them: column slices of an in_proj output
    of row width 2 d_inner + 2 N + H, read in place."""
    zx = torch.zeros((b, s, 2 * d_inner + 2 * n + h), dtype=dtype)
    bm = zx[..., 2 * d_inner: 2 * d_inner + n].reshape(b, s, 1, n)
    cm = zx[..., 2 * d_inner + n: 2 * d_inner + 2 * n].reshape(b, s, 1, n)
    return bm, cm


def _route(x_shape, bm, cm, n, dtype, aligned=True):
    strides = (bm.stride(0), bm.stride(1), cm.stride(0), cm.stride(1))
    return M.ssd_plan(dtype, x_shape, strides, n, aligned)


# (arch, N, x shape (B, S, H, P), chunk): the serving paths' decode and
# C = 16 prefill at B = 4, and the --check / training forward (two chunks
# of 128); d_inner 5120 for both archs
PATHS = [("mamba2", 128, (4, 1, 80, 64), 128),
         ("zamba2", 64, (4, 1, 80, 64), 128),
         ("mamba2", 128, (4, 16, 80, 64), 128),
         ("zamba2", 64, (4, 16, 80, 64), 128),
         ("mamba2", 128, (2, 256, 80, 64), 128)]
WANT = {(128, 1): M.Step(32, 1, 2, 2, 5120),
        (64, 1): M.Step(8, 2, 2, 2, 1280),
        (128, 16): M.Split(16, 2, 16, 4, 256, 20032, 1280),
        (64, 16): M.Split(8, 2, 16, 4, 128, 11328, 1280),
        (128, 256): M.Split(16, 2, 32, 2, 512, 104512, 320)}


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("arch,n,shape,chunk", PATHS)
def test_plan_path_shapes(dtype, arch, n, shape, chunk):
    b, s, h, p = shape
    bm, cm = _slices(b, s, h, n, 5120, dtype)
    route = _route(shape, bm, cm, n, dtype)
    assert route == ("step" if s == 1 else "split")
    geo = (M.ssd_step(shape, n) if s == 1
           else M.ssd_split(shape, n, min(chunk, s)))
    assert geo == WANT[(n, s)]
    # every state row whole in one lane group: N = 4 x lanes x vectors
    assert 4 * geo.lanes * geo.vecs == n and (geo.lanes, geo.vecs) in M.LANES
    # the grid reaches one block an SM, by arithmetic
    assert geo.blocks >= M.SMS
    if s == 1:
        assert geo.blocks * geo.warps * (32 // geo.lanes) * geo.rows \
            >= b * h * p
        assert geo.rows * geo.vecs <= M.STEP_MAX_ROWS
    else:
        assert geo.blocks == b * h * geo.slices
        assert geo.slices * geo.rows >= p > (geo.slices - 1) * geo.rows
        assert geo.threads == 32 * geo.rows // (32 // geo.lanes) \
            <= M.MAX_THREADS
        assert geo.smem <= M.MAX_SMEM


def test_plan_alignment_edges():
    shape, n = (4, 16, 80, 64), 128
    bm, cm = _slices(4, 16, 80, n, 5120, BF16)
    assert _route(shape, bm, cm, n, BF16) == "split"
    # a base off 16 bytes (the wrapper's ``aligned``): "block"
    assert _route(shape, bm, cm, n, BF16, aligned=False) == "block"
    # a row width that breaks the vectors: 10576 + 4 bf16 is 8 bytes off
    bo, co = _slices(4, 16, 84, n, 5120, BF16)
    assert bo.stride(1) % 8 == 4
    assert _route(shape, bo, co, n, BF16) == "block"
    # ... but f32 vectors are 4 elements: the same width is whole
    bo, co = _slices(4, 16, 84, n, 5120, F32)
    assert _route(shape, bo, co, n, F32) == "split"
    # at S = 1 only the batch stride counts: a sequence stride off the
    # vectors is never read
    d = (4, 1, 80, 64)
    assert M.ssd_plan(BF16, d, (10576, 10579, 10576, 10579), n, True) \
        == "step"
    assert M.ssd_plan(BF16, d, (10579, 10579, 10576, 10576), n, True) \
        == "block"
    assert M.ssd_plan(BF16, shape, (16 * 10576, 10579, 16 * 10576, 10576),
                      n, True) == "block"
    # an N no (lanes, vectors) pair makes: "block"
    for bad in (8, 24, 96, 256):
        assert bad not in M.SSD_N
        assert M.ssd_plan(F32, shape, (bad * 16, bad, bad * 16, bad), bad,
                          True) == "block"
    # the smoke archs (P = N = 16, row width 296) take the new routes
    bs, cs = _slices(2, 1, 8, 16, 128, BF16)
    assert _route((2, 1, 8, 16), bs, cs, 16, BF16) == "step"
    bs, cs = _slices(2, 16, 8, 16, 128, BF16)
    assert _route((2, 16, 8, 16), bs, cs, 16, BF16) == "split"


def test_split_shared_memory_edges():
    # the longest chunk fits a block of the most rows at the widest N, and
    # the planner's floor at every N
    for n in M.SSD_N:
        g, _ = M.SPLIT_LANES[n]
        assert M.split_smem(n, M.MAX_CHUNK, 32 // g, g) <= M.MAX_SMEM
        rows = M.MAX_THREADS // 32 * (32 // g)
        assert M.split_smem(n, M.MAX_CHUNK, rows, g) <= M.MAX_SMEM
    # a block past the budget has its rows halved: a hypothetical budget
    # under the 32-row block of the forward
    saved = M.MAX_SMEM
    try:
        M.MAX_SMEM = M.split_smem(128, 128, 32, 16) - 4
        geo = M.ssd_split((2, 256, 80, 64), 128, 128)
        assert geo.rows == 16 and geo.smem <= M.MAX_SMEM
    finally:
        M.MAX_SMEM = saved
    # the recomputation floor: at chunk 128 a block keeps the most rows its
    # 512 threads hold (32 of 16 lanes), at C = 16 the rows halve to 16
    assert M.ssd_split((2, 256, 80, 64), 128, 128).rows == 32
    assert M.ssd_split((4, 16, 80, 64), 128, 16).rows == 16
    # the kernel's launch bounds give each thread SPLIT_REGS registers
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    assert "__launch_bounds__(kMaxThreads, 2)\n    ssd_split_kernel" in src
    assert M.SM_REGS // (2 * M.MAX_THREADS) == M.SPLIT_REGS


@pytest.mark.parametrize("case", [
    ("step", (4, 1, 80, 64), 128), ("step", (4, 1, 80, 64), 64),
    ("step", (3, 1, 5, 16), 16), ("step", (1, 1, 3, 7), 32),
    ("split", (4, 16, 80, 64), 128), ("split", (2, 256, 80, 64), 128),
    ("split", (3, 9, 5, 16), 16), ("split", (2, 40, 3, 20), 32)])
def test_grid_gives_every_row_once_whole(case):
    """Each state row (b, h, p) goes to exactly one lane group of one
    block, and the group's lanes hold its N floats once each; a split
    block's rows belong to one (row, head), so no block reads a row
    another block writes (the in-place state is safe)."""
    route, shape, n = case
    b, s, h, p = shape
    total = b * h * p
    seen = np.zeros(total, np.int64)
    if route == "step":
        g = M.ssd_step(shape, n)
        rg = 32 // g.lanes
        for blk in range(g.blocks):
            for warp in range(g.warps):
                wid = blk * g.warps + warp
                for k in range(g.rows):
                    for grp in range(rg):
                        row = (wid * g.rows + k) * rg + grp
                        if row < total:
                            seen[row] += 1
    else:
        g = M.ssd_split(shape, n, min(128, s))
        rg = 32 // g.lanes
        for blk in range(g.blocks):
            sl, bh = blk % g.slices, blk // g.slices
            p0 = sl * g.rows
            for r in range(g.threads // 32 * rg):
                if r < min(g.rows, p - p0):
                    seen[bh * p + p0 + r] += 1
    assert (seen == 1).all()
    # lane q of a group holds vectors q + lanes * j, j < vecs: each of the
    # row's N / 4 vectors once
    held = sorted(q + g.lanes * j for q in range(g.lanes)
                  for j in range(g.vecs))
    assert held == list(range(n // 4))


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


@pytest.mark.parametrize("name", ["repro_ssd_scan", "repro_ssd_scan_step",
                                  "repro_ssd_scan_split"])
def test_launchers_match_their_ctypes_signatures(name):
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = []
    for prm in params.split(","):
        prm = " ".join(prm.split())
        kinds.append(_CTYPES["void*" if "*" in prm else
                             " ".join(prm.split()[:-1])])
    assert kinds == _build._SIGNATURES[name]


def test_kernel_constants_are_the_planners():
    src = (_build.CSRC / "ssd_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))
    assert const("kStepMaxRows") == M.STEP_MAX_ROWS
    assert const("kTile") == M.SPLIT_TILE
    assert const("kMaxThreads") == M.MAX_THREADS
    lanes = re.search(r"#define REPRO_SSD_LANES\(X\) \\\n(.*)", src).group(1)
    assert tuple((int(a), int(b)) for a, b in
                 re.findall(r"X\((\d+), (\d+)\)", lanes)) == M.LANES
    # split_floats, evaluated, is split_smem / 4; the kernel declares no
    # static shared memory beside it
    body = re.search(r"inline long split_floats\(int N, int L, int PS, "
                     r"int G\) \{(.*?)\n\}", src, re.S).group(1)
    expr = re.search(r"return (.*?);", body, re.S).group(1)
    expr = " ".join(expr.replace("(long)", "").replace("4L", "4").split())
    for n, L, ps, g in ((128, 16, 16, 8), (64, 128, 64, 8), (16, 7, 8, 4)):
        tt = min(L, M.SPLIT_TILE)
        assert eval(expr, {"__builtins__": {}},
                    dict(N=n, L=L, PS=ps, G=g, tt=tt)) * 4 \
            == M.split_smem(n, L, ps, g)
    kernel = re.search(r"ssd_split_kernel\(SplitArgs a\) \{(.*?)\n\}\n",
                       src, re.S).group(1)
    assert kernel.count("__shared__") == 1 and "extern __shared__" in kernel


# ---------------------------------------------------------------------------
# emulations of the two kernels' arithmetic order
# ---------------------------------------------------------------------------

def _lane_order(a, g, v):
    """(..., N) -> (..., G, 4 V): lane q's elements in the order it adds
    them (its vectors q + G j, j < V, each's 4 elements)."""
    return a.reshape(*a.shape[:-1], v, g, 4).transpose(-3, -2).reshape(
        *a.shape[:-1], g, 4 * v)


def _ordered_dot(a, b):
    """Sum over the last axis in order (a multiply-add a term)."""
    acc = torch.zeros(a.shape[:-1])
    for i in range(a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def _xor_tree(v, g):
    """The group's xor-shuffle sum (``group_sum``) of lane values (..., G):
    lane 0's result, which every lane shares."""
    o = g // 2
    while o:
        v = v + v[..., torch.arange(g) ^ o]
        o //= 2
    return v[..., 0]


def _step_emulation(x, dt, A, Bm, Cm, h0, g, v):
    """The step kernel: per row, C.B and C.h as lane partials in the
    lane's order and an xor tree; y = (C.B dt) x + e (C.h), the new state
    e h + x (B dt)."""
    b, _, h, p = x.shape
    xf, d = x.float()[:, 0], dt.float()[:, 0]                 # (b,h,p), (b,h)
    bv, cv = Bm.float()[:, 0, 0], Cm.float()[:, 0, 0]         # (b, n)
    hs = h0.float() if h0 is not None else \
        torch.zeros((b, h, p, bv.shape[-1]))
    cb = _xor_tree(_ordered_dot(_lane_order(cv, g, v),
                                _lane_order(bv, g, v)), g)     # (b,)
    ch = _xor_tree(_ordered_dot(_lane_order(cv, g, v)[:, None, None],
                                _lane_order(hs, g, v)), g)     # (b,h,p)
    e = torch.exp(d * A.float())                               # (b,h)
    y = (cb[:, None, None] * d[..., None]) * xf + e[..., None] * ch
    st = e[..., None, None] * hs + xf[..., None] * (
        bv[:, None, None, :] * d[..., None, None])
    return y[:, None].to(x.dtype), st


def _warp_scan(terms):
    """The split kernel's cumsum: inclusive Hillis-Steele scans of 32
    terms (v += v[l - o] for o = 1, 2, 4, 8, 16), each plus the carry."""
    out, carry = [], torch.zeros(terms.shape[:-1])
    for u0 in range(0, terms.shape[-1], 32):
        v = terms[..., u0:u0 + 32]
        v = torch.nn.functional.pad(v, (0, 32 - v.shape[-1]))
        for o in (1, 2, 4, 8, 16):
            v = torch.cat([v[..., :o], v[..., o:] + v[..., :-o]], -1)
        v = v + carry[..., None]
        out.append(v)
        carry = v[..., 31]
    return torch.cat(out, -1)[..., :terms.shape[-1]]


def _fold(part, g):
    """The split kernel's ``fold`` of the lanes' C partial values (..., G,
    C): at each offset the lanes with that bit keep the upper half and
    add the partner's upper half, the others the lower; once a lane holds
    one value it adds its partner's.  Returns the sums (..., C) by
    position."""
    lanes = torch.arange(g)
    base = torch.zeros(g, dtype=torch.long)
    c, o = part.shape[-1], g // 2
    out = torch.empty(*part.shape[:-2], c)
    while o:
        if c == 1:
            part = part + part[..., lanes ^ o, :]
        else:
            c //= 2
            up = (lanes & o) != 0
            lo, hi = part[..., :c], part[..., c:2 * c]
            keep = torch.where(up[:, None], hi, lo)
            send = torch.where(up[:, None], lo, hi)
            part = keep + send[..., lanes ^ o, :]
            base = base + up.long() * c
        o //= 2
    for q in range(g):
        out[..., base[q]:base[q] + c] = part[..., q, :]
    return out


def _cb_dots(cc, bc):
    """C_t . B_u for every (t, u) of a chunk as the split kernel sums them:
    a 4 x 4 block of pairs a group of 8 lanes, lane q8 taking the 16-byte
    vectors j = q8 (mod 8) in order (their 4 elements in order), the 16
    pairs then folded across the 8 lanes."""
    b, ln, n = cc.shape
    pad = (-ln) % 4
    cp = torch.nn.functional.pad(cc, (0, 0, 0, pad))
    bp = torch.nn.functional.pad(bc, (0, 0, 0, pad))
    m = cp.shape[1] // 4
    part = torch.zeros((b, m, m, 8, 16))
    for q8 in range(8):
        for j in range(q8, n // 4, 8):
            for c in range(4):
                ct = cp[:, :, 4 * j + c].reshape(b, m, 1, 4, 1)
                bu = bp[:, :, 4 * j + c].reshape(b, 1, m, 1, 4)
                part[..., q8, :] = part[..., q8, :] + (ct * bu).reshape(
                    b, m, m, 16)
    dots = _fold(part, 8).reshape(b, m, m, 4, 4)
    return dots.permute(0, 1, 3, 2, 4).reshape(b, 4 * m, 4 * m)[
        :, :ln, :ln]


def _split_emulation(x, dt, A, Bm, Cm, h0, chunk, g, v):
    """The split kernel, every row of every block at once (a block's rows
    compute as they would in any other block): per chunk the warp-scan
    cumsum, exp(cum_L - cum) dt, the intra-chunk matrix, per tile of
    ``SPLIT_TILE`` positions each lane's partial y (its n's
    of exp(cum_t) C_t.h, its u's = q mod G of att x) folded across the
    group, then B scaled by w and the ordered state update.  The C.B
    dots are ``_cb_dots``'."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    xf, d = x.float(), dt.float()
    bf, cf = Bm.float()[:, :, 0], Cm.float()[:, :, 0]          # (b, s, n)
    st = h0.float().clone() if h0 is not None else \
        torch.zeros((b, h, p, n))
    y = torch.empty((b, s, h, p))
    L = min(chunk, s)
    for t0 in range(0, s, L):
        ln = min(L, s - t0)
        dts = d[:, t0:t0 + ln].transpose(1, 2)                 # (b, h, ln)
        cum = _warp_scan(dts * A.float()[None, :, None])
        w = torch.exp(cum[..., -1:] - cum) * dts
        ecum = torch.exp(cum)
        bc, cc = bf[:, t0:t0 + ln], cf[:, t0:t0 + ln]          # (b, ln, n)
        dot = _cb_dots(cc, bc)
        tri = torch.tril(torch.ones(ln, ln, dtype=torch.bool))
        dec = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :],
                                    float("-inf")))        # (b, h, t, u)
        att = torch.where(tri, dot[:, None] * dec * dts[..., None, :], 0.0)
        xc = xf[:, t0:t0 + ln].permute(0, 2, 3, 1)             # (b,h,p,ln)
        sl = _lane_order(st, g, v)                             # (b,h,p,G,4V)
        tile = M.SPLIT_TILE
        for r0 in range(0, ln, tile):
            nr = min(tile, ln - r0)
            part = torch.zeros((b, h, p, g, tile))
            for i in range(nr):
                t = r0 + i
                ci = _lane_order(cc[:, t], g, v)[:, None, None]  # (b,1,1,G,4V)
                cpart = _ordered_dot(ci.expand_as(sl), sl)      # (b,h,p,G)
                ipart = torch.zeros((b, h, p, g))
                for q in range(g):
                    for u in range(q, t + 1, g):
                        ipart[..., q] = ipart[..., q] + \
                            att[:, :, t, u][..., None] * xc[..., u]
                part[..., i] = ecum[:, :, t][..., None, None] * cpart + ipart
            y[:, t0 + r0:t0 + r0 + nr] = _fold(part, g)[..., :nr].permute(
                0, 3, 1, 2)
        bw = bc[:, None] * w[..., None]                        # (b,h,ln,n)
        acc = torch.zeros_like(st)
        for u in range(ln):
            acc = acc + xc[..., u:u + 1] * bw[:, :, None, u]
        st = torch.exp(cum[..., -1])[..., None, None] * st + acc
    return y.to(x.dtype), st


def _inputs(b, s, h, p, n, seed, carried=True, empty_row=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    if empty_row:
        dt[b - 1] = 0.0               # a row with no real token
        if s > 3:
            dt[0, 2] = 0.0            # and a padding position
    a = -np.exp(0.5 * rng.standard_normal((h,))).astype(np.float32)
    bm = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)).astype(np.float32)
          if carried else None)
    return x, dt, a, bm, cm, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _check(ins, y, st, chunk, dtype):
    """y and the state against the plain version (1e-5) and the Pallas
    kernel in interpret mode (2e-4); a row whose dt is 0 throughout keeps
    its carried state bit for bit."""
    t = [_t(a) for a in ins]
    x = t[0].to(dtype)
    bm, cm = t[3].to(dtype), t[4].to(dtype)
    yr, fr = ref.ssd_scan(x, t[1], t[2], bm, cm, chunk=chunk,
                          initial_state=t[5])
    tol = TOL if dtype == F32 else dict(atol=2 ** -7, rtol=2 ** -7)
    np.testing.assert_allclose(y.float().numpy(), yr.float().numpy(), **tol)
    np.testing.assert_allclose(st.numpy(), fr.numpy(), **TOL)
    if dtype == F32:
        py, pf = ssd_scan_pallas(*map(_j, ins[:5]), chunk=chunk,
                                 initial_state=_j(ins[5]), interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(py), **PALLAS_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(pf), **PALLAS_TOL)
    if ins[5] is not None:
        assert torch.equal(st[-1], t[5][-1])


@pytest.mark.parametrize("n,lanes", [(16, None), (32, None), (64, None),
                                     (64, (16, 1))])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_step_emulation(n, lanes, dtype):
    """The step kernel's order at the planner's lanes (and at 16 lanes of
    one vector for N = 64) against the plain version and
    ``ssd_scan_pallas``; the emulated state is the same at every lane
    layout (its update has no sum)."""
    ins = _inputs(3, 1, 4, 16, n, seed=n)
    t = [_t(a) for a in ins]
    args = (t[0].to(dtype), t[1], t[2], t[3].to(dtype), t[4].to(dtype),
            t[5])
    g, v = lanes or M.STEP_LANES[n]
    y, st = _step_emulation(*args, g, v)
    _check(ins, y, st, 1, dtype)
    for g2, v2 in M.LANES:
        if 4 * g2 * v2 == n and (g2, v2) != (g, v):
            assert torch.equal(st, _step_emulation(*args, g2, v2)[1])


@pytest.mark.parametrize("case", [
    # (B, S, H, P, N, chunk): C = 16 prefill, a ragged second chunk, a
    # chunk of three tiles (the last ragged), N = 32 in two tiles
    (2, 16, 3, 16, 16, 16), (2, 21, 2, 8, 16, 16), (1, 40, 2, 8, 32, 40),
    (2, 12, 2, 8, 32, 12)])
def test_split_emulation(case):
    """The split kernel's order (f32) against the plain version and
    ``ssd_scan_pallas``; the state is the same at another lane count."""
    b, s, h, p, n, chunk = case
    ins = _inputs(b, s, h, p, n, seed=s + n)
    t = [_t(a) for a in ins]
    g, v = M.SPLIT_LANES[n]
    y, st = _split_emulation(t[0], t[1], t[2], t[3], t[4], t[5], chunk, g,
                             v)
    _check(ins, y, st, chunk, F32)


def test_split_emulation_bf16_from_zero():
    """bf16 x, B and C from a zero state (the training forward), one bf16
    ulp from the plain version, and another lane layout's y within f32
    rounding of it."""
    ins = _inputs(2, 18, 2, 8, 32, seed=7, carried=False, empty_row=False)
    t = [_t(a) for a in ins]
    args = (t[0].to(BF16), t[1], t[2], t[3].to(BF16), t[4].to(BF16), None,
            16)
    y, st = _split_emulation(*args, 8, 1)
    _check(ins, y, st, 16, BF16)
    y2, st2 = _split_emulation(*args, 4, 2)
    assert torch.equal(st, st2)
    assert (y.float() - y2.float()).abs().max() <= 2 ** -7 * \
        y.float().abs().max()


def test_grid_fill_is_arithmetic():
    """The recomputed C B^T a split block pays stays at most its own work
    at the path's chunks: L^2 N / 2 against 2 L N a row."""
    for shape, n in (((4, 16, 80, 64), 128), ((2, 256, 80, 64), 128)):
        L = min(128, shape[1])
        g = M.ssd_split(shape, n, L)
        assert L * L * n / 2 <= 2 * L * n * g.rows * max(1, M.SPLIT_ROWS)
        assert math.ceil(M.SPLIT_ROWS * L) <= g.rows or \
            g.rows == min(shape[3], M.MAX_THREADS // 32 * (32 // g.lanes))
