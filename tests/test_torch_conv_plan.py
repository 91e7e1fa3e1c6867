"""The direct convolution's routes on the CPU, and a plain emulation of what
its register-tiled kernel computes, against the JAX package.

``kernels/conv_direct.py`` picks the route in pure Python, and the card's
kernels follow it: ``plan`` (square 3 x 3 and 5 x 5 windows at stride 1 ->
the "reg" kernel of ``csrc/conv_direct.cu``; every other window and stride
-> the "scalar" kernel) and ``tiles`` (the reg kernel's block, from shapes
alone).  Held here: the routes; tiles that give every output pixel x
filter to exactly one thread of one block and every channel to exactly
one channel group; grids of at least 132 blocks at the five LeNet
convolutions at batch 64; shared memory within the block's limit; the C
signatures of the launchers against their ctypes ones; and an emulation
in plain PyTorch of the reg kernel's summation order (each channel group
sums its channels c = g mod ks in ascending order, each channel's taps
row by row, the groups added in group order, then the bias in f32, one
rounding to x's dtype) against ``conv2d_direct_pallas`` in interpret mode
(as ``tests/test_torch_conv_direct.py`` runs it) on the same numpy
inputs: within 1e-5 of the output's largest magnitude in f32 (another
summation order over up to 800 products, FMAs on the card), within one
bf16 ulp of it in bf16 (both sides accumulate the same bf16 products in
f32 and round once), the tolerances of ``chip_smoke.py``'s phase 3.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clear_tuning  # noqa: E402
from repro.kernels.conv_direct import conv2d_direct_pallas  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import conv_direct as CD  # noqa: E402
from repro_torch.kernels.ref import conv_out_size  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
TOL = {BF16: 2 ** -7, F32: 1e-5}

# (n, c, h = w, f, k, stride, pad): the five LeNet convolutions (MNIST
# conv1, conv2; CIFAR conv1, conv2, conv3) at the solvers' batch of 64
LENET = [(64, 1, 28, 20, 5, 1, 0), (64, 20, 12, 50, 5, 1, 0),
         (64, 3, 32, 32, 5, 1, 2), (64, 32, 15, 32, 5, 1, 2),
         (64, 32, 7, 64, 5, 1, 2)]
# tests/test_kernels_conv_direct.py's cases, its case without a bias and
# the autotuner's conv3x3 cell
JAX_CASES = [(2, 3, 12, 4, 3, 1, 1), (1, 1, 28, 20, 5, 1, 0),
             (2, 4, 10, 8, 3, 2, 1), (1, 2, 8, 3, 2, 2, 0),
             (2, 3, 9, 5, 3, 3, 0), (1, 3, 16, 160, 5, 1, 2)]
NO_BIAS = (2, 3, 8, 4, 3, 1, 1)
CONV3X3 = (2, 8, 16, 64, 3, 1, 1)


def _shapes(case):
    n, c, h, f, k, _, _ = case
    return (n, c, h, h), (f, c, k, k)


@pytest.mark.parametrize("case,route", [
    *[(case, "reg") for case in LENET],
    *zip(JAX_CASES, ["reg", "reg", "scalar", "scalar", "scalar", "reg"]),
    (NO_BIAS, "reg"), (CONV3X3, "reg"),
    # a window the reg kernel does not instantiate, a non-square one
    ((2, 3, 16, 8, 7, 1, 3), "scalar"), ((2, 3, 16, 8, 1, 1, 0), "scalar")])
def test_plan(case, route):
    x_shape, w_shape = _shapes(case)
    for dtype in (F32, BF16):
        assert CD.plan(dtype, x_shape, w_shape, case[5], case[6]) == route
    if route == "reg":
        assert CD.plan(F32, x_shape, (w_shape[0], w_shape[1], 3, 5), 1,
                       1) == "scalar"


def _grid(t, case):
    """The reg kernel's grid (``csrc/conv_direct.cu:launch_reg``): (pixel
    tiles, filter tiles, images)."""
    n, c, h, f, k, s, p = case
    o = conv_out_size(h, k, s, p)
    return -(-o // t.rows) * -(-o // t.cols), -(-f // t.filters), n


def _walk(t, case, dtype):
    """Every element of one image's flat (F, OH, OW) output that the
    group-0 threads of its blocks write, as counts (a slot past the end
    counts a write beyond it), and each group's channels, by the kernel's
    mapping and epilogue (``csrc/conv_direct.cu:conv_reg_kernel``): a strip
    that starts past the last row or column returns; in f32 with OW a
    multiple of ``REG_P`` a strip is one 16-byte store of its ``REG_P``
    pixels, else each pixel inside the row is stored alone."""
    n, c, h, f, k, s, p = case
    oh, ow = conv_out_size(h, k, s, p), conv_out_size(h, k, s, p)
    tiles, ftiles, _ = _grid(t, case)
    tiles_x = -(-ow // t.cols)
    spr = t.cols // CD.REG_P
    strips = t.rows * spr
    per_group = strips * (t.filters // CD.REG_FT)
    whole = dtype == F32 and ow % CD.REG_P == 0
    seen = np.zeros(f * oh * ow + 1, np.int64)
    for bx in range(tiles):
        oy0, ox0 = (bx // tiles_x) * t.rows, (bx % tiles_x) * t.cols
        for by in range(ftiles):
            for tid in range(per_group):   # group 0: the writers
                fgi, st = tid // strips, tid % strips
                oy, ox = oy0 + st // spr, ox0 + (st % spr) * CD.REG_P
                if oy >= oh or ox >= ow:
                    continue
                for fo in range(by * t.filters + fgi * CD.REG_FT,
                                min(by * t.filters + (fgi + 1) * CD.REG_FT,
                                    f)):
                    for px in range(CD.REG_P):
                        if whole or ox + px < ow:
                            at = (fo * oh + oy) * ow + ox + px
                            seen[min(at, f * oh * ow)] += 1
    # chunks of t.chunk channels; group g takes the chunk's channels cl =
    # g, g + ks, ... (the kernel's compute loop)
    owner = np.full(c, -1)
    for c0 in range(0, c, t.chunk):
        for g in range(t.groups):
            for cl in range(g, min(t.chunk, c - c0), t.groups):
                assert owner[c0 + cl] == -1
                owner[c0 + cl] = g
    return seen, owner


# rows wider than a tile's 32 columns that no multiple of 32 fills: the
# last column tile's strips overhang the row (OW 48 at 3 x 3, 36 at 5 x 5)
WIDE = [(2, 8, 48, 16, 3, 1, 1), (2, 4, 36, 8, 5, 1, 2)]


@pytest.mark.parametrize("case", LENET + [JAX_CASES[0], JAX_CASES[1],
                                          JAX_CASES[5], NO_BIAS, CONV3X3]
                         + WIDE)
def test_tiles_cover_every_output_once(case):
    x_shape, w_shape = _shapes(case)
    for dtype in (F32, BF16):
        t = CD.tiles(dtype, x_shape, w_shape, case[5], case[6])
        assert t.filters % CD.REG_FT == 0 and t.cols % CD.REG_P == 0
        per_group = t.rows * (t.cols // CD.REG_P) * (t.filters // CD.REG_FT)
        assert per_group * t.groups <= t.threads <= CD.REG_MAX_THREADS
        assert t.threads % 32 == 0 and 1 <= t.groups <= CD.REG_MAX_GROUPS
        # a stage starts at a multiple of the groups, or holds all C
        assert t.chunk % t.groups == 0 or t.chunk >= case[1]
        # within the stages' budget and a block's 227 KB (kSmemMax)
        assert CD.reg_smem(t, case[4]) <= CD.REG_SMEM <= 227 * 1024
        seen, owner = _walk(t, case, dtype)
        assert (seen[:-1] == 1).all() and seen[-1] == 0
        # each channel in one group: group g owns the channels c = g mod ks
        np.testing.assert_array_equal(owner, np.arange(case[1]) % t.groups)


@pytest.mark.parametrize("case", LENET)
def test_grid_fills_the_card_at_lenet_shapes(case):
    x_shape, w_shape = _shapes(case)
    t = CD.tiles(F32, x_shape, w_shape, case[5], case[6])
    assert np.prod(_grid(t, case)) >= CD.REG_BLOCKS == 132


def test_tiles_at_lenet_shapes():
    # (filters, rows, cols, chunk, groups, threads) at batch 64: channel
    # groups where the image is small (MNIST conv2, CIFAR conv2 and
    # conv3), narrower filter tiles where one image gave fewer than 3
    # blocks
    got = [tuple(CD.tiles(F32, *_shapes(case), case[5], case[6]))
           for case in LENET]
    assert got == [(24, 8, 24, 1, 1, 160), (16, 8, 8, 8, 4, 128),
                   (32, 8, 32, 2, 1, 256), (8, 15, 16, 8, 4, 256),
                   (16, 7, 8, 8, 4, 128)]


_CTYPES = {"void*": _build._P, "int": _build._I, "long long": _build._L,
           "float": _build._F}


@pytest.mark.parametrize("name", ["repro_conv2d_direct",
                                  "repro_conv2d_direct_reg"])
def test_launchers_match_their_ctypes_signatures(name):
    src = (_build.CSRC / "conv_direct.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
    kinds = []
    for p in params.split(","):
        p = " ".join(p.split())
        kinds.append(_CTYPES["void*" if "*" in p else
                             " ".join(p.split()[:-1])])
    assert kinds == _build._SIGNATURES[name]


def _reg_emulation(x, w, b, pad, groups):
    """The reg kernel's arithmetic in f32: group g's sum over its channels
    c = g, g + groups, ... in ascending order, each channel's taps row by
    row (i, then j), the groups' sums added in group order, then the bias,
    one rounding to x's dtype.  The groups run side by side (channels
    padded with zeros to a multiple of ``groups``: their products add
    zeros)."""
    n, c, h, wd = x.shape
    f, _, k, _ = w.shape
    oh, ow = h + 2 * pad - k + 1, wd + 2 * pad - k + 1
    steps = -(-c // groups)
    extra = steps * groups - c
    xp = torch.nn.functional.pad(x.float(), (pad, pad, pad, pad, 0, extra))
    wf = torch.nn.functional.pad(w.float(), (0, 0, 0, 0, 0, extra))
    # (step, group, ...): channel step * groups + group
    xp = xp.reshape(n, steps, groups, *xp.shape[2:]).transpose(0, 1)
    wf = wf.reshape(f, steps, groups, k, k).permute(1, 2, 0, 3, 4)
    acc = torch.zeros((groups, n, f, oh, ow))
    for m in range(steps):
        for i in range(k):
            for j in range(k):
                acc = acc + (wf[m, :, None, :, i, j, None, None]
                             * xp[m, :, :, None, i:i + oh, j:j + ow]
                             .transpose(0, 1))
    total = acc[0]
    for g in range(1, groups):
        total = total + acc[g]
    if b is not None:
        total = total + b.float()[None, :, None, None]
    return total.to(x.dtype)


def _inputs(seed, case, bias=True):
    n, c, h, f, k, _, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, h, h)).astype(np.float32)
    w = (rng.standard_normal((f, c, k, k)) * (c * k * k) ** -0.5).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(f)).astype(np.float32) if bias else None
    return x, w, b


def _groups(case):
    """The channel groups of the reg plan at this shape and, for a LeNet
    shape, at the solvers' batch of 64 (the order the path sums in)."""
    x_shape, w_shape = _shapes(case)
    got = {CD.tiles(F32, x_shape, w_shape, case[5], case[6]).groups}
    if case[0] == 2 and case[1:] in [c[1:] for c in LENET]:
        got.add(CD.tiles(F32, (64,) + x_shape[1:], w_shape, case[5],
                         case[6]).groups)
    return sorted(got)


# the JAX cases on the reg route, the five LeNet shapes at batch 2
EMU_CASES = [JAX_CASES[0], JAX_CASES[1], JAX_CASES[5], NO_BIAS] + [
    (2,) + case[1:] for case in LENET]


@pytest.mark.parametrize("case", EMU_CASES)
def test_reg_emulation_matches_pallas(case):
    clear_tuning()
    x, w, b = _inputs(sum(case), case, bias=case != NO_BIAS)
    x_shape, w_shape = _shapes(case)
    assert CD.plan(F32, x_shape, w_shape, case[5], case[6]) == "reg"
    want = np.asarray(conv2d_direct_pallas(x, w, b, stride=1, pad=case[6],
                                           interpret=True))
    scale = np.abs(want).max()
    for groups in _groups(case):
        got = _reg_emulation(torch.from_numpy(x), torch.from_numpy(w),
                             None if b is None else torch.from_numpy(b),
                             case[6], groups).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL[F32] * scale)


# the autotuner's 3 x 3 cell, CIFAR conv2 (phase 3's bf16 case)
@pytest.mark.parametrize("case", [CONV3X3, (2, 32, 15, 32, 5, 1, 2)])
def test_reg_emulation_bf16_within_one_ulp_of_pallas(case):
    clear_tuning()
    x, w, b = _inputs(7, case)
    xb, wb, bb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    want = np.asarray(conv2d_direct_pallas(
        xb, wb, bb, stride=1, pad=case[6], interpret=True).astype(
            jnp.float32))
    tb = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(BF16)
          for a in (xb, wb, bb)]
    for groups in _groups(case):
        got = _reg_emulation(*tb, case[6], groups)
        assert got.dtype == BF16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=TOL[BF16] * np.abs(want).max())
