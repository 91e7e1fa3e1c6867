"""The port's backward on the CPU against the JAX package.

The plain ``rmsnorm_bwd`` and ``flash_attention_bwd`` against JAX's Pallas
backward kernels (interpret mode) and ``jax.grad`` of JAX's plain
versions, at the cases and tolerances of ``tests/test_kernels.py``
(1e-4; 2e-3 for attention, whose kernel recomputes p from the lse).  Then
every differentiable op, on both of the port's lowerings — torch autograd
of the plain version, and the hopper lowering's ``autograd.Function``
(whose wrappers take their plain versions on CPU tensors) — against
``jax.vjp`` of JAX's op on the same numpy inputs, in f32 within 1e-5 of
the largest gradient (summation order) and in bf16 within two bf16 ulps
of it; and each served family's ``train_loss`` through the hopper
lowering's Functions against the reference lowering.  Last, the guard
that keeps a kernel from cutting the graph.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import clear_tuning, set_tuning  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_pallas,
)
from repro.kernels.rmsnorm import rmsnorm_bwd_pallas  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.gemm import gemm  # noqa: E402


@pytest.fixture(autouse=True)
def _clear():
    # set_tuning below is process-wide in JAX: keep it out of the other
    # tests of this worker
    clear_tuning()
    yield
    clear_tuning()


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                        requires_grad=grad)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


# ---------------------------------------------------------------------------
# the plain backward versions against the Pallas kernels and jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,d", [(8, 64), (300, 128), (17, 96)])
def test_rmsnorm_bwd_matches_jax(r, d):
    rng = np.random.default_rng(r + d)
    x = rng.standard_normal((r, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    dy = rng.standard_normal((r, d)).astype(np.float32)
    dx, dw = ref.rmsnorm_bwd(_t(x), _t(w), _t(dy))
    kx, kw = rmsnorm_bwd_pallas(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(dy), interpret=True)
    gx, gw = jax.grad(lambda x, w: (jax_ref.rmsnorm(x, w) * dy).sum(),
                      (0, 1))(jnp.asarray(x), jnp.asarray(w))
    for want_x, want_w in ((kx, kw), (gx, gw)):
        np.testing.assert_allclose(_np(dx), want_x, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_np(dw), want_w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,d,causal,window",
    [(1, 32, 32, 4, 2, 16, True, None), (2, 33, 33, 4, 4, 16, True, None),
     (1, 48, 48, 8, 2, 32, True, 20), (2, 16, 16, 2, 1, 8, False, None)],
)
def test_flash_attention_bwd_matches_jax(b, sq, sk, hq, hkv, d, causal,
                                         window):
    set_tuning("flash_attention", bq=16, bk=16)
    rng = np.random.default_rng(sq + hq + d)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    # the forward's out and lse, from the port's plain forward (held to
    # flash_attention_pallas in test_torch_forward.py), feed both sides
    o, lse = (_np(t) for t in ref.mha_attention(
        _t(q), _t(k), _t(v), causal=causal, window=window))
    got = ref.flash_attention_bwd(_t(q), _t(k), _t(v), _t(o), _t(lse),
                                  _t(do), causal=causal, window=window)
    kern = flash_attention_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(o),
        jnp.asarray(lse), jnp.asarray(do), causal=causal, window=window,
        interpret=True)
    grad = jax.grad(lambda q, k, v: (jax_ref.mha_attention(
        q, k, v, causal=causal, window=window) * do).sum(), (0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for want in (kern, grad):
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), w, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# each op's autograd on both lowerings against jax.vjp of JAX's op
# ---------------------------------------------------------------------------

# f32: summation order; bf16: two ulps of the largest gradient
REL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _vjp_check(jax_fn, port_fns, inputs, cot, dtype=torch.float32):
    """``jax.vjp`` of ``jax_fn`` at the numpy ``inputs`` with cotangent
    ``cot`` against torch autograd of each of ``port_fns``: outputs and
    every input gradient."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jin = [jnp.asarray(a, jdt) if a.dtype == np.float32 else jnp.asarray(a)
           for a in inputs]
    want, want_g = jax.jit(lambda args, c: (
        jax_fn(*args), jax.vjp(jax_fn, *args)[1](c.astype(jdt))))(
            jin, jnp.asarray(cot))
    for fn in port_fns:
        tin = [_t(a, dtype, grad=True) if a.dtype == np.float32
               else torch.from_numpy(a) for a in inputs]
        out = fn(*tin)
        _close(_np(out), np.asarray(want, np.float32), REL[dtype])
        diff = [t for t in tin if t.requires_grad]
        grads = torch.autograd.grad(out, diff, _t(cot, out.dtype))
        for t, g, w in zip(diff, grads, want_g):
            assert g.dtype == t.dtype       # cotangents in the input dtype
            _close(_np(g), np.asarray(w, np.float32), REL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 64, 48), (33, 20, 70)])
def test_matmul_grad_matches_jax(dtype, m, k, n):
    rng = np.random.default_rng(m * n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    _vjp_check(jax_ops.matmul,
               [ops.matmul, lambda a, b: ops.MatmulFn.apply(a, b, gemm)],
               [a, b], g, dtype)


def test_matmul_grad_of_the_tied_head():
    """The head reads ``embed.T`` by strides; its grad reaches the
    embedding through the transposed view."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((6, 32)).astype(np.float32)
    e = rng.standard_normal((50, 32)).astype(np.float32)
    g = rng.standard_normal((6, 50)).astype(np.float32)
    _vjp_check(lambda h, e: jax_ops.matmul(h, e.T),
               [lambda h, e: ops.matmul(h, e.T),
                lambda h, e: ops.MatmulFn.apply(h, e.T, gemm)], [h, e], g)


def test_bias_add_rows_grad_matches_jax():
    rng = np.random.default_rng(4)
    m = rng.standard_normal((7, 40)).astype(np.float32)
    v = rng.standard_normal(40).astype(np.float32)
    g = rng.standard_normal((7, 40)).astype(np.float32)
    _vjp_check(jax_ops.bias_add_rows,
               [ops.bias_add_rows, ops.BiasAddRowsFn.apply], [m, v], g)


@pytest.mark.parametrize("shape", [(12, 64), (2, 5, 48)])
def test_rmsnorm_grad_matches_jax(shape):
    rng = np.random.default_rng(shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    _vjp_check(jax_ops.rmsnorm,
               [ops.rmsnorm, lambda x, w: ops.RMSNormFn.apply(x, w, 1e-6)],
               [x, w], g)


@pytest.mark.parametrize("hq,hkv,causal,window", [
    (4, 2, True, None), (4, 1, True, 7), (2, 2, False, None)])
def test_attention_grad_matches_jax(hq, hkv, causal, window):
    rng = np.random.default_rng(hq + hkv)
    q = rng.standard_normal((2, 21, hq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 21, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 21, hkv, 16)).astype(np.float32)
    g = rng.standard_normal((2, 21, hq, 16)).astype(np.float32)
    _vjp_check(
        lambda q, k, v: jax_ops.attention(q, k, v, causal=causal,
                                          window=window),
        [lambda q, k, v: ops.attention(q, k, v, causal=causal,
                                       window=window),
         lambda q, k, v: ops.AttentionFn.apply(q, k, v, causal, window,
                                               None)],
        [q, k, v], g)


def test_ssd_scan_grad_matches_jax():
    """Three chunks of 8 (the carried state between them is differentiated
    too); dt, A, B and C all get gradients."""
    rng = np.random.default_rng(5)
    b, s, h, p, n = 2, 24, 3, 4, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    g = rng.standard_normal((b, s, h, p)).astype(np.float32)
    _vjp_check(
        lambda *t: jax_ops.ssd_scan(*t, chunk=8),
        [lambda *t: ops.ssd_scan(*t, chunk=8),
         lambda *t: ops.SSDScanFn.apply(*t, 8)],
        [x, dt, a, bm, cm], g)


def test_ssd_scan_grad_is_finite_past_the_exp_range():
    """A chunk whose decays span more than f32's exp range: the masked
    entries exp(cum_t - cum_u), u > t, would overflow, and 0 * inf in the
    backward would be NaN."""
    torch.manual_seed(0)
    x = torch.randn(1, 64, 2, 4, requires_grad=True)
    dt = torch.full((1, 64, 2), 3.0, requires_grad=True)
    a = torch.full((2,), -1.0, requires_grad=True)
    bm = torch.randn(1, 64, 1, 4, requires_grad=True)
    cm = torch.randn(1, 64, 1, 4, requires_grad=True)
    y = ops.ssd_scan(x, dt, a, bm, cm, chunk=64)
    grads = torch.autograd.grad(y.sum(), (x, dt, a, bm, cm))
    assert all(torch.isfinite(t).all() for t in grads)


@pytest.mark.parametrize("arch", ["qwen2.5-3b-smoke", "mixtral-8x7b-smoke",
                                  "mamba2-2.7b-smoke", "zamba2-2.7b-smoke"])
def test_train_loss_grads_agree_across_lowerings(arch, monkeypatch):
    """Each family's ``train_loss`` through the hopper lowering's
    Functions (their wrappers take the plain versions on CPU tensors;
    the policy is told these tensors go to the kernels) against torch
    autograd of the reference lowering, remat on (hybrid: nested): loss
    and every gradient within 1e-5 of the leaf's largest value."""
    from repro_torch.configs import get_arch
    from repro_torch.core import policy, registry
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_leaves

    hopper = lambda t: policy.current_backend() is not policy.Backend.REFERENCE  # noqa: E731
    monkeypatch.setattr(ops, "use_hopper", hopper)
    monkeypatch.setattr(registry, "use_hopper", hopper)
    cfg = get_arch(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (2, 13), generator=torch.Generator().manual_seed(1))}
    out = {}
    for backend in ("hopper", "reference"):
        with policy.use_backend(backend):
            out[backend] = loss_and_grads(cfg, params, batch)
    (lh, gh), (lr, gr) = out["hopper"], out["reference"]
    np.testing.assert_allclose(lh.item(), lr.item(), rtol=1e-6)
    for a, b in zip(tree_leaves(gh), tree_leaves(gr)):
        _close(_np(a), _np(b), 1e-5)


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------

def test_a_kernel_outside_its_function_would_cut_the_graph():
    """A hopper wrapper raises where ``needs_grad`` holds: on the card a
    ctypes launch under grad mode on a tensor that requires grad would
    return an output with no grad_fn.  (On the CPU the wrappers take their
    plain versions, which autograd records, so the condition is tested
    here and the raise on the card.)"""
    leaf = torch.ones(2, requires_grad=True)
    plain = torch.ones(2)
    assert _build.needs_grad(plain, leaf)
    assert _build.needs_grad(leaf * 2)
    assert not _build.needs_grad(plain, None)
    with torch.no_grad():
        assert not _build.needs_grad(leaf)
    with pytest.raises(RuntimeError, match="cut the autograd graph"):
        _build.guard_grad("gemm", plain, leaf)
    _build.guard_grad("gemm", plain, leaf.detach())
