"""The average pool's one-launch backward on the CPU against the JAX
package.

avgpool is reference-only in both packages (no TPU kernel), so the port
registers no kernel for it; under autograd ``ops.avgpool`` goes through
``AvgPoolFn`` on both lowerings where ``avgpool_plan`` names "gather": the
plain forward (``ref.avgpool``, its values unchanged) and aten's
``avg_pool2d_backward`` at the floor rule with divisor k*k, a gather per
input pixel (on the card one launch, no sort, no atomics), in place of
autograd's ``index_put_`` through the window gather.  A pad that aten
refuses (2 * pad > k) keeps that autograd ("windows").  Held here: the
backward against ``jax.vjp`` of ``repro.kernels.ops.avgpool`` for (k, s,
p) in {(2,2,0), (3,2,0), (3,2,1), (3,3,0)}, a refused pad, and CIFAR's
pool2 and pool3 shapes at batch 2, on JAX's reference and Pallas backends
and the port's two, f32 within ``FLOAT_TOL`` (rtol 1e-6, atol 1e-6:
``tests/test_torch_caffe_ops.py``'s); bf16 against the windows route's
autograd within one bf16 rounding of the largest gradient (2**-7 of it:
both sides add up to four windows' ``g / (k*k)``, rounded to bf16 in
another order); the forward bit for bit ``ref.avgpool``'s; the route
picked from shapes alone; and the reference-only set unchanged.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import use_backend as jax_use_backend  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.core.policy import use_backend  # noqa: E402
from repro_torch.core.registry import coverage  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_REL = 2 ** -7

# (shape, k, stride, pad): JAX's test windows at (2, 3, 9, 9), a pad aten
# refuses, and CIFAR's pool2 (on conv2's 32 x 15 x 15) and pool3 (on
# conv3's 64 x 7 x 7), both 3/2 at batch 2
CASES = [((2, 3, 9, 9), 2, 2, 0), ((2, 3, 9, 9), 3, 2, 0),
         ((2, 3, 9, 9), 3, 2, 1), ((2, 3, 9, 9), 3, 3, 0),
         ((2, 3, 9, 9), 3, 2, 2), ((2, 32, 15, 15), 3, 2, 0),
         ((2, 64, 7, 7), 3, 2, 0)]


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _route(shape, k, s, p):
    return ops.avgpool_plan(k, s, p, shape[2], shape[3])


def test_route_from_shapes():
    for shape, k, s, p in CASES:
        assert _route(shape, k, s, p) == ("windows" if 2 * p > k
                                          else "gather")
    # no window fits: the plain version's autograd, as before
    assert ops.avgpool_plan(5, 1, 0, 3, 3) == "windows"
    assert ops.avgpool_plan(2, 2, 1, 1, 1) == "gather"


@pytest.mark.parametrize("backend", ["reference", "hopper"])
@pytest.mark.parametrize("shape,k,s,p", CASES)
def test_backward_matches_jax(shape, k, s, p, backend):
    """``ops.avgpool``'s autograd on the port's ``backend`` against
    ``jax.vjp`` of JAX's op on both of its backends (JAX's avgpool is
    reference-only too: the same function on each), the port's forward
    bit for bit ``ref.avgpool``'s and its node the route's."""
    x = _normal(sum(shape) + k + s + p, shape)
    wants = []
    for jb in ("reference", "pallas"):
        with jax_use_backend(jb):
            out, vjp = jax.vjp(lambda a: jax_ops.avgpool(a, k, s, p),
                               jnp.asarray(x))
            cot = _normal(7, out.shape)
            wants.append((np.asarray(out), np.asarray(vjp(cot)[0])))
    np.testing.assert_array_equal(wants[0][1], wants[1][1])
    xt = torch.from_numpy(x).requires_grad_(True)
    with use_backend(backend):
        got = ops.avgpool(xt, k, s, p)
    node = type(got.grad_fn).__name__
    assert node == ("AvgPoolFnBackward" if _route(shape, k, s, p) ==
                    "gather" else "MeanBackward1")
    assert torch.equal(got.detach(), ref.avgpool(xt.detach(), k, s, p))
    np.testing.assert_allclose(got.detach().numpy(), wants[0][0],
                               **FLOAT_TOL)
    (g,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    assert g.shape == xt.shape and g.is_contiguous()
    np.testing.assert_allclose(g.numpy(), wants[0][1], **FLOAT_TOL)


@pytest.mark.parametrize("shape,k,s,p", [c for c in CASES
                                         if 2 * c[3] <= c[1]])
def test_bf16_against_the_windows_autograd(shape, k, s, p):
    """bf16: the gather's gradient against the one it replaced (autograd
    of the window gather, forced by ``avgpool_plan`` naming "windows"),
    within one bf16 rounding of the largest gradient."""
    x = torch.from_numpy(_normal(5, shape)).bfloat16().requires_grad_(True)
    out = ops.avgpool(x, k, s, p)
    assert type(out.grad_fn).__name__ == "AvgPoolFnBackward"
    old = ref.avgpool(x, k, s, p)
    assert torch.equal(out.detach(), old.detach())
    cot = torch.from_numpy(_normal(6, tuple(out.shape))).bfloat16()
    (g,) = torch.autograd.grad(out, x, cot)
    (w,) = torch.autograd.grad(old, x, cot)
    assert g.dtype == torch.bfloat16
    err = (g.float() - w.float()).abs().max().item()
    assert err <= BF16_REL * w.float().abs().max().item()


def test_forward_values_unchanged():
    """With and without grad, and under ``torch.no_grad``, the forward
    is ``ref.avgpool``'s bit for bit (CIFAR's pool2 at batch 2)."""
    x = torch.from_numpy(_normal(9, (2, 32, 15, 15)))
    want = ref.avgpool(x, 3, 2, 0)
    assert torch.equal(ops.avgpool(x, 3, 2), want)
    assert torch.equal(ops.avgpool(x.clone().requires_grad_(True), 3,
                                   2).detach(), want)
    with torch.no_grad():
        out = ops.avgpool(x.clone().requires_grad_(True), 3, 2)
    assert out.grad_fn is None and torch.equal(out, want)


def test_reference_only_set_unchanged():
    """avgpool keeps no hopper lowering: the port's reference-only set is
    still JAX's (``tests/test_torch_ops.py`` holds the two registries
    equal)."""
    cov = coverage()
    assert {n for n, c in cov.items() if not c["hopper"]} == {
        "avgpool", "accuracy", "layernorm"}
    assert cov["avgpool"] == {"reference": True, "hopper": False}
