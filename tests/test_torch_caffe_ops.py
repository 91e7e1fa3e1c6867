"""The Caffe ops' plain PyTorch versions on the CPU against the JAX
package: each against the Pallas kernel it stands beside (interpret mode)
and against JAX's oracle, at the shapes of ``tests/test_kernels.py``, plus
ties, all-padding windows, labels outside [0, V), conv2d, avgpool and
top-1/top-5 accuracy.

Tolerances.  im2col, maxpool (values and argmax), relu and accuracy are
exact: they copy, compare or select, and compute nothing that rounds
differently.  The softmax pair within 1e-6 (f32 exponentials and sums in
another library's order).  conv2d within 1e-6 of its scale (an
f32-accumulated product over C*KH*KW terms in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.eltwise import relu_pallas  # noqa: E402
from repro.kernels.im2col import im2col_pallas  # noqa: E402
from repro.kernels.pooling import maxpool_pallas  # noqa: E402
from repro.kernels.softmax_xent import (  # noqa: E402
    softmax_pallas,
    softmax_xent_pallas,
)
from repro_torch.core.policy import use_backend  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.im2col import im2col  # noqa: E402
from repro_torch.kernels.softmax_xent import softmax_xent  # noqa: E402

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "n,c,h,w,kh,kw,s,p",
    [(2, 3, 8, 9, 3, 3, 1, 0), (2, 3, 8, 9, 3, 3, 1, 1),
     (1, 1, 28, 28, 5, 5, 1, 0), (2, 4, 10, 10, 2, 3, 2, 1),
     (2, 2, 7, 7, 3, 3, 3, 0)],
)
def test_im2col(n, c, h, w, kh, kw, s, p):
    x = _normal(0, (n, c, h, w))
    got = ref.im2col(torch.from_numpy(x), kh, kw, s, p)
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(im2col_pallas(x, kh, kw, s, p)))
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(jax_ref.im2col(x, kh, kw, s, p)))
    # the convolution's layout: the batch flattened into the columns
    cols = im2col(torch.from_numpy(x), kh, kw, s, p, batch_in_columns=True)
    np.testing.assert_array_equal(
        _np(cols), _np(got).transpose(1, 0, 2).reshape(c * kh * kw, -1))


# ---------------------------------------------------------------------------
MAXPOOL_CASES = [(2, 3, 8, 8, 2, 2, 0), (2, 3, 9, 9, 2, 2, 0),
                 (1, 4, 28, 28, 2, 2, 0), (2, 2, 12, 12, 3, 3, 0),
                 (1, 1, 8, 8, 2, 2, 1),
                 # CIFAR's overlapping 3/2 pool, a pad of 1 on it, and
                 # windows wholly in the padding (pad >= k)
                 (2, 3, 9, 9, 3, 2, 0), (2, 3, 9, 9, 3, 2, 1),
                 (1, 2, 4, 4, 2, 2, 2)]


def _maxpool_all(x, k, s, p):
    out, arg = ref.maxpool(torch.from_numpy(x), k, s, p)
    assert arg.dtype == torch.int32
    for want_out, want_arg in (maxpool_pallas(x, k, s, p),
                               jax_ref.maxpool(x, k, s, p)):
        np.testing.assert_array_equal(_np(out), np.asarray(want_out))
        np.testing.assert_array_equal(_np(arg), np.asarray(want_arg))
    return out, arg


@pytest.mark.parametrize("n,c,h,w,k,s,p", MAXPOOL_CASES)
def test_maxpool(n, c, h, w, k, s, p):
    _maxpool_all(_normal(0, (n, c, h, w)), k, s, p)


@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (3, 2, 0), (3, 2, 1)])
def test_maxpool_ties_take_the_first_maximum(k, s, p):
    """Values from {-1, 0, 1}: nearly every window holds a tie, and with a
    pad the all-negative windows tie against nothing in the padding."""
    x = np.random.default_rng(1).integers(-1, 2, (2, 3, 9, 9)).astype(
        np.float32)
    out, arg = _maxpool_all(x, k, s, p)
    # the argmax is the first maximum in row-major window order
    wp = 9 + 2 * p
    xp = np.pad(x, ((0, 0), (0, 0), (p, p), (p, p)),
                constant_values=np.finfo(np.float32).min)
    for oy in range(out.shape[2]):
        for ox in range(out.shape[3]):
            win = xp[:, :, oy * s: oy * s + k, ox * s: ox * s + k]
            first = win.reshape(2, 3, -1).argmax(-1)
            want = (oy * s + first // k) * wp + ox * s + first % k
            np.testing.assert_array_equal(_np(arg)[:, :, oy, ox], want)


def test_all_padding_window_holds_finfo_min():
    x = _normal(2, (1, 2, 4, 4))
    out, arg = _maxpool_all(x, 2, 2, 2)
    assert _np(out)[0, 0, 0, 0] == np.finfo(np.float32).min
    assert _np(arg)[0, 0, 0, 0] == 0


@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (3, 2, 0), (3, 2, 1),
                                   (3, 3, 0)])
def test_avgpool(k, s, p):
    x = _normal(3, (2, 3, 9, 9))
    np.testing.assert_allclose(
        _np(ops.avgpool(torch.from_numpy(x), k, s, p)),
        np.asarray(jax_ops.avgpool(x, k, s, p)), **FLOAT_TOL)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("slope", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(5,), (64, 500), (2, 32, 15, 15)])
def test_relu(slope, shape):
    x = _normal(4, shape)
    x.flat[:3] = [0.0, -0.0, 1e-30]
    got = _np(ref.relu(torch.from_numpy(x), slope))
    np.testing.assert_array_equal(got, np.asarray(relu_pallas(x, slope)))
    np.testing.assert_array_equal(got, np.asarray(jax_ref.relu(x, slope)))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,v", [(4, 10), (130, 17), (256, 1000), (5, 7)])
def test_softmax_and_softmax_xent(b, v):
    x = _normal(5, (b, v), 3.0)
    y = np.random.default_rng(6).integers(0, v, b).astype(np.int32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    p = _np(ref.softmax(xt))
    np.testing.assert_allclose(p, np.asarray(softmax_pallas(x)), **FLOAT_TOL)
    np.testing.assert_allclose(p, np.asarray(jax_ref.softmax(x)),
                               **FLOAT_TOL)
    loss, probs = ref.softmax_xent(xt, yt)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    for want_loss, want_probs in (softmax_xent_pallas(x, y),
                                  jax_ref.softmax_xent(x, y)):
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
        np.testing.assert_allclose(_np(probs), np.asarray(want_probs),
                                   **FLOAT_TOL)
    # a leading rank and another axis, as ops.softmax takes them
    x3 = _normal(7, (3, b, v))
    np.testing.assert_allclose(
        _np(ops.softmax(torch.from_numpy(x3))),
        np.asarray(jax_ops.softmax(x3)), **FLOAT_TOL)
    np.testing.assert_allclose(
        _np(ops.softmax(torch.from_numpy(x3), dim=1)),
        np.asarray(jax_ops.softmax(x3, axis=1)), **FLOAT_TOL)


def test_labels_outside_the_classes_follow_the_pallas_rule():
    """A label of -1 (or V) gives its row an NLL of 0 and the mean still
    divides by B, as JAX's Pallas kernel computes; JAX's oracle wraps -1
    to the last class instead, so it is not the reference here.  Both of
    the port's lowerings (the wrapper takes the plain version on the CPU)
    follow the rule."""
    x = _normal(8, (6, 10), 3.0)
    y = np.array([3, -1, 0, 9, -1, 10], np.int32)
    want_loss, want_probs = softmax_xent_pallas(x, y)
    for lowering in (ref.softmax_xent, softmax_xent):
        loss, probs = lowering(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
        np.testing.assert_allclose(_np(probs), np.asarray(want_probs),
                                   **FLOAT_TOL)
    valid = y[[0, 2, 3]]
    manual = -np.log(np.asarray(jax_ref.softmax(x)))[[0, 2, 3], valid]
    np.testing.assert_allclose(float(want_loss), manual.sum() / 6,
                               rtol=1e-6)
    for be in ("reference", "auto"):
        with use_backend(be):
            got = ops.softmax_xent_loss(torch.from_numpy(x),
                                        torch.from_numpy(y))
        np.testing.assert_allclose(float(got), float(want_loss), rtol=1e-6)
    y_neg = np.where(y < 0, y, 0).astype(np.int32)     # only -1 or 0
    assert abs(float(jax_ref.softmax_xent(x, y_neg)[0])
               - float(softmax_xent_pallas(x, y_neg)[0])) > 0.1


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride,pad", [(1, 0), (1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("bias", [True, False])
def test_conv2d(stride, pad, bias):
    """Both of the port's lowerings' arithmetic on the CPU (the hopper
    lowering's glue — im2col in the batch-in-columns layout, one product,
    the bias while copying out — over the plain versions) against JAX's
    oracle and its Pallas lowering (``_conv2d_fwd_impl``, interpret)."""
    x, w = _normal(9, (2, 3, 8, 8)), _normal(10, (4, 3, 3, 3))
    b = _normal(11, (4,)) if bias else None
    want = np.asarray(jax_ref.conv2d(x, w, b, stride=stride, pad=pad))
    want_p = np.asarray(jax_ops._conv2d_fwd_impl(
        x, w, b if bias else jnp.zeros((4,)), stride, pad, bias))
    bt = None if b is None else torch.from_numpy(b)
    for fn in (ref.conv2d, ops.conv2d_hopper):
        got = _np(fn(torch.from_numpy(x), torch.from_numpy(w), bt,
                     stride=stride, pad=pad))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(got, want_p, rtol=0, atol=1e-6 * scale)


# ---------------------------------------------------------------------------
def test_accuracy_top1_and_top5_with_ties():
    """Ties rank the lower class first (argmax, ``jax.lax.top_k``)."""
    rng = np.random.default_rng(12)
    logits = rng.integers(0, 4, (64, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    for k in (1, 5):
        got = ref.accuracy(lt, yt, k)
        assert got.dtype == torch.float32
        assert float(got) == float(jax_ref.accuracy(logits, labels, k))
        assert float(ops.accuracy(lt, yt, k)) == float(got)
    # the tie-breaking is what decides these: every logit equal
    flat = np.zeros((4, 10), np.float32)
    for k, lab, want in ((1, [0, 0, 1, 0], 0.75), (5, [4, 5, 0, 9], 0.5)):
        lab = np.array(lab, np.int32)
        got = float(ref.accuracy(torch.from_numpy(flat),
                                 torch.from_numpy(lab), k))
        assert got == want == float(jax_ref.accuracy(flat, lab, k))
