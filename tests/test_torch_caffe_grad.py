"""The port's Caffe backward on the CPU against the JAX package.

The plain backward versions (``col2im``, ``conv2d_bwd``, ``maxpool_bwd``,
``relu_bwd``, ``softmax_xent_bwd``) and the four backward kernels'
wrappers (which take them on CPU tensors) against JAX's oracles and its
Pallas kernels in interpret mode, at the cases of ``tests/test_kernels.py``
plus ties, a pad of 1, stride > k, overlapping pools and labels -1 and V;
the im2col/col2im adjoint property; each Caffe op's autograd on both of
the port's lowerings (torch autograd, or the reference Functions, and the
hopper lowering's Functions called on CPU tensors) against ``jax.vjp`` of
JAX's op on both of its backends; each layer's explicit ``backward``
against JAX's; and the two repairs of the reference lowering (a tied
window sends its whole gradient to the first maximum; a label outside
[0, V) gives its row ``p / B``).

Tolerances.  maxpool_bwd without overlap and relu_bwd are exact: they
copy or multiply once, as JAX does.  col2im, the overlapping maxpool_bwd
and softmax_xent_bwd within 1e-6 (f32 sums of a few terms in another
order).  Gradients through a product (conv2d, the layers) within 1e-5 of
the largest gradient (f32 sums over C*K*K or N*OH*OW terms in another
order).  The repairs within atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.caffe import spec as jax_spec  # noqa: E402
from repro.caffe.layers import build_layer as jax_build_layer  # noqa: E402
from repro.core import use_backend as jax_use_backend  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.eltwise import relu_bwd_pallas  # noqa: E402
from repro.kernels.im2col import col2im_pallas  # noqa: E402
from repro.kernels.pooling import maxpool_bwd_pallas  # noqa: E402
from repro.kernels.softmax_xent import softmax_xent_bwd_pallas  # noqa: E402
from repro_torch.caffe import spec  # noqa: E402
from repro_torch.caffe.layers import build_layer  # noqa: E402
from repro_torch.convert import caffe_params_from_jax  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.eltwise import relu_bwd  # noqa: E402
from repro_torch.kernels.im2col import col2im  # noqa: E402
from repro_torch.kernels.pooling import maxpool_bwd  # noqa: E402
from repro_torch.kernels.softmax_xent import softmax_xent_bwd  # noqa: E402

SUM_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_REL = 1e-5


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_(True) if grad else t


def _np(t):
    return t.detach().numpy()


def _close(got, want, rel=GRAD_REL):
    """max |got - want| <= rel * max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), (err, rel)


def _ties(seed, shape):
    """Values in {-1, 0, 1}: most windows hold tied maxima."""
    return np.random.default_rng(seed).integers(-1, 2, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the plain backward versions and the wrappers against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "n,c,h,w,kh,kw,p",
    [(2, 3, 8, 9, 3, 3, 0), (2, 3, 8, 9, 3, 3, 1), (1, 2, 12, 12, 5, 5, 2),
     (2, 4, 12, 12, 5, 5, 0)],
)
def test_col2im_matches_jax(n, c, h, w, kh, kw, p):
    """Stride 1: the plain scatter, the wrapper on contiguous and strided
    columns, JAX's oracle and its Pallas kernel agree."""
    oh, ow = h + 2 * p - kh + 1, w + 2 * p - kw + 1
    cols = _normal(n + c + p, (n, c * kh * kw, oh * ow))
    want = np.asarray(jax.jit(jax_ref.col2im, static_argnums=range(1, 6))(
        jnp.asarray(cols), (n, c, h, w), kh, kw, 1, p))
    kern = col2im_pallas(jnp.asarray(cols), (n, c, h, w), kh, kw, 1, p,
                         interpret=True)
    np.testing.assert_allclose(kern, want, **SUM_TOL)
    got = ref.col2im(_t(cols), (n, c, h, w), kh, kw, 1, p)
    np.testing.assert_allclose(_np(got), want, **SUM_TOL)
    np.testing.assert_allclose(
        _np(col2im(_t(cols), (n, c, h, w), kh, kw, 1, p)), want, **SUM_TOL)
    # the convolution backward's (C*KH*KW, N*OH*OW) product, read as
    # (N, C*KH*KW, OH*OW) through a transposed view
    wide = _t(cols).transpose(0, 1).reshape(c * kh * kw, -1)
    np.testing.assert_allclose(
        _np(col2im(wide.view(c * kh * kw, n, -1).transpose(0, 1),
                   (n, c, h, w), kh, kw, 1, p)), want, **SUM_TOL)
    np.testing.assert_allclose(
        _np(ops.col2im(_t(cols), (n, c, h, w), kh, kw, 1, p)), want,
        **SUM_TOL)


@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (2, 3, 0), (3, 3, 0)])
def test_col2im_other_strides_take_the_plain_scatter(k, s, p):
    """The kernel takes stride 1 only, as JAX's; ``ops.col2im`` sends any
    other stride to the plain scatter, which matches JAX's oracle."""
    n, c, h, w = 2, 3, 10, 11
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    cols = _normal(k + s, (n, c * k * k, oh * ow))
    want = jax_ref.col2im(jnp.asarray(cols), (n, c, h, w), k, k, s, p)
    np.testing.assert_allclose(
        _np(ops.col2im(_t(cols), (n, c, h, w), k, k, s, p)), want,
        **SUM_TOL)
    with pytest.raises(NotImplementedError, match="stride 1"):
        col2im(_t(cols), (n, c, h, w), k, k, s, p)
    with pytest.raises(ValueError, match="expected"):
        col2im(_t(cols)[:, 1:], (n, c, h, w), k, k, 1, p)


@pytest.mark.parametrize("n,c,h,w,k,s,p", [
    (2, 3, 8, 9, 3, 1, 0), (1, 2, 7, 7, 3, 2, 1), (2, 1, 12, 12, 5, 1, 2),
    (1, 3, 9, 8, 2, 3, 0), (2, 2, 6, 6, 1, 1, 0)])
def test_im2col_col2im_adjoint(n, c, h, w, k, s, p):
    """<im2col(x), y> == <x, col2im(y)> (``tests/test_properties.py:35``),
    at every stride through ``ops.col2im``."""
    x = _normal(1, (n, c, h, w))
    cols = ref.im2col(_t(x), k, k, s, p)
    y = _normal(2, tuple(cols.shape))
    lhs = float((cols * _t(y)).sum())
    rhs = float((_t(x) * ops.col2im(_t(y), (n, c, h, w), k, k, s, p)).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,c,h,w,k,s,p", [
    (2, 3, 8, 8, 2, 2, 0), (2, 3, 9, 9, 2, 2, 0), (1, 4, 28, 28, 2, 2, 0),
    (2, 2, 12, 12, 3, 3, 0), (1, 1, 8, 8, 2, 2, 1), (2, 2, 11, 11, 2, 3, 0),
    (2, 3, 9, 9, 3, 2, 0), (1, 2, 10, 10, 3, 2, 1)])
@pytest.mark.parametrize("ties", [False, True])
def test_maxpool_bwd_matches_jax(n, c, h, w, k, s, p, ties):
    """The plain scatter and the wrapper against JAX's oracle and, where
    the windows do not overlap, its Pallas kernel (exact); overlapping
    windows add up in another order (1e-6) and the wrapper refuses
    them."""
    x = _ties(n + h, (n, c, h, w)) if ties else _normal(n + h, (n, c, h, w))
    out, arg = jax.jit(jax_ref.maxpool, static_argnums=(1, 2, 3))(
        jnp.asarray(x), k, s, p)
    dy = _normal(3, out.shape)
    want = np.asarray(jax.jit(jax_ref.maxpool_bwd,
                              static_argnums=(2, 3, 4, 5))(
        jnp.asarray(dy), arg, (n, c, h, w), k, s, p))
    pout, parg = ref.maxpool(_t(x), k, s, p)
    np.testing.assert_array_equal(_np(parg), np.asarray(arg))
    got = ref.maxpool_bwd(_t(dy), parg, (n, c, h, w), k, s, p)
    if s >= k:
        np.testing.assert_array_equal(_np(got), want)
        kern = maxpool_bwd_pallas(jnp.asarray(dy), arg, (n, c, h, w), k, s,
                                  p, interpret=True)
        np.testing.assert_array_equal(np.asarray(kern), want)
        np.testing.assert_array_equal(
            _np(maxpool_bwd(_t(dy), parg, (n, c, h, w), k, s, p)), want)
    else:
        np.testing.assert_allclose(_np(got), want, **SUM_TOL)
        with pytest.raises(NotImplementedError, match="stride >= k"):
            maxpool_bwd(_t(dy), parg, (n, c, h, w), k, s, p)


@pytest.mark.parametrize("slope", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(70, 130), (2, 3, 5, 7)])
def test_relu_bwd_matches_jax(slope, shape):
    """Exact, NaN in x taking the slope (x > 0 is false), against JAX's
    oracle and Pallas kernel; the wrapper reads x and dy in different
    layouts and writes in x's."""
    x = _normal(4, shape)
    x.reshape(-1)[::17] = np.nan
    x.reshape(-1)[::13] = 0.0
    dy = _normal(5, shape)
    want = np.asarray(jax_ref.relu_bwd(jnp.asarray(x), jnp.asarray(dy),
                                       slope))
    np.testing.assert_array_equal(
        np.asarray(relu_bwd_pallas(jnp.asarray(x), jnp.asarray(dy), slope,
                                   interpret=True)), want)
    np.testing.assert_array_equal(_np(ref.relu_bwd(_t(x), _t(dy), slope)),
                                  want)
    perm = tuple(reversed(range(len(shape))))
    x_col = _t(x).permute(perm).contiguous().permute(perm)
    got = relu_bwd(x_col, _t(dy), slope)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("b,v", [(4, 10), (130, 17), (5, 7), (64, 10)])
def test_softmax_xent_bwd_matches_jax(b, v):
    """``(p - onehot) / B`` against JAX's oracle and Pallas kernel, with a
    label -1 and a label V among the rows (their one-hot is empty)."""
    rng = np.random.default_rng(b + v)
    p = np.asarray(jax.nn.softmax(jnp.asarray(_normal(6, (b, v), 3.0))))
    y = rng.integers(0, v, b).astype(np.int32)
    y[0], y[-1] = -1, v
    want = np.asarray(jax_ref.softmax_xent_bwd(jnp.asarray(p),
                                               jnp.asarray(y)))
    kern = softmax_xent_bwd_pallas(jnp.asarray(p), jnp.asarray(y),
                                   interpret=True)
    np.testing.assert_allclose(np.asarray(kern), want, rtol=1e-6, atol=1e-7)
    for got in (ref.softmax_xent_bwd(_t(p), _t(y)),
                softmax_xent_bwd(_t(p), _t(y).long())):
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(got)[0], p[0] / b, rtol=1e-6)


@pytest.mark.parametrize("stride,pad,bias", [(1, 0, True), (1, 2, True),
                                             (2, 1, False)])
def test_conv2d_bwd_matches_jax(stride, pad, bias):
    x = _normal(7, (2, 3, 10, 10))
    w = _normal(8, (4, 3, 5, 5), 0.2)
    oh = (10 + 2 * pad - 5) // stride + 1
    dy = _normal(9, (2, 4, oh, oh))
    want = jax.jit(lambda x, w, dy: jax_ref.conv2d_bwd(
        x, w, dy, stride=stride, pad=pad, has_bias=bias))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy))
    got = ref.conv2d_bwd(_t(x), _t(w), _t(dy), stride=stride, pad=pad,
                         has_bias=bias)
    for g, wt in zip(got, want):
        if wt is None:
            assert g is None
        else:
            _close(_np(g), wt)


# ---------------------------------------------------------------------------
# each op's autograd on both lowerings against jax.vjp on both backends
# ---------------------------------------------------------------------------

def _vjp_both(jax_fn, port_fns, inputs, cot, grad_mask=None):
    """``jax.vjp`` of ``jax_fn`` at the numpy ``inputs`` on JAX's reference
    and pallas (interpret) backends, against torch autograd of each of
    ``port_fns`` (the port's two lowerings): outputs and the gradients of
    the float inputs ``grad_mask`` selects."""
    mask = grad_mask or [a.dtype == np.float32 for a in inputs]
    wants = []
    def out_and_vjp(diff, c):
        out, vjp = jax.vjp(lambda *f: jax_fn(*_fill(inputs, mask, f)),
                           *diff)
        return out, vjp(c)

    for backend in ("reference", "pallas"):
        with jax_use_backend(backend):
            wants.append(jax.jit(out_and_vjp)(
                [jnp.asarray(a) for a, m in zip(inputs, mask) if m],
                jnp.asarray(cot)))
    for out, grads in wants[1:]:
        _close(np.asarray(out), np.asarray(wants[0][0]))
        for g, w in zip(grads, wants[0][1]):
            _close(np.asarray(g), np.asarray(w))
    want_out, want_g = wants[0]
    for fn in port_fns:
        tin = [_t(a, grad=m) for a, m in zip(inputs, mask)]
        out = fn(*tin)
        _close(_np(out), np.asarray(want_out))
        diff = [t for t in tin if t.requires_grad]
        grads = torch.autograd.grad(out, diff, _t(cot))
        for g, w in zip(grads, want_g):
            _close(_np(g), np.asarray(w))


def _fill(inputs, mask, diff):
    """``inputs`` with the differentiated ones taken from ``diff``."""
    it = iter(diff)
    return [next(it) if m else jnp.asarray(a) for a, m in zip(inputs, mask)]


@pytest.mark.parametrize("slope", [0.0, 0.1])
def test_relu_grad_matches_jax(slope):
    x = _normal(10, (6, 5, 4))
    x.reshape(-1)[::7] = 0.0
    _vjp_both(lambda x: jax_ops.relu(x, slope),
              [lambda x: ops.relu(x, slope),
               lambda x: ops.ReluFn.apply(x, slope)],
              [x], _normal(11, x.shape))


@pytest.mark.parametrize("stride,pad,bias,x_grad", [
    (1, 0, True, True), (1, 2, True, True), (2, 1, False, True),
    (1, 0, True, False)])
def test_conv2d_grad_matches_jax(stride, pad, bias, x_grad):
    """Both lowerings against JAX's; stride 2 takes the plain scatter in
    the hopper Function's backward, and an x that needs no gradient (the
    data under conv1) gets none."""
    x = _normal(12, (2, 3, 9, 9))
    w = _normal(13, (4, 3, 3, 3), 0.3)
    b = _normal(14, (4,), 0.1)
    oh = (9 + 2 * pad - 3) // stride + 1
    cot = _normal(15, (2, 4, oh, oh))
    inputs = [x, w, b] if bias else [x, w]
    mask = [x_grad] + [True] * (len(inputs) - 1)

    def jfn(x, w, b=None):
        return jax_ops.conv2d(x, w, b, stride=stride, pad=pad)

    def pref(x, w, b=None):
        return ops.conv2d(x, w, b, stride=stride, pad=pad)

    def phop(x, w, b=None):
        return ops.Conv2dFn.apply(x, w, b, stride, pad)

    _vjp_both(jfn, [pref, phop], inputs, cot, mask)


@pytest.mark.parametrize("k,s,p,ties", [
    (2, 2, 0, False), (2, 2, 0, True), (2, 2, 1, True), (3, 2, 0, True),
    (3, 2, 1, False), (2, 3, 0, False)])
def test_maxpool_grad_matches_jax(k, s, p, ties):
    """JAX's custom VJPs send a window's gradient to its stored argmax (the
    first maximum of a tie) on both of its backends; so do both of the
    port's lowerings."""
    shape = (2, 3, 9, 9)
    x = _ties(k + s, shape) if ties else _normal(k + s, shape)
    oh = (9 + 2 * p - k) // s + 1
    _vjp_both(lambda x: jax_ops.maxpool(x, k, s, p),
              [lambda x: ops.maxpool(x, k, s, p),
               lambda x: ops.MaxPoolFn.apply(x, k, s, p, True)[0]],
              [x], _normal(16, (2, 3, oh, oh)))


@pytest.mark.parametrize("b,v,outside", [(8, 10, False), (6, 5, True),
                                         (64, 10, True)])
def test_softmax_xent_grad_matches_jax(b, v, outside):
    rng = np.random.default_rng(b)
    logits = _normal(17, (b, v), 3.0)
    y = rng.integers(0, v, b).astype(np.int64)
    if outside:
        y[0], y[1] = -1, v
    # JAX's reference forward wraps -1 to the last class, its Pallas
    # kernel (and the port) gives such a row 0: hold the forward only
    # where all labels are in range, the gradient everywhere
    jaxfn = (lambda lg: jax_ops.softmax_xent_loss(lg, jnp.asarray(y)))
    port = [lambda lg: ops.softmax_xent_loss(lg, _t(y)),
            lambda lg: ops.XentFn.apply(lg, _t(y), True)]
    if not outside:
        _vjp_both(jaxfn, port, [logits], np.float32(1.7))
        return
    with jax_use_backend("pallas"):
        want, vjp = jax.vjp(jaxfn, jnp.asarray(logits))
        (want_g,) = vjp(jnp.float32(1.7))
    for fn in port:
        lg = _t(logits, grad=True)
        out = fn(lg)
        _close(_np(out), np.asarray(want))
        (g,) = torch.autograd.grad(out, [lg], torch.tensor(1.7))
        _close(_np(g), np.asarray(want_g))


def test_avgpool_and_softmax_under_grad():
    """avgpool stays the plain version under autograd on either backend;
    softmax's hopper lowering has no backward: its wrapper refuses a
    tensor that requires grad on the card, and its reference lowering is
    torch autograd (against JAX's)."""
    x = _normal(18, (2, 3, 7, 7))
    _vjp_both(lambda x: jax_ops.avgpool(x, 3, 2),
              [lambda x: ops.avgpool(x, 3, 2)], [x], _normal(19, (2, 3, 3, 3)))
    s = _normal(20, (5, 9))
    with jax_use_backend("reference"):
        want, vjp = jax.vjp(jax_ops.softmax, jnp.asarray(s))
        (wg,) = vjp(jnp.asarray(_normal(21, (5, 9))))
    lg = _t(s, grad=True)
    (g,) = torch.autograd.grad(ops.softmax(lg), [lg], _t(_normal(21, (5, 9))))
    _close(_np(g), wg)


# ---------------------------------------------------------------------------
# the repairs of the reference lowering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad", [0, 1])
def test_reference_maxpool_sends_a_tie_to_the_first_maximum(pad):
    """A 4x4 plane of ones with one 0.5, k = s = 2: torch autograd of
    ``amax`` would split each window's gradient among its tied maxima;
    JAX's ``_maxpool_arg_r`` sends it all to the stored argmax."""
    x = np.ones((1, 1, 4, 4), np.float32)
    x[0, 0, 0, 0] = 0.5
    oh = (4 + 2 * pad - 2) // 2 + 1
    dy = np.arange(1, oh * oh + 1, dtype=np.float32).reshape(1, 1, oh, oh)
    with jax_use_backend("reference"):
        (want,) = jax.jit(lambda x, dy: jax.vjp(
            lambda x: jax_ops.maxpool(x, 2, 2, pad), x)[1](dy))(
                jnp.asarray(x), jnp.asarray(dy))
    xt = _t(x, grad=True)
    (got,) = torch.autograd.grad(ops.maxpool(xt, 2, 2, pad), [xt], _t(dy))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-6)
    # every window's gradient lands whole on one pixel
    assert set(np.unique(_np(got))) <= {0.0} | set(dy.reshape(-1))


def test_reference_xent_gives_an_outside_label_p_over_b():
    """Labels -1 and V: the row's gradient is ``p / B`` (JAX's ``_xent_r``
    and ``softmax_xent_bwd_pallas`` alike), not the 0 of torch autograd
    through ``torch.where``."""
    logits = _normal(22, (3, 5))
    y = np.array([0, -1, 5])
    want = []
    for backend in ("reference", "pallas"):
        with jax_use_backend(backend):
            want.append(np.asarray(jax.grad(
                lambda lg: jax_ops.softmax_xent_loss(lg, jnp.asarray(y)))(
                    jnp.asarray(logits))))
    np.testing.assert_allclose(want[0], want[1], rtol=0, atol=1e-6)
    lg = _t(logits, grad=True)
    (got,) = torch.autograd.grad(ops.softmax_xent_loss(lg, _t(y)), [lg])
    np.testing.assert_allclose(_np(got), want[0], rtol=0, atol=1e-6)
    p = _np(torch.softmax(lg, -1))
    np.testing.assert_allclose(_np(got)[1:], p[1:] / 3, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# each layer's explicit backward against JAX's
# ---------------------------------------------------------------------------

def _layers(**kw):
    return jax_build_layer(jax_spec.LayerSpec(**kw)), \
        build_layer(spec.LayerSpec(**kw))


def _backward_both(kw, bottom_shapes, bottoms, dy_shape, label=None):
    """One layer's forward and explicit backward through JAX and the port
    from JAX's init's params (biases perturbed) and the same top diff."""
    jl, pl = _layers(**kw)
    jp, _ = jl.init(jax.random.PRNGKey(0), bottom_shapes)
    jp = {k: np.asarray(v) + (_normal(23, v.shape, 0.1) if k == "b" else 0)
          for k, v in jp.items()}
    pp = caffe_params_from_jax({"l": jp}, device="cpu").get("l", {})
    jb = [jnp.asarray(b) for b in bottoms]
    pb = [_t(b) for b in bottoms]
    _, pcache = pl.forward(pp, pb, True)
    dy = np.float32(1.3) if dy_shape == () else _normal(24, dy_shape)
    jdiffs, jgrads = jax.jit(lambda p, b, dy: jl.backward(
        p, jl.forward(p, b, True)[1], [dy]))(
            {k: jnp.asarray(v) for k, v in jp.items()}, jb, jnp.asarray(dy))
    pdiffs, pgrads = pl.backward(pp, pcache, [_t(dy)])
    assert len(pdiffs) == len(jdiffs) and set(pgrads) == set(jgrads)
    for g, w in zip(pdiffs, jdiffs):
        assert (g is None) == (w is None)
        if w is not None:
            _close(_np(g), w)
    for k in jgrads:
        _close(_np(pgrads[k]), jgrads[k])


def L(name, type_, bottoms, tops, **kw):
    return dict(name=name, type=type_, bottoms=tuple(bottoms),
                tops=tuple(tops), **kw)


@pytest.mark.parametrize("stride,pad,bias", [(1, 0, True), (1, 2, True),
                                             (2, 1, False)])
def test_convolution_backward(stride, pad, bias):
    oh = (10 + 2 * pad - 5) // stride + 1
    _backward_both(L("c", "Convolution", ["x"], ["y"], num_output=6,
                     kernel_size=5, stride=stride, pad=pad, bias_term=bias),
                   [(2, 3, 10, 10)], [_normal(25, (2, 3, 10, 10))],
                   (2, 6, oh, oh))


def test_inner_product_backward():
    _backward_both(L("ip", "InnerProduct", ["x"], ["y"], num_output=7),
                   [(4, 3, 4, 4)], [_normal(26, (4, 3, 4, 4))], (4, 7))


@pytest.mark.parametrize("pool,k,s,ties", [
    ("max", 2, 2, True), ("max", 3, 2, True), ("max", 3, 2, False),
    ("ave", 3, 2, False), ("ave", 2, 2, False)])
def test_pooling_backward(pool, k, s, ties):
    x = _ties(27, (2, 3, 9, 9)) if ties else _normal(27, (2, 3, 9, 9))
    oh = (9 - k) // s + 1
    _backward_both(L("p", "Pooling", ["x"], ["y"], kernel_size=k, stride=s,
                     pool=pool), [(2, 3, 9, 9)], [x], (2, 3, oh, oh))


@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_relu_backward(slope):
    x = _normal(28, (4, 10))
    x[0, :3] = 0.0
    _backward_both(L("r", "ReLU", ["x"], ["y"], negative_slope=slope),
                   [(4, 10)], [x], (4, 10))


def test_softmax_backward():
    _backward_both(L("s", "Softmax", ["x"], ["y"]), [(4, 10)],
                   [_normal(29, (4, 10), 3.0)], (4, 10))


@pytest.mark.parametrize("loss_weight", [1.0, 0.5])
def test_softmax_with_loss_backward(loss_weight):
    y = np.array([3, 0, 9, 1], np.int32)
    _backward_both(L("l", "SoftmaxWithLoss", ["x", "label"], ["loss"],
                     loss_weight=loss_weight), [(4, 10), (4,)],
                   [_normal(30, (4, 10), 3.0), y], ())


def test_accuracy_backward_is_empty():
    _, pl = _layers(**L("a", "Accuracy", ["x", "label"], ["acc"]))
    assert pl.backward({}, {}, [None]) == ([None, None], {})
