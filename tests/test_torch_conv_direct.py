"""The direct convolution's plain PyTorch version on the CPU against the
JAX package: ``ref.conv2d_direct`` against JAX's ``conv2d_direct_pallas``
(interpret mode, as ``tests/test_kernels_conv_direct.py`` runs it) and
JAX's oracle ``ref.conv2d``, at that file's cases and the five LeNet
convolutions at batch 2; the op's dispatch on CPU tensors; and the
traffic the port counts for the kernel's bound against the im2col form's
column matrix.

Tolerances.  f32: within 1e-6 of the output's largest magnitude of the
Pallas kernel, whose per-shift order the plain version repeats (they agree
bit for bit at most shapes); within 2e-6 of it of the oracle, which sums
all C*KH*KW products in one dot in another order (JAX's Pallas kernel is
itself 1.16e-6 of the scale from its oracle at MNIST conv2, 500 products).
bf16 within one bf16 ulp at the largest magnitude (2**-7 of it): both
sides accumulate the same bf16 products in f32 and round once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.conv_direct import conv2d_direct_pallas  # noqa: E402
from repro_torch.core.policy import use_backend  # noqa: E402
from repro_torch.core.registry import get_op  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.conv_direct import conv2d_direct, cost  # noqa: E402

# (n, c, h = w, f, k, stride, pad): tests/test_kernels_conv_direct.py's
# cases, then the LeNet convolutions (MNIST conv1, conv2; CIFAR conv1,
# conv2, conv3) at batch 2
JAX_CASES = [(2, 3, 12, 4, 3, 1, 1), (1, 1, 28, 20, 5, 1, 0),
             (2, 4, 10, 8, 3, 2, 1), (1, 2, 8, 3, 2, 2, 0),
             (2, 3, 9, 5, 3, 3, 0), (1, 3, 16, 160, 5, 1, 2)]
LENET = [(2, 1, 28, 20, 5, 1, 0), (2, 20, 12, 50, 5, 1, 0),
         (2, 3, 32, 32, 5, 1, 2), (2, 32, 15, 32, 5, 1, 2),
         (2, 32, 7, 64, 5, 1, 2)]


def _inputs(seed, n, c, h, f, k, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, h, h)).astype(np.float32)
    w = (rng.standard_normal((f, c, k, k)) * (c * k * k) ** -0.5).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(f)).astype(np.float32) if bias else None
    return x, w, b


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize(
    "n,c,h,f,k,s,p,bias",
    [case + (True,) for case in JAX_CASES + LENET]
    # tests/test_kernels_conv_direct.py's case without a bias
    + [(2, 3, 8, 4, 3, 1, 1, False)],
)
def test_ref_matches_pallas_and_oracle(n, c, h, f, k, s, p, bias):
    x, w, b = _inputs(0, n, c, h, f, k, bias)
    got = ref.conv2d_direct(_t(x), _t(w), _t(b), stride=s, pad=p).numpy()
    want_p = np.asarray(conv2d_direct_pallas(x, w, b, stride=s, pad=p))
    want = np.asarray(jax_ref.conv2d(x, w, b, stride=s, pad=p))
    assert got.shape == want.shape == want_p.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want_p, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        conv2d_direct(_t(x), _t(w), _t(b), stride=s, pad=p).numpy(), got)


def test_ref_bf16_within_one_ulp_of_pallas():
    x, w, b = _inputs(1, 2, 32, 15, 32, 5)
    xb, wb, bb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    want = np.asarray(conv2d_direct_pallas(xb, wb, bb, stride=1, pad=2)
                      .astype(jnp.float32))
    tb = [torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16()
          for a in (xb, wb, bb)]
    got = ref.conv2d_direct(*tb, stride=1, pad=2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("backend", ["reference", "auto"])
def test_op_on_cpu_takes_the_reference_lowering(backend):
    """Registered as JAX registers it: ``reference=ref.conv2d`` and the
    kernel's wrapper; a CPU tensor resolves to the reference lowering under
    either backend that admits it, and the hopper backend refuses it."""
    entry = get_op("conv2d_direct")
    assert entry.reference is ref.conv2d and entry.hopper is conv2d_direct
    x, w, b = (_t(a) for a in _inputs(2, 2, 4, 10, 8, 3))
    with use_backend(backend):
        got = ops.conv2d_direct(x, w, b, stride=2, pad=1)
    want = ref.conv2d_direct(x, w, b, stride=2, pad=1)
    assert torch.equal(got, ref.conv2d(x, w, b, stride=2, pad=1))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * want.abs().max().item())
    with use_backend("hopper"), pytest.raises(RuntimeError,
                                              match="CUDA tensors"):
        ops.conv2d_direct(x, w, b, stride=2, pad=1)
    # the plain version ran: no kernel launch was counted
    assert conv2d_direct.launches == 0


def test_traffic_never_carries_the_column_matrix():
    """At the JAX bytes test's shape (4x8x28x28, F 32, 5x5, pad 2): the
    bytes the port counts for the kernel's bound are under a quarter of
    the column matrix the im2col form materializes, and below JAX's
    analytic floor, which reads a padded copy of x."""
    n, c, h, f, k, p = 4, 8, 28, 32, 5, 2
    nbytes, flops, col_bytes = cost((n, c, h, h), (f, c, k, k), 1, p, 4)
    assert col_bytes == n * c * k * k * h * h * 4
    assert nbytes == (n * c * h * h + f * c * k * k + n * f * h * h
                      + f) * 4
    assert flops == 2.0 * n * f * c * k * k * h * h
    jax_floor = (n * c * (h + 2 * p) ** 2 + f * c * k * k
                 + n * f * h * h) * 4
    assert nbytes < 0.25 * col_bytes
    assert nbytes - 4 * f < jax_floor
