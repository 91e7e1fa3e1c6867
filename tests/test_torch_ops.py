"""The port's op layer on the CPU: each plain PyTorch version against the
JAX Pallas kernel (interpret mode) and the JAX oracle on the same numpy
inputs, at f32 with atol = rtol = 1e-5 (summation order is the only
difference; the attention ops are held to 1e-5 of max |ref|); plus the
backend policy and the op registry."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import registry as jax_registry  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.eltwise import bias_add_rows_pallas  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_decode_paged_pallas,
    flash_decode_pallas,
    flash_prefill_chunk_paged_pallas,
    flash_prefill_chunk_pallas,
)
from repro.kernels.gemm import gemm_pallas  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro_torch.core import policy  # noqa: E402
from repro_torch.core.registry import coverage, list_ops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.eltwise import bias_add_rows  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_decode,
    flash_decode_paged,
    flash_prefill_chunk,
    flash_prefill_chunk_paged,
)
from repro_torch.kernels.gemm import gemm  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, *jax_outs):
    for want in jax_outs:
        np.testing.assert_allclose(port.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,k,n,nt", [
    (4, 64, 128, False),    # a projection at the smoke width
    (3, 50, 70, False),     # ragged edges
    (4, 64, 128, True),     # the tied head: B is embed.T, a strided view
])
def test_gemm_matches_jax(m, k, n, nt):
    rng = np.random.default_rng(0)
    a = _rnd(rng, m, k)
    b = _rnd(rng, n, k).T if nt else _rnd(rng, k, n)
    tb = torch.from_numpy(np.ascontiguousarray(b.T)).T if nt \
        else torch.from_numpy(b)
    got = ref.gemm(torch.from_numpy(a), tb)
    _close(got, gemm_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True),
           jax_ref.gemm(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 64), (1, 48)])
def test_rmsnorm_matches_jax(shape):
    rng = np.random.default_rng(1)
    x = _rnd(rng, *shape)
    w = (1 + 0.1 * _rnd(rng, shape[-1])).astype(np.float32)
    got = ref.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    _close(got,
           rmsnorm_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True),
           jax_ref.rmsnorm(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("m,n", [(4, 64), (3, 16), (7, 130)])
def test_bias_add_rows_matches_jax(m, n):
    rng = np.random.default_rng(2)
    x, v = _rnd(rng, m, n), _rnd(rng, n)
    got = ref.bias_add_rows(torch.from_numpy(x), torch.from_numpy(v))
    _close(got,
           bias_add_rows_pallas(jnp.asarray(x), jnp.asarray(v),
                                interpret=True),
           jax_ref.bias_add_rows(jnp.asarray(x), jnp.asarray(v)))


@pytest.mark.parametrize("lens,window,hkv", [
    ([1, 17, 40], None, 1),      # per-row lengths, GQA group of 4
    ([40, 9, 23], 16, 1),        # sliding window
    (29, None, 2),               # scalar cache_len, two kv heads
])
def test_attention_decode_matches_jax(lens, window, hkv):
    rng = np.random.default_rng(3)
    b, hq, d, smax = 3, 4, 16, 40
    q = _rnd(rng, b, hq, d)
    kc, vc = _rnd(rng, b, smax, hkv, d), _rnd(rng, b, smax, hkv, d)
    cl = np.asarray(lens, np.int32)
    got = ref.attention_decode(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(cl), window=window)
    jq, jk, jv, jl = map(jnp.asarray, (q, kc, vc, cl))
    _close(got,
           flash_decode_pallas(jq, jk, jv, jl, window=window, interpret=True),
           jax_ops._attention_decode_ref(jq, jk, jv, jl, window=window))


def _close_rel(port, *jax_outs, tol=1e-5):
    """max |port - want| <= tol * max |want| for every JAX output."""
    for want in jax_outs:
        want = np.asarray(want)
        err = np.abs(port.numpy() - want).max()
        assert err <= tol * np.abs(want).max(), err


def _paged_case(rng, b, hkv, d, page, maxb, mapped):
    """A pool of ``sum(mapped)`` shuffled pages plus a block table mapping
    ``mapped[i]`` leading blocks of row i (the rest unmapped, -1)."""
    n_pages = sum(mapped) + 1
    kp, vp = _rnd(rng, n_pages, page, hkv, d), _rnd(rng, n_pages, page, hkv, d)
    ids = rng.permutation(n_pages)
    bt = np.full((b, maxb), -1, np.int32)
    at = 0
    for i, n in enumerate(mapped):
        bt[i, :n] = ids[at: at + n]
        at += n
    return kp, vp, bt


# the three attention kernels of the paged + chunked path: GQA group of 4
# (Hkv 1) or 2 (Hkv 2), windows None and 4
ATTN_CASES = [(None, 1), (4, 1), (None, 2), (4, 2)]


@pytest.mark.parametrize("window,hkv", ATTN_CASES)
def test_attention_decode_paged_matches_jax(window, hkv):
    """Per-row lengths, unmapped tail blocks (row 2 maps 3 of 5 blocks);
    every block below a row's length is mapped."""
    rng = np.random.default_rng(10)
    b, hq, d, page, maxb = 3, 4, 16, 4, 5
    kp, vp, bt = _paged_case(rng, b, hkv, d, page, maxb, [5, 2, 3])
    q = _rnd(rng, b, hq, d)
    cl = np.asarray([19, 5, 12], np.int32)
    got = ref.attention_decode_paged(
        *map(torch.from_numpy, (q, kp, vp, cl, bt)), window=window)
    jq, jk, jv, jl, jb = map(jnp.asarray, (q, kp, vp, cl, bt))
    _close_rel(got,
               flash_decode_paged_pallas(jq, jk, jv, jl, jb, window=window,
                                         interpret=True),
               jax_ops._attention_decode_paged_ref(jq, jk, jv, jl, jb,
                                                   window=window))


@pytest.mark.parametrize("window,hkv", ATTN_CASES)
def test_attention_prefill_chunk_matches_jax(window, hkv):
    """Ragged widths: a full chunk, a partial one with padding rows, and a
    width-1 row (a decode-phase row riding along)."""
    rng = np.random.default_rng(11)
    b, c, hq, d, smax = 3, 5, 4, 16, 24
    q = _rnd(rng, b, c, hq, d)
    kc, vc = _rnd(rng, b, smax, hkv, d), _rnd(rng, b, smax, hkv, d)
    start = np.asarray([0, 7, 18], np.int32)
    width = np.asarray([5, 3, 1], np.int32)
    got = ref.attention_prefill_chunk(
        *map(torch.from_numpy, (q, kc, vc, start, width)), window=window)
    jq, jk, jv, js, jw = map(jnp.asarray, (q, kc, vc, start, width))
    _close_rel(got,
               flash_prefill_chunk_pallas(jq, jk, jv, js, jw, window=window,
                                          interpret=True),
               jax_ops._attention_prefill_chunk_ref(jq, jk, jv, js, jw,
                                                    window=window))


@pytest.mark.parametrize("window,hkv", ATTN_CASES)
def test_attention_prefill_chunk_paged_matches_jax(window, hkv):
    """The chunk math through a block table, chunks crossing a page
    boundary, unmapped blocks past each row's chunk."""
    rng = np.random.default_rng(12)
    b, c, hq, d, page, maxb = 3, 5, 4, 16, 4, 6
    kp, vp, bt = _paged_case(rng, b, hkv, d, page, maxb, [2, 3, 6])
    q = _rnd(rng, b, c, hq, d)
    start = np.asarray([0, 7, 20], np.int32)
    width = np.asarray([5, 3, 1], np.int32)
    got = ref.attention_prefill_chunk_paged(
        *map(torch.from_numpy, (q, kp, vp, start, width, bt)), window=window)
    jq, jk, jv, js, jw, jb = map(jnp.asarray, (q, kp, vp, start, width, bt))
    _close_rel(got,
               flash_prefill_chunk_paged_pallas(jq, jk, jv, js, jw, jb,
                                                window=window,
                                                interpret=True),
               jax_ops._attention_prefill_chunk_paged_ref(
                   jq, jk, jv, js, jw, jb, window=window))


def test_ops_switch_layouts():
    """``block_table`` selects the paged lowering in both attention ops,
    and an all-unmapped row still returns finite values (the plain
    version attends to page 0; the kernel returns zeros)."""
    rng = np.random.default_rng(13)
    kp, vp, bt = _paged_case(rng, 2, 1, 8, 4, 3, [2, 0])
    kp, vp, bt = map(torch.from_numpy, (kp, vp, bt))
    q = torch.from_numpy(_rnd(rng, 2, 4, 8))
    cl = torch.tensor([6, 0], dtype=torch.int32)
    got = ops.attention_decode(q, kp, vp, torch.tensor([6, 1]),
                               block_table=bt)
    assert torch.equal(got, ref.attention_decode_paged(
        q, kp, vp, torch.tensor([6, 1]), bt))
    assert torch.isfinite(ref.attention_decode_paged(q, kp, vp, cl + 1,
                                                     bt)).all()
    qc = torch.from_numpy(_rnd(rng, 2, 3, 4, 8))
    kc = torch.from_numpy(_rnd(rng, 2, 8, 1, 8))
    assert torch.equal(ops.attention_prefill_chunk(qc, kc, kc, 2, 3),
                       ref.attention_prefill_chunk(qc, kc, kc, 2, 3))
    assert torch.equal(
        ops.attention_prefill_chunk(qc, kp, vp, 2, 3, block_table=bt),
        ref.attention_prefill_chunk_paged(qc, kp, vp, 2, 3, bt))


def test_wrappers_take_plain_version_on_cpu():
    """A kernel wrapper given CPU tensors computes its plain version (the
    CUDA kernel only ever sees CUDA tensors)."""
    rng = np.random.default_rng(4)
    a, b = torch.from_numpy(_rnd(rng, 3, 8)), torch.from_numpy(_rnd(rng, 8, 5))
    w = torch.from_numpy(_rnd(rng, 8))
    q = torch.from_numpy(_rnd(rng, 2, 4, 8))
    kc = torch.from_numpy(_rnd(rng, 2, 6, 1, 8))
    assert torch.equal(gemm(a, b), ref.gemm(a, b))
    assert torch.equal(rmsnorm(a, w), ref.rmsnorm(a, w))
    assert torch.equal(bias_add_rows(a, w), ref.bias_add_rows(a, w))
    assert torch.equal(flash_decode(q, kc, kc, 4),
                       ref.attention_decode(q, kc, kc, 4))
    bt = torch.tensor([[1, 0], [-1, -1]], dtype=torch.int32)
    pool = torch.from_numpy(_rnd(rng, 3, 4, 1, 8))
    qc = torch.from_numpy(_rnd(rng, 2, 3, 4, 8))
    assert torch.equal(flash_decode_paged(q, pool, pool, 5, bt),
                       ref.attention_decode_paged(q, pool, pool, 5, bt))
    assert torch.equal(flash_prefill_chunk(qc, kc, kc, 1, 2),
                       ref.attention_prefill_chunk(qc, kc, kc, 1, 2))
    assert torch.equal(flash_prefill_chunk_paged(qc, pool, pool, 2, 3, bt),
                       ref.attention_prefill_chunk_paged(qc, pool, pool, 2,
                                                         3, bt))
    assert gemm.launches == rmsnorm.launches == 0
    assert bias_add_rows.launches == flash_decode.launches == 0
    assert flash_decode_paged.launches == flash_prefill_chunk.launches == 0
    assert flash_prefill_chunk_paged.launches == 0


def test_policy_device_decides():
    """auto: the tensor's device decides; hopper on a CPU tensor raises;
    reference is always allowed; the scoped stack beats the default."""
    x = torch.ones(2, 4)
    w = torch.ones(4)
    assert not policy.use_hopper(x)
    with policy.use_backend("hopper"):
        with pytest.raises(RuntimeError, match="needs CUDA tensors"):
            ops.rmsnorm(x, w)
        with policy.use_backend("reference"):
            assert policy.current_backend() is policy.Backend.REFERENCE
            assert torch.equal(ops.rmsnorm(x, w), ref.rmsnorm(x, w))
    assert policy.current_backend() is policy.Backend.AUTO
    with pytest.raises(ValueError, match="unknown backend"):
        policy.Backend.parse("pallas")


def test_policy_env_and_default(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BACKEND", "reference")
    assert policy.current_backend() is policy.Backend.REFERENCE
    # the JAX package's variable means nothing to the port
    monkeypatch.delenv("REPRO_TORCH_BACKEND")
    monkeypatch.setenv("REPRO_BACKEND", "pallas")
    assert policy.current_backend() is policy.Backend.AUTO
    policy.set_default_backend("hopper")
    try:
        assert policy.current_backend() is policy.Backend.HOPPER
        with pytest.raises(RuntimeError):
            ops.matmul(torch.ones(1, 2), torch.ones(2, 3))
    finally:
        policy.set_default_backend(None)


def test_registry_covers_the_slice():
    cov = coverage()
    hopper = {"matmul", "bias_add_rows", "rmsnorm", "attention_decode",
              "attention_decode_paged", "attention_prefill_chunk",
              "attention_prefill_chunk_paged",
              "attention_decode_paged_quant",
              "attention_prefill_chunk_paged_quant", "attention",
              "ssd_scan", "ssd_prefill_chunk", "relu", "im2col", "col2im",
              "conv2d", "conv2d_direct", "maxpool", "softmax",
              "softmax_xent"}
    # reference-only, as in JAX's registry
    reference_only = {"avgpool", "accuracy", "layernorm"}
    assert set(cov) == hopper | reference_only
    assert all(cov[n] == {"reference": True, "hopper": True} for n in hopper)
    assert all(cov[n] == {"reference": True, "hopper": False}
               for n in reference_only)
    # the port's op names are the JAX registry's, all 23 of them, with the
    # same reference-only set
    jax_ops = jax_registry.list_ops()
    assert set(list_ops()) == set(jax_ops) and len(jax_ops) == 23
    assert reference_only == {n for n in cov if jax_ops[n].reference_only}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """The reference-only op against JAX's ``ref.layernorm``: f32
    statistics, the normalised value cast to x's dtype, then ``* w + b``.
    f32 within 1e-6 of the largest magnitude; bf16 within one bf16 ulp of
    it (2**-7: the f32 statistics in another order may move a rounding)."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((6, 40)).astype(np.float32) * 3 + 1
    w = (1 + 0.1 * rng.standard_normal(40)).astype(np.float32)
    b = (0.1 * rng.standard_normal(40)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jax_ref.layernorm(
        *(jnp.asarray(a, jdt) for a in (x, w, b))).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = ops.layernorm(*(torch.from_numpy(a).to(tdt) for a in (x, w, b)))
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
