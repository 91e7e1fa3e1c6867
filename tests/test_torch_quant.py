"""The port's int8 and bf16 paged KV pools on the CPU against the JAX
package: the quantized page writes bit for bit (payload and scales on the
real pages), the plain quantized attention against ``repro.kernels.ops``'s
oracles (1e-5), the model's steps over a quantized pool against
``repro.models.lm``, and engine token lists, step counts, peak pages and
resident KV bytes against ``repro.serving`` (int8 against JAX's int8,
never against f32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import use_backend  # noqa: E402
from repro.kernels.ops import (  # noqa: E402
    _attention_decode_paged_quant_ref,
    _attention_prefill_chunk_paged_quant_ref,
)
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import pager as JP  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import _to_tensor, params_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    ServingEngine,
)
from repro_torch.serving import pager as PG  # noqa: E402

from torch_parity import jax_params, requests  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _pools(n_pages, page, hkv, hd):
    """An empty int8 pool and its scales: JAX's (n_pages, ...) and the
    port's with the trailing sentinel page."""
    j = (jnp.zeros((n_pages, page, hkv, hd), jnp.int8),
         jnp.zeros((n_pages, hkv), jnp.float32))
    t = (torch.zeros((n_pages + 1, page, hkv, hd), dtype=torch.int8),
         torch.zeros((n_pages + 1, hkv), dtype=torch.float32))
    return j, t


def _bit_equal(tpool, tsc, jpool, jsc, what):
    n = jpool.shape[0]
    np.testing.assert_array_equal(tpool[:n].numpy(), np.asarray(jpool),
                                  err_msg=what)
    np.testing.assert_array_equal(tsc[:n].numpy().view(np.int32),
                                  np.asarray(jsc).view(np.int32),
                                  err_msg=what)


# ---------------------------------------------------------------------------
# the quantized page writes, bit for bit
# ---------------------------------------------------------------------------

def test_write_page_quant_bit_equal_to_jax():
    """Decode writes over 12 positions of 3 rows: every page is reset at
    its slot 0, the scale grows (the inputs' magnitude rises step by step,
    so written slots are requantized), a row sits out some steps, one row
    writes past its last mapped block (dropped), and rows start mid-page."""
    n_pages, page, hkv, hd, b, maxb = 12, 4, 2, 8, 3, 5
    (jpool, jsc), (tpool, tsc) = _pools(n_pages, page, hkv, hd)
    bt = np.full((b, maxb), -1, np.int32)
    bt[0, :3] = [3, 1, 2]
    bt[1, :4] = [4, 5, 0, 6]
    bt[2, :2] = [7, 8]
    rng = np.random.default_rng(0)
    grew = 0
    for t in range(12):
        new = (rng.standard_normal((b, hkv, hd)) * (1 + 0.5 * t)).astype(
            np.float32)
        idx = np.array([t, t + 2, t + 1], np.int32)
        act = np.array([True, t % 4 != 2, True])
        before = tsc.clone()
        jpool, jsc = JP.write_page_quant(jpool, jsc, jnp.asarray(new),
                                         jnp.asarray(bt), jnp.asarray(idx),
                                         jnp.asarray(act))
        PG.write_page_quant(tpool, tsc, torch.from_numpy(new),
                            torch.from_numpy(bt), torch.from_numpy(idx),
                            torch.from_numpy(act))
        _bit_equal(tpool, tsc, jpool, jsc, f"step {t}")
        grew += int((tsc[:n_pages] > before[:n_pages]).logical_and(
            before[:n_pages] > 0).sum())
    assert grew > 0                     # requantization really ran
    assert tpool[:n_pages].abs().max() == 127
    assert not tpool[9:n_pages].any()   # unmapped pages never written


def test_write_page_chunk_quant_bit_equal_to_jax():
    """Chunk writes of width up to C = 6 over pages of 4: chunks straddle
    two and three pages, start mid-page (max-merge) and at slot 0 (reset),
    carry padding past their width, and come from inactive rows."""
    n_pages, page, hkv, hd, b, maxb, c = 14, 4, 2, 8, 3, 6, 6
    (jpool, jsc), (tpool, tsc) = _pools(n_pages, page, hkv, hd)
    bt = np.full((b, maxb), -1, np.int32)
    bt[0, :5] = [2, 9, 4, 1, 11]
    bt[1, :6] = [0, 3, 5, 6, 7, 8]
    bt[2, :2] = [10, 12]
    rng = np.random.default_rng(1)
    schedule = [  # (start, width, active)
        ([0, 0, 0], [6, 3, 1], [True, True, True]),
        ([6, 3, 1], [3, 6, 4], [True, True, False]),
        ([9, 9, 1], [5, 6, 6], [True, True, True]),
        ([14, 15, 7], [1, 6, 2], [True, False, True]),
    ]
    for n, (start, width, act) in enumerate(schedule):
        new = (rng.standard_normal((b, c, hkv, hd)) * (1 + n)).astype(
            np.float32)
        args = [np.asarray(start, np.int32), np.asarray(width, np.int32),
                np.asarray(act)]
        jpool, jsc = JP.write_page_chunk_quant(
            jpool, jsc, jnp.asarray(new), jnp.asarray(bt),
            *map(jnp.asarray, args))
        PG.write_page_chunk_quant(tpool, tsc, torch.from_numpy(new),
                                  torch.from_numpy(bt),
                                  *map(torch.from_numpy, args))
        _bit_equal(tpool, tsc, jpool, jsc, f"chunk {n}")
    assert not tpool[13:n_pages].any()


# ---------------------------------------------------------------------------
# the plain quantized attention against the JAX oracles
# ---------------------------------------------------------------------------

def _quant_pool(rng, n_pages, page, hkv, d):
    """``tests/test_kv_quant.py``'s pool: random int8 payload and scales
    spread enough that a wrong page or head shows."""
    kp = rng.integers(-127, 128, (n_pages, page, hkv, d)).astype(np.int8)
    sc = rng.uniform(0.01, 0.1, (n_pages, hkv)).astype(np.float32)
    return kp, sc


def _case(seed, b, c, maxb, n_blocks):
    """Inputs at ``tests/test_kv_quant.py``'s shapes: hq 4, hkv 2, d 8,
    pages of 4, 12 pages, rows mapping the first ``n_blocks[i]`` blocks."""
    hq, hkv, d, page, n_pages = 4, 2, 8, 4, 12
    rng = np.random.default_rng(seed)
    shape = (b, hq, d) if c is None else (b, c, hq, d)
    q = rng.normal(size=shape).astype(np.float32)
    kp, ksc = _quant_pool(rng, n_pages, page, hkv, d)
    vp, vsc = _quant_pool(rng, n_pages, page, hkv, d)
    bt = np.full((b, maxb), -1, np.int32)
    at = 0
    for i, n in enumerate(n_blocks):
        bt[i, :n] = np.arange(at, at + n)
        at += n
    return q, kp, vp, ksc, vsc, bt


@pytest.mark.parametrize("window", [None, 6])
def test_decode_quant_plain_matches_jax_oracle(window):
    q, kp, vp, ksc, vsc, bt = _case(0, 3, None, 8, [2, 3, 5])
    cache_len = np.array([5, 9, 17], np.int32)
    want = _attention_decode_paged_quant_ref(
        *map(jnp.asarray, (q, kp, vp, ksc, vsc, cache_len, bt)),
        window=window)
    args = list(map(torch.from_numpy, (q, kp, vp, ksc, vsc, cache_len, bt)))
    got = ref.attention_decode_paged_quant(*args, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the wrapper and the op take the plain version on CPU tensors
    q_, kp_, vp_, ksc_, vsc_, cl_, bt_ = args
    assert torch.equal(FA.flash_decode_paged_quant(
        q_, kp_, vp_, ksc_, vsc_, cl_, bt_, window=window), got)
    assert torch.equal(ops.attention_decode(
        q_, kp_, vp_, cl_, block_table=bt_, kv_scales=(ksc_, vsc_),
        window=window), got)


@pytest.mark.parametrize("window", [None, 6])
def test_prefill_chunk_quant_plain_matches_jax_oracle(window):
    """Per-row starts and widths, padding rows included."""
    q, kp, vp, ksc, vsc, bt = _case(1, 3, 5, 8, [2, 3, 6])
    start = np.array([0, 7, 20], np.int32)
    width = np.array([5, 3, 1], np.int32)
    want = _attention_prefill_chunk_paged_quant_ref(
        *map(jnp.asarray, (q, kp, vp, ksc, vsc, start, width, bt)),
        window=window)
    args = list(map(torch.from_numpy,
                    (q, kp, vp, ksc, vsc, start, width, bt)))
    got = ref.attention_prefill_chunk_paged_quant(*args, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    q_, kp_, vp_, ksc_, vsc_, s_, w_, bt_ = args
    assert torch.equal(FA.flash_prefill_chunk_paged_quant(
        q_, kp_, vp_, ksc_, vsc_, s_, w_, bt_, window=window), got)
    assert torch.equal(ops.attention_prefill_chunk(
        q_, kp_, vp_, s_, w_, block_table=bt_, kv_scales=(ksc_, vsc_),
        window=window), got)


def test_kv_scales_on_the_contiguous_slab_raise():
    q = torch.zeros(2, 4, 8)
    cache = torch.zeros(2, 8, 2, 8)
    sc = (torch.ones(2, 2), torch.ones(2, 2))
    with pytest.raises(ValueError, match="contiguous slab is never"):
        ops.attention_decode(q, cache, cache, 3, kv_scales=sc)
    with pytest.raises(ValueError, match="contiguous slab is never"):
        ops.attention_prefill_chunk(q[:, None], cache, cache, 0, 1,
                                    kv_scales=sc)


_F32, _BF16, _I8 = torch.float32, torch.bfloat16, torch.int8


@pytest.mark.parametrize("q_dt,kv_dt,scales,paged,ok", [
    (_F32, _F32, False, False, True),
    (_BF16, _BF16, False, False, True),
    (_F32, _BF16, False, True, True),
    (_F32, _I8, True, True, True),
    (_BF16, _I8, True, True, True),
    # the contiguous slab keeps one dtype for q and K/V
    (_F32, _BF16, False, False, False),
    (_F32, _I8, True, False, False),
    # nothing else on the pool either
    (_BF16, _F32, False, True, False),
    (_F32, _I8, False, True, False),
    (_F32, _BF16, True, True, False),
])
def test_attention_check_admits_only_the_served_dtypes(q_dt, kv_dt, scales,
                                                       paged, ok):
    """The kernels' argument check (pure shape and dtype logic, no
    launch): a narrower K/V than the query's only on a paged pool, int8
    only there and only with its f32 scales."""
    q4 = torch.zeros(2, 1, 4, 8, dtype=q_dt)
    kv = torch.zeros(3, 4, 2, 8, dtype=kv_dt)
    sc = (torch.ones(3, 2), torch.ones(3, 2)) if scales else None
    if ok:
        FA._check("attn", q4, kv, kv, sc, paged=paged)
    else:
        with pytest.raises((TypeError, ValueError)):
            FA._check("attn", q4, kv, kv, sc, paged=paged)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(kv_dtype="int8"), "layout='paged' required for kv_dtype='int8'"),
    (dict(kv_dtype="bf16"), "layout='paged' required for kv_dtype='bf16'"),
    (dict(snapshots=True), "snapshots use page-boundary granularity"),
])
def test_cache_config_value_errors_match_jax(kw, match):
    """The JAX package's two ValueErrors: sub-f32 storage and snapshots
    need the paged layout (same messages)."""
    msgs = []
    for cls in (JaxCacheConfig, CacheConfig):
        with pytest.raises(ValueError, match=match) as err:
            cls(**kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    if "kv_dtype" in kw:
        assert CacheConfig(layout="paged", **kw).kv_dtype == kw["kv_dtype"]


# ---------------------------------------------------------------------------
# the model's steps over a quantized or half-width pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_and_decode_over_quantized_pool_match_jax(kv_dtype):
    """Ragged chunks (page 4, chunk 4 starting mid-page), decode steps with
    a row sitting out, a release and a refill: the logits, clocks, block
    tables and the pool's dtype equal JAX's.  The bf16 pool is held to
    JAX's Pallas kernels (interpret mode), which read it as the port does,
    upcast to f32 (JAX's oracle, written for one dtype, rounds p to the
    pool's bf16 instead); the int8 pool to JAX's oracles, which dequantize
    to f32.  Logits are compared on the active rows: an idle row's query
    may reach an unmapped block, which the oracles read as page 0 and the
    kernels mask.  The two sides' new K/V differ
    in the last f32 bit, which can move a stored value across a rounding
    boundary, and a later layer's K/V would carry the difference on.  So
    after every call the pools are compared within one storage step (one
    int8 level, one bf16 ulp) and then the port takes JAX's pools, so that
    each call starts from the same cache.  int8 logits are held at 1e-5;
    bf16 logits within one bf16 step (2^-7) of their largest magnitude,
    which is what one stored element a bf16 ulp apart moves them by
    (measured 4.5e-4 of 0.2 at one call)."""
    arch = "qwen2.5-3b-smoke"
    jcfg, tree, jparams = jax_params(seed=4, arch=arch)

    def jax(fn, *args, **kw):
        with use_backend("pallas" if kv_dtype == "bf16" else "reference"):
            return fn(jcfg, *args, **kw)

    cfg = get_arch(arch)
    params = params_from_jax(tree, device="cpu")
    b, max_len, c = 3, 24, 4
    kw = dict(layout="paged", page_size=4, kv_dtype=kv_dtype)
    jstate = jax_lm.init_decode_state(jcfg, b, max_len, per_row_pos=True,
                                      **kw)
    state = lm.init_decode_state(cfg, b, max_len, per_row_pos=True,
                                 device="cpu", **kw)
    assert state["kp"].dtype == {"bf16": torch.bfloat16,
                                 "int8": torch.int8}[kv_dtype]
    assert ("ksc" in state) == ("ksc" in jstate) == (kv_dtype == "int8")
    rng = np.random.default_rng(8)

    def close(logits, jlogits, act=(True,) * b):
        want = np.asarray(jlogits)[list(act)]
        tol = TOL if kv_dtype == "int8" else dict(
            rtol=0, atol=2 ** -7 * np.abs(want).max())
        np.testing.assert_allclose(logits.numpy()[list(act)], want, **tol)

    def same():
        np.testing.assert_array_equal(state["pos"].numpy(),
                                      np.asarray(jstate["pos"]))
        np.testing.assert_array_equal(state["block_table"].numpy(),
                                      np.asarray(jstate["block_table"]))
        n = jstate["kp"].shape[1]
        for key in ("kp", "vp"):
            got = state[key][:, :n].float().numpy()
            want = np.asarray(jstate[key]).astype(np.float32)
            if kv_dtype == "int8":
                assert np.abs(got - want).max() <= 1
            else:
                # one bf16 step: 2^-7 of the value at most
                np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
        if kv_dtype == "int8":
            for key in ("ksc", "vsc"):
                np.testing.assert_allclose(state[key][:, :n].numpy(),
                                           np.asarray(jstate[key]), **TOL)
        for key in ("kp", "vp", "ksc", "vsc"):
            if key in state:
                state[key][:, :n] = _to_tensor(jstate[key], "cpu")

    for widths, act in (([4, 3, 1], [True, True, True]),
                        ([2, 4, 4], [True, False, True])):
        toks = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
        w, a = np.asarray(widths, np.int32), np.asarray(act)
        jlogits, jstate = jax(jax_lm.prefill_chunk, jparams, jstate,
                              jnp.asarray(toks), jnp.asarray(w),
                              active=jnp.asarray(a))
        logits, state = lm.prefill_chunk(
            cfg, params, state, torch.from_numpy(toks), torch.from_numpy(w),
            active=torch.from_numpy(a))
        close(logits, jlogits, a)
        same()
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        a = np.array([True, step != 1, True])
        jlogits, jstate = jax(jax_lm.decode_step, jparams, jstate,
                              jnp.asarray(tok), active=jnp.asarray(a))
        logits, state = lm.decode_step(cfg, params, state,
                                       torch.from_numpy(tok),
                                       active=torch.from_numpy(a))
        close(logits, jlogits, a)
        same()
    mask = np.array([False, True, False])
    jstate = jax(jax_lm.reset_decode_rows, jstate, jnp.asarray(mask))
    state = lm.reset_decode_rows(cfg, state, torch.from_numpy(mask))
    same()
    toks = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    w = np.asarray([1, 4, 2], np.int32)
    jlogits, jstate = jax(jax_lm.prefill_chunk, jparams, jstate,
                          jnp.asarray(toks), jnp.asarray(w))
    logits, state = lm.prefill_chunk(cfg, params, state,
                                     torch.from_numpy(toks),
                                     torch.from_numpy(w))
    close(logits, jlogits)
    same()


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

MAX_LEN = 24
ENGINE_CASES = [(arch, kv, chunk)
                for arch in ("qwen2.5-3b-smoke", "zamba2-2.7b-smoke")
                for kv in ("bf16", "int8") for chunk in (1, 4)]


def _engine(cls, cache_cls, cfg_cls, model, params, kv_dtype, chunk):
    return cls(model, params, batch=4, max_len=MAX_LEN,
               cache=cache_cls(layout="paged", page_size=4,
                               kv_dtype=kv_dtype),
               config=cfg_cls(steps_per_sync=3, prefill_chunk=chunk))


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX engine run per case, shared by the tests (memoized)."""
    cache = {}

    def run(arch, kv_dtype, chunk):
        if (arch, kv_dtype, chunk) not in cache:
            jcfg, tree, jparams = jax_params(arch=arch)
            reqs = requests(6, 2, 12, 3, 8, jcfg.vocab_size, seed=21)
            jeng = _engine(JaxServingEngine, JaxCacheConfig,
                           JaxEngineConfig, jax_build_model(jcfg), jparams,
                           kv_dtype, chunk)
            rids = [jeng.submit(t, g) for t, g in reqs]
            cache[arch, kv_dtype, chunk] = (tree, reqs, rids, jeng.run(),
                                            jeng.stats())
        return cache[arch, kv_dtype, chunk]
    return run


@pytest.mark.parametrize("arch,kv_dtype,chunk", ENGINE_CASES)
def test_engine_over_quantized_pool_matches_jax_engine(jax_runs, arch,
                                                       kv_dtype, chunk):
    """Prompts of 2-12 tokens and 3-8 generated over a bf16 or int8 pool:
    identical token lists, prefill and decode steps, prompt tokens, peak
    pages and resident KV bytes (int8: a quarter of the f32 pool's).  The
    JAX engine runs its oracles: over a bf16 pool they round p to bf16
    where the port (like JAX's kernels) keeps it f32, a difference that
    moves no token here."""
    tree, reqs, jrids, want, jstats = jax_runs(arch, kv_dtype, chunk)
    model = build_model(get_arch(arch), device="cpu")
    eng = _engine(ServingEngine, CacheConfig, EngineConfig, model,
                  params_from_jax(tree, device="cpu"), kv_dtype, chunk)
    rids = [eng.submit(t, g) for t, g in reqs]
    got = eng.run()
    assert rids == list(jrids)
    for rid in rids:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    s = eng.stats()
    keys = ["prefill_steps", "decode_steps", "prompt_tokens",
            "generated_tokens", "kv_pages", "kv_pages_peak",
            "kv_resident_bytes_peak"]
    assert {k: s[k] for k in keys} == {k: jstats[k] for k in keys}
    assert (s["prefill_steps"] > 0) == (chunk > 1)
    assert eng._mstate["kp"].dtype == {"bf16": torch.bfloat16,
                                       "int8": torch.int8}[kv_dtype]
    cfg = model.cfg
    stacks = (cfg.n_layers if cfg.family == "dense"
              else cfg.n_layers // cfg.attn_every)
    per_page = 2 * stacks * 4 * cfg.n_kv_heads * cfg.head_dim_
    assert s["kv_resident_bytes_peak"] == s["kv_pages_peak"] * per_page * (
        2 if kv_dtype == "bf16" else 1)
    assert int(eng._mstate["page_top"]) == eng.n_pages and not eng.busy()
