"""The pieces of speculative decoding in the port against the JAX package,
on the CPU: ``pager.release_tail`` over seeded walks (JAX's allocator state
and tables on the real pages, ``[:n_pages]``, and the conservation law at
every step) and the mid-page ``alloc_range`` regression; the two drafters
(``PromptLookupDrafter.propose`` exactly JAX's on seeded buffers;
``HybridSSMDrafter.ingest``/``propose`` with JAX's drafts and its states
within the SSM parity tests' bound); ``prefill_chunk(logits_all=True)``
against JAX's at every real position; the discarded scoring pass
(``lm.score_chunk``) leaving every tensor of the decode state
byte-identical; and the typed config surface: the speculation errors,
``configs_from_flags``, ``from_kwargs`` (round trip, one warning per call
site, unknown keys), the engine's legacy kwargs and ``serve_all``.
"""
import argparse
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jax_lm  # noqa: E402
from repro.serving import SpecConfig as JaxSpecConfig  # noqa: E402
from repro.serving import pager as jpager  # noqa: E402
from repro.serving.drafter import (  # noqa: E402
    HybridSSMDrafter as JaxHybridSSMDrafter,
)
from repro.serving.drafter import (  # noqa: E402
    PromptLookupDrafter as JaxPromptLookupDrafter,
)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    HybridSSMDrafter,
    PromptLookupDrafter,
    ServingEngine,
    SpecConfig,
    configs_from_flags,
    from_kwargs,
    make_drafter,
    pager,
    release_tail,
    serve_all,
    validate_configs,
)

from test_torch_pager import _check_partition  # noqa: E402
from torch_parity import jax_params  # noqa: E402

QWEN, ZAMBA, MAMBA = ("qwen2.5-3b-smoke", "zamba2-2.7b-smoke",
                      "mamba2-2.7b-smoke")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x, dtype=torch.int32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(JAX cfg, JAX params, port cfg, port params) of ``arch``."""
    jcfg, tree, jparams = jax_params(arch=arch)
    return jcfg, jparams, get_arch(arch), params_from_jax(tree, device="cpu")


def _close(got, want, what):
    """The SSM parity tests' bound: within 1e-5 of max(1, max |want|)."""
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), (what, err)


# -- the pager: release_tail ------------------------------------------------

def _same_state(ps, bt, jps, jbt):
    n = jps.free.shape[0]
    assert int(ps.top) == int(jps.top)
    np.testing.assert_array_equal(ps.free[:n].numpy(), np.asarray(jps.free))
    np.testing.assert_array_equal(ps.rc[:n].numpy(), np.asarray(jps.rc))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jbt))


@pytest.mark.parametrize("seed", range(6))
def test_release_tail_walks_match_jax(seed):
    """Seeded walks of the verify step's allocator traffic, both pagers
    side by side: kind 0 maps a drafted chunk at the masked rows'
    frontiers (``alloc_range``, starting mid-page), kind 1 rolls the rows
    back to a random accepted length (``release_tail``, twice, the second
    a no-op), kind 2 releases whole rows.  Equal states, tables and
    conservation after every step."""
    rng = np.random.default_rng(seed)
    n_pages = int(rng.integers(4, 14))
    batch = int(rng.integers(1, 5))
    max_blocks = int(rng.integers(2, 6))
    page = int(rng.integers(1, 5))
    chunk = int(rng.integers(2, 6))
    dev = torch.device("cpu")
    ps, bt = pager.init_pager(n_pages, dev), pager.init_block_table(
        batch, max_blocks, dev)
    jps, jbt = jpager.init_pager(n_pages), jpager.init_block_table(
        batch, max_blocks)
    pos = np.zeros((batch,), np.int32)
    rolled = 0
    for _ in range(int(rng.integers(12, 24))):
        kind = int(rng.choice([0, 0, 1, 1, 2]))
        mask = rng.random(batch) < 0.6
        tm, jm = _t(mask, torch.bool), jnp.asarray(mask)
        if kind == 0:
            end = pos + chunk - 1
            ps, bt = pager.alloc_range(ps, bt, _t(pos), _t(end), tm,
                                       page_size=page, max_chunk=chunk)
            jps, jbt = jpager.alloc_range(
                jps, jbt, jnp.asarray(pos), jnp.asarray(end), jm,
                page_size=page, max_chunk=chunk)
        elif kind == 1:
            front = pos + rng.integers(1, chunk + 1, batch).astype(np.int32)
            for _ in range(2):
                ps, bt = release_tail(ps, bt, _t(front), tm, page_size=page)
                jps, jbt = jpager.release_tail(
                    jps, jbt, jnp.asarray(front), jm, page_size=page)
            rolled += int(mask.any())
            pos = np.where(mask, front, pos)
        else:
            ps, bt = pager.release_rows(ps, bt, tm)
            jps, jbt = jpager.release_rows(jps, jbt, jm)
            pos = np.where(mask, 0, pos)
        _check_partition(ps, bt)
        _same_state(ps, bt, jps, jbt)
    assert rolled


def test_release_tail_returns_the_whole_tail():
    """A frontier of 0 or 1 keeps block 0; everything past the kept block
    goes back, a masked-out row keeps all, and a scalar frontier
    broadcasts."""
    dev = torch.device("cpu")
    ps, bt = pager.init_pager(8, dev), pager.init_block_table(2, 4, dev)
    ps, bt = pager.alloc_range(ps, bt, 0, 15, page_size=4, max_chunk=16)
    assert int(ps.top) == 0
    ps, bt = release_tail(ps, bt, 1, _t([True, False], torch.bool),
                          page_size=4)
    assert bt[0].tolist()[1:] == [-1, -1, -1] and (bt[1] >= 0).all()
    assert int(ps.top) == 3
    _check_partition(ps, bt)


def test_alloc_range_maps_block_crossed_mid_page():
    """JAX's regression: positions 7..8 at page 4 touch blocks 1 and 2; a
    verify chunk starting mid-page crosses into its next block fewer than
    a page after its start, and that block is mapped."""
    dev = torch.device("cpu")
    ps, bt = pager.alloc_range(pager.init_pager(8, dev),
                               pager.init_block_table(1, 4, dev),
                               _t([7]), _t([8]), page_size=4, max_chunk=2)
    assert bt[0, 1] >= 0 and bt[0, 2] >= 0
    assert int(ps.top) == 6


# -- the drafters -------------------------------------------------------------

def _lookup_buffers(case, b, max_len, vocab, rng):
    """(tokens, progress): random rows (rarely a match), rows whose tail
    is a short cycle (period 1-3), and rows whose only earlier match ends
    right before the frontier."""
    tokens = rng.integers(0, vocab, (b, max_len)).astype(np.int32)
    prog = rng.integers(2, max_len - 1, b).astype(np.int32)
    if case == "cycle":
        for r in range(b):
            period = 1 + r % 3
            cyc = rng.integers(0, vocab, period)
            tokens[r, 3:] = np.resize(cyc, max_len - 3)
            prog[r] = max(prog[r], 3 + 2 * period)
    elif case == "frontier":
        for r in range(b):
            p = int(max(prog[r], 4))
            prog[r] = p
            tokens[r, p - 2: p + 1] = tokens[r, p - 3]   # ...x x x at p
    return tokens, prog


@pytest.mark.parametrize("case", ["random", "cycle", "frontier"])
@pytest.mark.parametrize("k,ngram", [(1, 1), (3, 2), (4, 2), (4, 3)])
def test_prompt_lookup_propose_matches_jax(case, k, ngram):
    rng = np.random.default_rng(k * 10 + ngram)
    b, max_len, vocab = 6, 24, 7 if case == "random" else 50
    tokens, prog = _lookup_buffers(case, b, max_len, vocab, rng)
    active = rng.random(b) < 0.8
    got, state = PromptLookupDrafter(SpecConfig(k=k, ngram=ngram)).propose(
        None, {}, _t(tokens, torch.int64), _t(prog, torch.int64),
        _t(active, torch.bool))
    want, _ = JaxPromptLookupDrafter(JaxSpecConfig(k=k, ngram=ngram)).propose(
        None, {}, jnp.asarray(tokens), jnp.asarray(prog), jnp.asarray(active))
    assert state == {} and got.shape == (b, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hybrid_drafter_matches_jax():
    """Two ingestions of the committed tokens (rows behind, caught up and
    in between) and a propose that catches up and drafts 3 steps: JAX's
    drafts exactly, its ``drf_pos``, and its states within the bound; the
    proposal steps leave the committed state as the catch-up left it."""
    jcfg, jparams, cfg, params = _params(ZAMBA)
    b, max_len, k = 3, 20, 3
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (b, max_len)).astype(np.int32)
    jdr = JaxHybridSSMDrafter(JaxSpecConfig(k=k, drafter="hybrid_ssm"), jcfg)
    dr = make_drafter(SpecConfig(k=k, drafter="hybrid_ssm"), cfg)
    assert isinstance(dr, HybridSSMDrafter) and dr.stateful
    jst, st = jdr.init_state(b), dr.init_state(b, torch.device("cpu"))
    assert set(st) == set(jst)
    tt = _t(tokens, torch.int64)

    def same(what):
        np.testing.assert_array_equal(st["drf_pos"].numpy(),
                                      np.asarray(jst["drf_pos"]))
        for key in ("drf_ssm", "drf_conv"):
            _close(st[key].numpy(), jst[key], f"{what} {key}")

    ingest = jax.jit(jdr.ingest, static_argnums=4)
    for upto in ([5, 0, 9], [7, 3, 9]):
        st = dr.ingest(params, st, tt, _t(upto, torch.int64), 4)
        jst = ingest(jparams, jst, jnp.asarray(tokens),
                     jnp.asarray(upto, jnp.int32), 4)
        same(f"ingest {upto}")
    prog = np.array([10, 6, 12])
    active = np.array([True, False, True])
    drafts, st = dr.propose(params, st, tt, _t(prog, torch.int64),
                            _t(active, torch.bool))
    jdrafts, jst = jax.jit(jdr.propose)(jparams, jst, jnp.asarray(tokens),
                                        jnp.asarray(prog, jnp.int32),
                                        jnp.asarray(active))
    np.testing.assert_array_equal(drafts.numpy(), np.asarray(jdrafts))
    same("propose")


def test_hybrid_drafter_requires_hybrid_family():
    with pytest.raises(ValueError, match="family 'hybrid' required"):
        HybridSSMDrafter(SpecConfig(drafter="hybrid_ssm"), get_arch(QWEN))
    with pytest.raises(ValueError, match="family 'hybrid' required"):
        make_drafter(SpecConfig(drafter="hybrid_ssm"), get_arch(MAMBA))
    with pytest.raises(ValueError, match="unknown drafter"):
        make_drafter(argparse.Namespace(drafter="oracle", k=2), None)


# -- the verifier and the discarded pass ------------------------------------

def _states(arch, layout, kv_dtype="f32", b=3, max_len=24):
    jcfg, jparams, cfg, params = _params(arch)
    kw = dict(per_row_pos=True, layout=layout, page_size=4,
              kv_dtype=kv_dtype)
    return (jcfg, jparams, jax_lm.init_decode_state(jcfg, b, max_len, **kw),
            cfg, params, lm.init_decode_state(cfg, b, max_len, device="cpu",
                                              **kw))


def _warm(jcfg, jparams, jst, cfg, params, st, rng, widths=(4, 3, 2)):
    """One chunk of ``widths`` on both sides, so the next one starts
    mid-page."""
    toks = rng.integers(0, cfg.vocab_size, (len(widths), 4)).astype(np.int32)
    w = np.array(widths, np.int32)
    _, jst = jax.jit(jax_lm.prefill_chunk, static_argnums=0)(
        jcfg, jparams, jst, jnp.asarray(toks), jnp.asarray(w))
    _, st = lm.prefill_chunk(cfg, params, st, _t(toks, torch.int64), _t(w))
    return jst, st


@pytest.mark.parametrize("arch,layout", [
    (QWEN, "paged"), (MAMBA, "contiguous"), (ZAMBA, "paged")])
def test_logits_all_matches_jax(arch, layout):
    """A verify-shaped chunk (width 5, per-row widths 5, 2 and 4, the
    middle row inactive) after a first chunk: the (B, C, V) logits at
    every real position of every active row against JAX's, and the last
    real position's equal to the plain call's."""
    jcfg, jparams, jst, cfg, params, st = _states(arch, layout)
    rng = np.random.default_rng(6)
    jst, st = _warm(jcfg, jparams, jst, cfg, params, st, rng)
    toks = rng.integers(0, cfg.vocab_size, (3, 5)).astype(np.int32)
    w = np.array([5, 2, 4], np.int32)
    active = np.array([True, False, True])
    jl, _ = jax.jit(functools.partial(jax_lm.prefill_chunk, logits_all=True),
                    static_argnums=0)(
        jcfg, jparams, jst, jnp.asarray(toks), jnp.asarray(w),
        active=jnp.asarray(active))
    scratch = lm.init_scratch(cfg, st, 5)
    got = lm.score_chunk(cfg, params, st, _t(toks, torch.int64), _t(w),
                         active=_t(active, torch.bool), scratch=scratch)
    logits, _ = lm.prefill_chunk(cfg, params, st, _t(toks, torch.int64),
                                 _t(w), active=_t(active, torch.bool),
                                 logits_all=True)
    assert logits.shape == (3, 5, cfg.vocab_size)
    torch.testing.assert_close(got, logits, rtol=0, atol=0)
    jl = np.asarray(jl)
    for r in np.flatnonzero(active):
        _close(logits[r, : w[r]].numpy(), jl[r, : w[r]], f"row {r}")


@pytest.mark.parametrize("arch,layout,kv_dtype", [
    (MAMBA, "contiguous", "f32"), (ZAMBA, "paged", "f32"),
    (ZAMBA, "paged", "int8"), (ZAMBA, "contiguous", "f32")])
def test_discarded_pass_leaves_state_byte_identical(arch, layout, kv_dtype):
    """``score_chunk`` from mid-page positions, with a row whose chunk maps
    a fresh page, an inactive row and a padded one: every tensor of the
    decode state (pools, int8 scales, ssm/conv, allocator arrays, tables,
    ``pos``) is byte-identical after the pass, and its logits are those
    of the same chunk run in place."""
    _, _, _, cfg, params, st = _states(arch, layout, kv_dtype)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (3, 4)).astype(np.int32)
    _, st = lm.prefill_chunk(cfg, params, st, _t(toks, torch.int64),
                             _t([4, 3, 2]))
    before = {key: t.clone() for key, t in st.items()}
    scratch = lm.init_scratch(cfg, st, 5)
    chunk = _t(rng.integers(0, cfg.vocab_size, (3, 5)), torch.int64)
    w, active = _t([5, 3, 2]), _t([True, True, False], torch.bool)
    got = lm.score_chunk(cfg, params, st, chunk, w, active=active,
                         scratch=scratch)
    for key, t in st.items():
        assert t.dtype == before[key].dtype
        assert torch.equal(t.view(torch.uint8) if t.dtype.is_floating_point
                           else t, before[key].view(torch.uint8)
                           if t.dtype.is_floating_point else before[key]), key
    live = {key: t.clone() for key, t in st.items()}
    want, after = lm.prefill_chunk(cfg, params, live, chunk, w,
                                   active=active, logits_all=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    moved = [key for key in ("ssm", "kp", "k") if key in st
             and not torch.equal(after[key], st[key])]
    assert moved, "the in-place pass wrote nothing to compare against"


# -- the typed config surface -------------------------------------------------

@pytest.mark.parametrize("build,msg", [
    (lambda: SpecConfig(k=0), "spec.k must be >= 1"),
    (lambda: SpecConfig(drafter="oracle"), "unknown drafter"),
    (lambda: SpecConfig(ngram=0), "spec.ngram must be >= 1"),
])
def test_invalid_spec_fields_raise(build, msg):
    with pytest.raises(ValueError, match=msg):
        build()


@pytest.mark.parametrize("cache,config,msg", [
    (CacheConfig(layout="paged"),
     EngineConfig(prefill_chunk=1, spec=SpecConfig()),
     "prefill_chunk must be >= 2"),
    (CacheConfig(layout="paged"),
     EngineConfig(prefill_chunk=4, temperature=1.0, spec=SpecConfig()),
     "greedy-only"),
    (CacheConfig(layout="paged"),
     EngineConfig(prefill_chunk=4, prefix_sharing=True,
                  spec=SpecConfig(drafter="hybrid_ssm")),
     "incompatible with prefix_sharing"),
])
def test_invalid_spec_combinations_raise(cache, config, msg):
    with pytest.raises(ValueError, match=msg):
        validate_configs(cache, config)


def test_configs_from_flags_reads_spec_knobs():
    ns = argparse.Namespace(layout="paged", page_size=8, steps_per_sync=4,
                            prefill_chunk=4, spec_k=3,
                            spec_drafter="prompt_lookup", spec_ngram=2)
    cache, config = configs_from_flags(ns)
    assert cache == CacheConfig(layout="paged", page_size=8)
    assert config.spec == SpecConfig(k=3, ngram=2)
    assert configs_from_flags(argparse.Namespace()) == (CacheConfig(),
                                                        EngineConfig())
    with pytest.raises(ValueError, match="prefill_chunk must be >= 2"):
        configs_from_flags(argparse.Namespace(spec_k=2))


def test_from_kwargs_round_trip():
    cache, config = from_kwargs(
        layout="paged", page_size=8, n_pages=32, snapshots=False,
        steps_per_sync=5, prefill_chunk=4, prefix_sharing=True,
        temperature=0.5, top_k=3, seed=11, prefill_budget=2,
        kv_dtype="int8", spec=SpecConfig(k=2))
    assert cache == CacheConfig(layout="paged", page_size=8, n_pages=32,
                                kv_dtype="int8")
    assert config == EngineConfig(
        steps_per_sync=5, prefill_chunk=4, prefix_sharing=True,
        temperature=0.5, top_k=3, seed=11, prefill_budget=2,
        spec=SpecConfig(k=2))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert from_kwargs() == (CacheConfig(), EngineConfig())


def test_from_kwargs_warns_once_per_call_site():
    def legacy_site():
        return from_kwargs(layout="paged", page_size=4)

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("default")
        legacy_site()
        legacy_site()
    msgs = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(msgs) == 1
    assert "CacheConfig" in str(msgs[0].message)
    assert msgs[0].filename == __file__


def test_from_kwargs_rejects_unknown_keys():
    with pytest.raises(TypeError, match="unknown engine kwargs"):
        from_kwargs(layotu="paged")


@functools.lru_cache(maxsize=None)
def _qwen():
    _, _, cfg, params = _params(QWEN)
    return build_model(cfg, device="cpu"), params


def _reqs(n=2):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 128, int(rng.integers(3, 8))).tolist(), 5)
            for _ in range(n)]


def test_legacy_kwargs_equal_config_objects():
    """An engine built from the kwarg pile serves the tokens of one built
    from the config objects, carries the same configs, and attributes its
    warning to the construction site; mixing both styles is refused."""
    model, params = _qwen()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng = ServingEngine(model, params, batch=2, max_len=24,
                            layout="paged", page_size=4, steps_per_sync=3,
                            prefill_chunk=4)
    assert [w.filename for w in rec
            if issubclass(w.category, DeprecationWarning)] == [__file__]
    typed = ServingEngine(model, params, batch=2, max_len=24,
                          cache=CacheConfig(layout="paged", page_size=4),
                          config=EngineConfig(steps_per_sync=3,
                                              prefill_chunk=4))
    outs = []
    for e in (eng, typed):
        rids = [e.submit(t, g) for t, g in _reqs()]
        got = e.run()
        outs.append([got[r].tolist() for r in rids])
    assert outs[0] == outs[1]
    assert eng.cache == typed.cache and eng.config == typed.config
    with pytest.raises(TypeError, match="not both"):
        ServingEngine(model, params, batch=2, max_len=16,
                      cache=CacheConfig(), layout="paged")


def test_serve_all_branches():
    """``serve_all`` with config objects (speculation on), with the legacy
    pile and with neither: the same tokens, keyed by submission order."""
    model, params = _qwen()
    reqs = _reqs(3)
    typed = serve_all(model, params, reqs, batch=2, max_len=16,
                      config=EngineConfig(steps_per_sync=2, prefill_chunk=4,
                                          spec=SpecConfig(k=2)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = serve_all(model, params, reqs, batch=2, max_len=16,
                           steps_per_sync=2, layout="paged", page_size=4)
    plain = serve_all(model, params, reqs, batch=2, max_len=16,
                      steps_per_sync=2)
    assert sorted(typed) == [0, 1, 2]
    assert ({r: o.tolist() for r, o in typed.items()}
            == {r: o.tolist() for r, o in legacy.items()}
            == {r: o.tolist() for r, o in plain.items()})
