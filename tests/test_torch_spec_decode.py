"""Speculative decoding in the port against the JAX package, on the CPU.

The setup of ``tests/test_spec_decode.py``: f32 smoke configs (moe with
``capacity_factor`` at its expert count, so a verify step routing B·(K+1)
tokens drops none), batch 2, ``max_len`` 24, ``steps_per_sync`` 3, chunk 4,
page 4, four requests of 3-7 tokens.  Each cell serves the same params
(``convert.params_from_jax``) through JAX's engine and the port's with the
same ``SpecConfig``: the port must give JAX's token streams, its
``spec_proposed``/``spec_accepted``/``spec_emitted``, its step, prompt and
peak-page counts, and return every page at the end.  Where JAX's streams
are plain greedy decode's (every pool but int8, whose scales the rejected
drafts' K/V move, in JAX as here), the port's spec streams must also equal
its own plain greedy streams.  Cells: dense under both layouts, moe paged,
the hybrid with its own Mamba drafter under both layouts and with prompt
lookup, mamba2's two-pass verify, the int8 pool for dense and for the
hybrid drafter, spec beside prefix sharing, spec under pressure (dense,
and the hybrid drafter, whose ``drf_*`` state rides a spill and a
restore), and the repetitive tail whose drafts are accepted at k 4.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import SpecConfig as JaxSpecConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    ServingEngine,
    SpecConfig,
)

from torch_parity import jax_params  # noqa: E402

QWEN, MOE, ZAMBA, MAMBA = ("qwen2.5-3b", "qwen3-moe-235b-a22b",
                           "zamba2-2.7b", "mamba2-2.7b")
SIDES = {"jax": (JaxServingEngine, JaxCacheConfig, JaxEngineConfig,
                 JaxSpecConfig),
         "port": (ServingEngine, CacheConfig, EngineConfig, SpecConfig)}
STATS = ("spec_proposed", "spec_accepted", "spec_emitted", "decode_steps",
         "prefill_steps", "prompt_tokens", "generated_tokens",
         "kv_pages_peak", "preemptions", "restores",
         "shared_prompt_tokens", "snap_slots_peak")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size steps are hundreds of tiny ops, for which torch's worker
    threads only add contention beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """Both sides' model and params, as ``tests/test_spec_decode.py``'s
    ``_cfg``: the f32 smoke config, moe at ``capacity_factor =
    n_experts``."""
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), dtype="float32")
    pcfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    if jcfg.family == "moe":
        jcfg = dataclasses.replace(jcfg,
                                   capacity_factor=float(jcfg.n_experts))
        pcfg = dataclasses.replace(pcfg,
                                   capacity_factor=float(pcfg.n_experts))
    jcfg, tree, jparams = jax_params(cfg=jcfg)
    return {"jax": (jax_build_model(jcfg), jparams),
            "port": (build_model(pcfg, device="cpu"),
                     params_from_jax(tree, device="cpu"))}


def _requests(vocab, n=4, gen=5, seed=7):
    """``tests/test_spec_decode.py``'s ``_requests``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(3, 8))).tolist(),
             gen) for _ in range(n)]


def _engine(side, arch, spec, *, layout="paged", kv_dtype="f32",
            n_pages=None, max_len=24, **kw):
    """An engine of ``side``: batch 2, page 4, ``steps_per_sync`` 3, chunk
    4; ``spec`` a (k, drafter) pair or None for plain greedy decode."""
    eng_cls, cache_cls, config_cls, spec_cls = SIDES[side]
    model, params = _models(arch)[side]
    config = dict(steps_per_sync=3, prefill_chunk=4, **kw)
    if spec is not None:
        config["spec"] = spec_cls(k=spec[0], drafter=spec[1], ngram=2)
    return eng_cls(model, params, batch=2, max_len=max_len,
                   cache=cache_cls(layout=layout, page_size=4,
                                   kv_dtype=kv_dtype, n_pages=n_pages),
                   config=config_cls(**config))


def _drain(eng, reqs):
    rids = [eng.submit(t, g) for t, g in reqs]
    outs = eng.run()
    return [np.asarray(outs[r]).tolist() for r in rids]


def _staged(eng, reqs):
    """The first request alone for a cycle, so its prompt pages are
    written (and shareable), then the rest."""
    rid0 = eng.submit(*reqs[0])
    eng.step()
    rids = [rid0] + [eng.submit(t, g) for t, g in reqs[1:]]
    outs = eng.run()
    return [np.asarray(outs[r]).tolist() for r in rids]


def _preempt(eng, reqs):
    """``tests/test_pressure.py``'s preemption: a priority-1 arrival that
    cannot reserve its pages spills the resident priority-0 row, which
    is restored after."""
    (t0, g0), (t1, g1) = reqs
    first = eng.submit(t0, g0, priority=0)
    eng.step()
    second = eng.submit(t1, g1, priority=1)
    outs = eng.run()
    return [np.asarray(outs[r]).tolist() for r in (first, second)]


def _drained(eng):
    """Every page and snapshot slot back on its free list (the port's on
    its real entries) and every table unmapped."""
    ms = eng._mstate
    for pre, n in (("page", eng.n_pages), ("snap", eng.n_snap_slots)):
        if f"{pre}_top" in ms:
            assert int(ms[f"{pre}_top"]) == n, pre
            assert (ms[f"{pre}_rc"][:n] == 0).all(), pre
    for key in ("block_table", "snap_table", "host_table"):
        if key in ms:
            assert (ms[key] == -1).all(), key


def _check(jeng, eng, drive, reqs, plain=None):
    """The same script through JAX's spec engine and the port's: equal
    streams and statistics (cumulative over the engines' lives), every
    page back; ``plain``, a port engine without ``spec``, must give the
    same streams too.  Returns the port's statistics over this script
    alone (each after less before)."""
    before = eng.stats()
    want = drive(jeng, reqs)
    got = drive(eng, reqs)
    assert got == want
    s, js = eng.stats(), jeng.stats()
    keys = [k for k in STATS if k in js]
    assert {k: s[k] for k in keys} == {k: js[k] for k in keys}
    assert s["spec_proposed"] > 0 and s["spec_emitted"] > 0
    _drained(eng)
    if plain is not None:
        assert drive(plain, reqs) == got
    return {k: v - before.get(k, 0.0) for k, v in s.items()}


def _engines(arch, spec, **kw):
    """(JAX spec engine, port spec engine, port plain engine)."""
    return (_engine("jax", arch, spec, **kw), _engine("port", arch, spec, **kw),
            _engine("port", arch, None, **kw))


# the paged cells that also run under pressure share their engines (a
# JAX engine's first run compiles it, which is most of a cell's time): a
# pool of two rows of the four requests' worst case, so the pressure
# script's priority-1 arrival preempts.  qwen's also runs prefix sharing
# and the repetitive tail, at k 4 (plain prompts share nothing)
PRESSED = {(QWEN, "prompt_lookup"): dict(k=4, n_pages=13, max_len=40,
                                         prefix_sharing=True),
           (ZAMBA, "hybrid_ssm"): dict(k=3, n_pages=6, max_len=24)}


@functools.lru_cache(maxsize=None)
def _pressed(arch, drafter):
    kw = dict(PRESSED[arch, drafter])
    return _engines(arch, (kw.pop("k"), drafter), **kw)


# (arch, layout, (k, drafter), kv_dtype): JAX's token-identity cells, the
# int8 pools held to JAX's spec streams only
CELLS = [
    (QWEN, "contiguous", (3, "prompt_lookup"), "f32"),
    (QWEN, "paged", (4, "prompt_lookup"), "f32"),
    (MOE, "paged", (3, "prompt_lookup"), "f32"),
    (ZAMBA, "contiguous", (3, "hybrid_ssm"), "f32"),
    (ZAMBA, "paged", (3, "hybrid_ssm"), "f32"),
    (ZAMBA, "paged", (3, "prompt_lookup"), "f32"),
    (MAMBA, "contiguous", (3, "prompt_lookup"), "f32"),
    (QWEN, "paged", (3, "prompt_lookup"), "int8"),
    (ZAMBA, "paged", (3, "hybrid_ssm"), "int8"),
]


@pytest.mark.parametrize("arch,layout,spec,kv_dtype", CELLS)
def test_spec_streams_match_jax(arch, layout, spec, kv_dtype):
    """Four requests over two rows (mid-stream admission): JAX's spec
    streams and counters, the port's plain streams (f32 pools), and the
    hybrid drafter's private state in the decode state."""
    if layout == "paged" and kv_dtype == "f32" and (arch, spec[1]) in PRESSED:
        jeng, eng, plain = _pressed(arch, spec[1])
    else:
        jeng, eng, plain = _engines(arch, spec, layout=layout,
                                    kv_dtype=kv_dtype)
    reqs = _requests(_models(arch)["jax"][0].cfg.vocab_size)
    _check(jeng, eng, _drain, reqs, plain if kv_dtype == "f32" else None)
    assert ("drf_ssm" in eng._mstate) == (spec[1] == "hybrid_ssm")


@pytest.mark.parametrize("arch,drafter", sorted(PRESSED))
def test_spec_under_pressure_matches_jax(arch, drafter):
    """The priority-1 arrival (4 pages) cannot reserve beside the decoding
    priority-0 row (an 8-token prompt to ``max_len - 2``: 10 of qwen's 13
    pages, 6 of zamba2's 6), so it spills that row to the host tier, which
    comes back after; for the hybrid drafter its ``drf_*`` state stays in
    the lane through both."""
    gen = PRESSED[arch, drafter]["max_len"] - 10
    reqs = [(list(range(1, 9)), gen), (list(range(21, 27)), 8)]
    jeng, eng, plain = _pressed(arch, drafter)
    s = _check(jeng, eng, _preempt, reqs, plain)
    assert s["preemptions"] >= 1 and s["restores"] >= 1


def test_spec_with_prefix_sharing_matches_jax():
    """Prompt lookup beside prefix sharing: the later requests share the
    first one's prompt pages (one re-feeds a fully shared prompt, so its
    write copies a page first), and the verify chunks run the CoW pass."""
    vocab = _models(QWEN)["jax"][0].cfg.vocab_size
    prefix = np.random.default_rng(5).integers(0, vocab, size=8).tolist()
    reqs = [(prefix + [7, 9], 28), (prefix + [3], 4), (list(prefix), 4),
            (prefix + [5, 1], 5)]
    jeng, eng, plain = _pressed(QWEN, "prompt_lookup")
    s = _check(jeng, eng, _staged, reqs, plain)
    assert s["shared_prompt_tokens"] > 0


def test_spec_accepts_drafts_on_repetitive_tail():
    """Greedy continuations of a random-init model loop quickly, so prompt
    lookup at k 4 gets drafts accepted: JAX's streams and counters, an
    accept rate in (0, 1], and more tokens emitted than drafts
    accepted (every verify step emits the verifier's own token too)."""
    reqs = _requests(_models(QWEN)["jax"][0].cfg.vocab_size, gen=8)
    jeng, eng, plain = _pressed(QWEN, "prompt_lookup")
    s = _check(jeng, eng, _drain, reqs, plain)
    assert s["spec_accepted"] > 0
    assert 0.0 < s["spec_accepted"] / s["spec_proposed"] <= 1.0
    assert s["spec_emitted"] > s["spec_accepted"]
