"""The port's serving engine on the CPU against ``repro.serving``'s: the
same params and the same request list give identical greedy token lists
and the same step counts, for {contiguous, paged} x ``prefill_chunk`` in
{1, 4} (and ``steps_per_sync`` in {1, 4}), with a pool small enough that
admission waits, and the same rejections."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    ServingEngine,
    SpecConfig,
)

from torch_parity import ARCH, jax_params, requests  # noqa: E402

MAX_LEN = 24


@pytest.mark.parametrize("steps_per_sync", [1, 4])
def test_token_lists_match_jax_engine(steps_per_sync):
    jcfg, tree, jparams = jax_params()
    reqs = requests(7, 2, 12, 3, 8, jcfg.vocab_size, seed=11)
    jeng = JaxServingEngine(
        jax_build_model(jcfg), jparams, batch=4, max_len=MAX_LEN,
        config=JaxEngineConfig(steps_per_sync=steps_per_sync))
    jrids = [jeng.submit(t, g) for t, g in reqs]
    want = jeng.run()

    model = build_model(get_arch(ARCH), device="cpu")
    eng = ServingEngine(model, params_from_jax(tree, device="cpu"), batch=4,
                        max_len=MAX_LEN,
                        config=EngineConfig(steps_per_sync=steps_per_sync))
    rids = [eng.submit(t, g) for t, g in reqs]
    got = eng.run()
    assert rids == jrids
    for rid, (_, g) in zip(rids, reqs):
        assert got[rid].dtype == np.int32 and got[rid].shape == (g,)
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    s = eng.stats()
    assert s["generated_tokens"] == sum(g for _, g in reqs)
    assert s["prompt_tokens"] == sum(len(t) for t, _ in reqs)
    assert s["decode_steps"] == eng.steps == jeng.steps
    assert set(eng.ttft) == set(rids)
    assert not eng.busy()


def test_engine_rejects_what_it_cannot_hold():
    model = build_model(get_arch(ARCH), device="cpu")
    _, tree, _ = jax_params()
    eng = ServingEngine(model, params_from_jax(tree, device="cpu"), batch=2,
                        max_len=8)
    with pytest.raises(ValueError, match="request 0: needs 9 slots"):
        eng.submit([1, 2, 3, 4, 5], 4)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit([], 4)
    assert eng.run() == {}


# (layout, prefill_chunk, n_pages): the worst-case pool is 4 x 24/4 = 24
# pages; 9 pages hold two or three requests at a time, so admission waits
SERVE_CASES = {
    "contiguous-1": ("contiguous", 1, None),
    "contiguous-4": ("contiguous", 4, None),
    "paged-1": ("paged", 1, None),
    "paged-4": ("paged", 4, None),
    "paged-4-small-pool": ("paged", 4, 9),
}
PAGE = 4


def _cache(cls, layout, n_pages):
    return cls(layout=layout, page_size=PAGE, n_pages=n_pages,
               host_spill=False if layout == "paged" else None)


@pytest.fixture(scope="module")
def served():
    """One JAX engine run per configuration, shared by the tests."""
    jcfg, tree, jparams = jax_params()
    reqs = requests(7, 2, 12, 3, 8, jcfg.vocab_size, seed=12)
    jmodel = jax_build_model(jcfg)
    runs = {}
    for case, (layout, chunk, n_pages) in SERVE_CASES.items():
        jeng = JaxServingEngine(
            jmodel, jparams, batch=4, max_len=MAX_LEN,
            cache=_cache(JaxCacheConfig, layout, n_pages),
            config=JaxEngineConfig(steps_per_sync=3, prefill_chunk=chunk))
        rids = [jeng.submit(t, g) for t, g in reqs]
        runs[case] = (rids, jeng.run(), jeng.stats())
    return tree, reqs, runs


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_layouts_and_chunks_match_jax_engine(served, case):
    """Prompts of 2-12 tokens, so chunk widths of 4 do not divide them;
    identical tokens and identical prefill/decode step counts, prompt
    tokens and peak pages."""
    tree, reqs, runs = served
    layout, chunk, n_pages = SERVE_CASES[case]
    jrids, want, jstats = runs[case]
    model = build_model(get_arch(ARCH), device="cpu")
    eng = ServingEngine(model, params_from_jax(tree, device="cpu"), batch=4,
                        max_len=MAX_LEN,
                        cache=_cache(CacheConfig, layout, n_pages),
                        config=EngineConfig(steps_per_sync=3,
                                            prefill_chunk=chunk))
    rids = [eng.submit(t, g) for t, g in reqs]
    got = eng.run()
    assert rids == list(jrids)
    for rid in rids:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    s = eng.stats()
    keys = ["prefill_steps", "decode_steps", "prompt_tokens",
            "generated_tokens"]
    if layout == "paged":
        keys += ["kv_pages", "kv_pages_peak"]
        assert s["kv_resident_bytes_peak"] == jstats["kv_resident_bytes_peak"]
    assert {k: s[k] for k in keys} == {k: jstats[k] for k in keys}
    assert (s["prefill_steps"] > 0) == (chunk > 1)
    if n_pages is not None:
        assert s["kv_pages_peak"] <= n_pages
    assert set(eng.ttft) == set(rids) and not eng.busy()
    if layout == "paged":     # every page went back on completion
        assert int(eng._mstate["page_top"]) == eng.n_pages


def test_submit_rejects_what_the_pool_cannot_hold():
    """Same message as the JAX engine's, naming the request id."""
    jcfg, tree, jparams = jax_params()
    jeng = JaxServingEngine(jax_build_model(jcfg), jparams, batch=2,
                            max_len=MAX_LEN,
                            cache=JaxCacheConfig(layout="paged", page_size=4,
                                                 n_pages=3, host_spill=False))
    eng = ServingEngine(build_model(get_arch(ARCH), device="cpu"),
                        params_from_jax(tree, device="cpu"), batch=2,
                        max_len=MAX_LEN,
                        cache=CacheConfig(layout="paged", page_size=4,
                                          n_pages=3, host_spill=False))
    msgs = []
    for e in (jeng, eng):
        e.submit([1, 2, 3], 4)       # 2 pages: fits
        with pytest.raises(ValueError) as err:
            e.submit(list(range(10)), 10)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == (
        "request 1: needs 5 pages > pool size 3 (prompt 10 + 10 new, "
        "page_size 4)")


def test_engine_refuses_what_needs_a_host_tier_or_a_ring():
    """A pool below the worst case with ``host_spill`` unset gets a host
    tier, as in the JAX engine, and preempts into it: a priority-1
    arrival spills the resident row, which comes back and finishes
    (``test_torch_pressure.py`` holds the tokens to JAX's).  Chunked
    prefill on a windowed arch still needs pages."""
    _, tree, _ = jax_params()
    params = params_from_jax(tree, device="cpu")
    model = build_model(get_arch(ARCH), device="cpu")
    eng = ServingEngine(model, params, batch=2, max_len=8,
                        cache=CacheConfig(layout="paged", page_size=4,
                                          n_pages=3),
                        config=EngineConfig(steps_per_sync=1))
    assert eng._spillable and "host_table" in eng._mstate
    eng.submit([1, 2, 3], 4)                  # 2 of the 3 pages
    eng.step()
    eng.submit([4, 5, 6], 4, priority=1)      # 2 more: only by preempting
    assert sorted(eng.run()) == [0, 1]
    assert eng.preemptions == eng.restores == 1
    windowed = build_model(dataclasses.replace(get_arch(ARCH), window=4),
                           device="cpu")
    with pytest.raises(ValueError, match="needs layout='paged'"):
        ServingEngine(windowed, params, batch=2, max_len=8,
                      config=EngineConfig(prefill_chunk=4))


@pytest.mark.parametrize("cls,field,value", [
    (CacheConfig, "layout", "paged"),
    (CacheConfig, "page_size", 32),
    (CacheConfig, "n_pages", 64),
    (EngineConfig, "prefill_chunk", 8),
])
def test_served_config_fields(cls, field, value):
    """The paged layout, any page and pool size, and chunked prefill are
    served."""
    assert getattr(cls(**{field: value}), field) == value


@pytest.mark.parametrize("cls,field,value", [
    (CacheConfig, "snapshots", True),
    (CacheConfig, "host_spill", True),
    (CacheConfig, "kv_dtype", "int8"),
    (CacheConfig, "kv_dtype", "bf16"),
    (EngineConfig, "prefill_budget", 2),
    (EngineConfig, "prefix_sharing", True),
    (EngineConfig, "temperature", 0.7),
    (EngineConfig, "top_k", 5),
    (EngineConfig, "spec", SpecConfig(k=2)),
])
def test_unserved_config_fields_raise(cls, field, value):
    """Every field of the typed config is served now; the test keeps its
    name from the slices that refused some.  A sub-f32 ``kv_dtype`` is
    served on the paged pool and refused, as JAX refuses it, on the
    contiguous slab; snapshots, like it, need the paged layout.  Sampling,
    prefix sharing (with snapshots), the host tier, prefill budgets and
    speculative decoding are served (``test_torch_sampling.py``,
    ``test_torch_prefix_sharing.py``, ``test_torch_pressure.py``,
    ``test_torch_spec_decode.py``); speculation's cross-object checks are
    ``validate_configs``'s, as in JAX."""
    if field in ("kv_dtype", "snapshots"):
        with pytest.raises(ValueError, match="layout='paged' required"):
            cls(**{field: value})
        assert getattr(cls(layout="paged", **{field: value}),
                       field) == value
        return
    assert getattr(cls(**{field: value}), field) == value


def test_config_validation_matches_jax():
    with pytest.raises(ValueError, match="unknown KV-cache layout"):
        CacheConfig(layout="ring")
    with pytest.raises(ValueError, match="steps_per_sync must be >= 1"):
        EngineConfig(steps_per_sync=0)
