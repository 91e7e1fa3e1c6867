"""The port's serving engine on the CPU against ``repro.serving``'s: the
same params and the same request list give identical greedy token lists
(contiguous layout, token-by-token, ``steps_per_sync`` in {1, 4})."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    ServingEngine,
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


@pytest.mark.parametrize("cls,field,value", [
    (CacheConfig, "layout", "paged"),
    (CacheConfig, "page_size", 32),
    (CacheConfig, "n_pages", 64),
    (CacheConfig, "snapshots", True),
    (CacheConfig, "host_spill", True),
    (CacheConfig, "kv_dtype", "int8"),
    (EngineConfig, "prefill_chunk", 8),
    (EngineConfig, "prefill_budget", 2),
    (EngineConfig, "prefix_sharing", True),
    (EngineConfig, "temperature", 0.7),
    (EngineConfig, "top_k", 5),
    (EngineConfig, "spec", object()),
])
def test_unserved_config_fields_raise(cls, field, value):
    """Fields of later slices are never silently ignored."""
    with pytest.raises(NotImplementedError, match="comes with"):
        cls(**{field: value})


def test_config_validation_matches_jax():
    with pytest.raises(ValueError, match="unknown KV-cache layout"):
        CacheConfig(layout="ring")
    with pytest.raises(ValueError, match="steps_per_sync must be >= 1"):
        EngineConfig(steps_per_sync=0)
