"""The port's ArchConfig is the JAX package's, field for field, for every
arch of the families the port serves; one of the dense archs added after
qwen2.5-3b (untied head, no qkv bias) is served token for token as JAX's
engine serves it."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.configs import ArchConfig, arch_ids, get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    ServingEngine,
)

from torch_parity import jax_params, requests  # noqa: E402


@pytest.mark.parametrize("arch", [
    "qwen2.5-3b", "qwen2.5-3b-smoke", "deepseek-coder-33b",
    "deepseek-coder-33b-smoke", "internlm2-20b", "internlm2-20b-smoke",
    "glm4-9b", "glm4-9b-smoke", "mamba2-2.7b", "mamba2-2.7b-smoke",
    "zamba2-2.7b", "zamba2-2.7b-smoke", "mixtral-8x7b", "mixtral-8x7b-smoke",
    "qwen3-moe-235b-a22b", "qwen3-moe-235b-a22b-smoke"])
def test_fields_match_jax(arch):
    port, ref = get_arch(arch), jax_get_arch(arch)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for prop in ("head_dim_", "d_inner", "ssm_heads", "is_attention_free"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.dtype_() == {"bfloat16": torch.bfloat16,
                             "float32": torch.float32}[ref.dtype]


def test_reduced_matches_jax_for_every_family_branch():
    """reduced() is a copy of the JAX logic, including the branches of the
    families this slice does not serve yet."""
    base = dict(name="x", family="moe", n_layers=30, d_model=512, n_heads=8,
                n_kv_heads=8, d_ff=1024, vocab_size=1000, n_experts=8,
                top_k=2, ssm_state=64, attn_every=6, encoder_layers=12,
                cross_attn_every=5, window=4096)
    from repro.configs.base import ArchConfig as JaxArchConfig
    assert dataclasses.asdict(ArchConfig(**base).reduced()) == \
        dataclasses.asdict(JaxArchConfig(**base).reduced())


def test_registry_lists_the_served_archs():
    assert arch_ids() == ["qwen2.5-3b", "deepseek-coder-33b",
                          "internlm2-20b", "glm4-9b", "mamba2-2.7b",
                          "zamba2-2.7b", "mixtral-8x7b",
                          "qwen3-moe-235b-a22b"]
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("llama-3.2-vision-90b")


@pytest.mark.parametrize("layout,chunk", [("contiguous", 1), ("paged", 4)])
def test_glm4_smoke_engine_matches_jax(layout, chunk):
    """glm4-9b-smoke through both engines: identical greedy tokens and
    step counts, contiguous token by token and paged with chunks of 4."""
    arch = "glm4-9b-smoke"
    jcfg, tree, jparams = jax_params(arch=arch)
    reqs = requests(5, 2, 10, 3, 6, jcfg.vocab_size, seed=13)

    def cache(cls):
        return cls(layout=layout, page_size=4,
                   host_spill=False if layout == "paged" else None)

    jeng = JaxServingEngine(
        jax_build_model(jcfg), jparams, batch=4, max_len=20,
        cache=cache(JaxCacheConfig),
        config=JaxEngineConfig(steps_per_sync=2, prefill_chunk=chunk))
    jrids = [jeng.submit(t, g) for t, g in reqs]
    want = jeng.run()
    eng = ServingEngine(
        build_model(get_arch(arch), device="cpu"),
        params_from_jax(tree, device="cpu"), batch=4, max_len=20,
        cache=cache(CacheConfig),
        config=EngineConfig(steps_per_sync=2, prefill_chunk=chunk))
    rids = [eng.submit(t, g) for t, g in reqs]
    got = eng.run()
    assert rids == list(jrids)
    for rid in rids:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    keys = ["prefill_steps", "decode_steps", "generated_tokens"]
    assert {k: eng.stats()[k] for k in keys} == \
        {k: jeng.stats()[k] for k in keys}
