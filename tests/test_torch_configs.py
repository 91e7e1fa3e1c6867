"""The port's ArchConfig is the JAX package's, field for field."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro_torch.configs import ArchConfig, arch_ids, get_arch  # noqa: E402


@pytest.mark.parametrize("arch", [
    "qwen2.5-3b", "qwen2.5-3b-smoke", "mamba2-2.7b", "mamba2-2.7b-smoke",
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
    assert arch_ids() == ["qwen2.5-3b", "mamba2-2.7b", "zamba2-2.7b",
                          "mixtral-8x7b", "qwen3-moe-235b-a22b"]
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("llama-3.2-vision-90b")
