"""The port's moe family on the CPU against the JAX package: ``moe_block``
with capacity drops and exactly tied router scores (1e-5), the
``decode_step``/``prefill_chunk`` logits of qwen3-moe-235b-a22b-smoke and
mixtral-8x7b-smoke against ``repro.models.lm``, the params conversion,
and engine token lists against ``repro.serving`` over both layouts,
chunked prefill and the int8 pool."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.models import components as jax_C  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.configs import ArchConfig, get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import components as C  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    ServingEngine,
)

from torch_parity import jax_params  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["qwen3-moe-235b-a22b-smoke", "mixtral-8x7b-smoke"]


def _moe_params(cfg, seed):
    """One layer's moe params from the JAX init, norm weight perturbed."""
    tree = {k: np.array(v) for k, v in jax.device_get(
        jax_C.init_moe(cfg, jax.random.PRNGKey(seed))).items()}
    rng = np.random.default_rng(seed)
    tree["ln"] = (1 + 0.1 * rng.standard_normal(tree["ln"].shape)).astype(
        tree["ln"].dtype)
    return tree


def _port_cfg(cfg):
    return ArchConfig(**dataclasses.asdict(cfg))


def _moe_both(cfg, tree, x):
    want = np.asarray(jax_C.moe_block(
        cfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    port = {k: torch.from_numpy(v) for k, v in tree.items()}
    got = C.moe_block(_port_cfg(cfg), port, torch.from_numpy(x))
    return got.numpy(), want


def _routing(cfg, tree, x):
    """The port's router probabilities, top-k picks and the number of
    picks that fit under capacity, to show a case exercises what it
    claims."""
    port = {k: torch.from_numpy(v) for k, v in tree.items()}
    xn = C.norm(_port_cfg(cfg), port["ln"], torch.from_numpy(x))
    probs = torch.softmax(xn.reshape(-1, cfg.d_model) @ port["router"], -1)
    _, idx = C._top_k(probs, cfg.top_k)
    cap = max(1, int(np.ceil(idx.shape[0] * cfg.top_k / cfg.n_experts
                             * cfg.capacity_factor)))
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    return probs, idx, int(counts.clamp(max=cap).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_with_capacity_drops_matches_jax(arch):
    """capacity_factor 1.25 over 24 tokens, ten of them identical (as
    padding and idle rows are): their experts overflow, so picks are
    dropped, add exact zeros into the last slot, and identical rows take
    consecutive ranks in the same queues."""
    cfg = jax_get_arch(arch)
    assert cfg.capacity_factor == 1.25
    tree = _moe_params(cfg, 0)
    x = np.random.default_rng(1).standard_normal(
        (3, 8, cfg.d_model)).astype(np.float32)
    x[1, 3:] = x[2, 3:] = x[0, 0]
    got, want = _moe_both(cfg, tree, x)
    np.testing.assert_allclose(got, want, **TOL)
    _, idx, kept = _routing(cfg, tree, x)
    assert kept < idx.numel()         # drops are active


def test_moe_block_tied_router_rows_match_jax():
    """Experts 2 and 3 have the router columns of 1 and 0, so every token
    scores each pair exactly equal: ``jax.lax.top_k`` puts the lower
    index first on equal values, and the port must pick the same experts
    in the same order (``torch.topk`` promises no tie order).  With
    capacity 1.0 the popular pair overflows as well."""
    cfg = dataclasses.replace(jax_get_arch("qwen3-moe-235b-a22b-smoke"),
                              capacity_factor=1.0)
    tree = _moe_params(cfg, 2)
    tree["router"][:, 2] = tree["router"][:, 1]
    tree["router"][:, 3] = tree["router"][:, 0]
    x = np.random.default_rng(3).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    x[1, 2:] = x[1, 1]                 # five identical rows
    got, want = _moe_both(cfg, tree, x)
    np.testing.assert_allclose(got, want, **TOL)
    probs, idx, kept = _routing(cfg, tree, x)
    assert torch.equal(probs[:, 1], probs[:, 2])
    assert torch.equal(probs[:, 0], probs[:, 3])
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # every pick is a tied pair, lower id first
    assert set(map(tuple, idx.tolist())) == {(0, 3), (1, 2)}
    assert kept < idx.numel()


# mixtral's sliding window needs pages to chunk
@pytest.mark.parametrize("arch,layout", [
    ("qwen3-moe-235b-a22b-smoke", "contiguous"),
    ("qwen3-moe-235b-a22b-smoke", "paged"),
    ("mixtral-8x7b-smoke", "paged")])
def test_moe_prefill_and_decode_match_jax(arch, layout):
    """Ragged chunks (a row sitting one out), decode steps with a row
    inactive: logits at 1e-5 and the clocks equal JAX's, with capacity
    drops counting every row of the batch as JAX counts them."""
    jcfg, tree, jparams = jax_params(seed=6, arch=arch)
    cfg = get_arch(arch)
    params = params_from_jax(tree, device="cpu")
    b, max_len, c = 3, 24, 4
    kw = dict(layout=layout, page_size=4) if layout == "paged" else {}
    jstate = jax_lm.init_decode_state(jcfg, b, max_len, per_row_pos=True,
                                      **kw)
    state = lm.init_decode_state(cfg, b, max_len, per_row_pos=True,
                                 device="cpu", **kw)
    rng = np.random.default_rng(9)
    for widths, act in (([4, 3, 1], [True, True, True]),
                        ([2, 4, 4], [True, False, True])):
        toks = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
        w, a = np.asarray(widths, np.int32), np.asarray(act)
        jlogits, jstate = jax_lm.prefill_chunk(
            jcfg, jparams, jstate, jnp.asarray(toks), jnp.asarray(w),
            active=jnp.asarray(a))
        logits, state = lm.prefill_chunk(
            cfg, params, state, torch.from_numpy(toks), torch.from_numpy(w),
            active=torch.from_numpy(a))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        a = np.array([True, step != 2, True])
        jlogits, jstate = jax_lm.decode_step(jcfg, jparams, jstate,
                                             jnp.asarray(tok),
                                             active=jnp.asarray(a))
        logits, state = lm.decode_step(cfg, params, state,
                                       torch.from_numpy(tok),
                                       active=torch.from_numpy(a))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
    np.testing.assert_array_equal(state["pos"].numpy(),
                                  np.asarray(jstate["pos"]))


def test_moe_forward_matches_jax():
    """The teacher-forced forward (``--check``'s other side)."""
    arch = "qwen3-moe-235b-a22b-smoke"
    jcfg, tree, jparams = jax_params(seed=7, arch=arch)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(jax_lm.forward(jcfg, jparams, jnp.asarray(toks)))
    got = lm.forward(get_arch(arch), params_from_jax(tree, device="cpu"),
                     torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_params_from_jax_moe_tree():
    """The moe tree crosses bit for bit: the router stays f32, the expert
    weights keep their leading expert axis, bf16 leaves reinterpret."""
    cfg = dataclasses.replace(jax_get_arch("mixtral-8x7b-smoke"),
                              dtype="bfloat16")
    tree = jax.device_get(jax_lm.init_params(cfg, jax.random.PRNGKey(5)))
    out = params_from_jax(tree, device="cpu")
    assert len(out["layers"]) == cfg.n_layers
    for i, layer in enumerate(out["layers"]):
        moe = layer["moe"]
        assert moe["router"].dtype == torch.float32
        assert tuple(moe["wg"].shape) == (cfg.n_experts, cfg.d_model,
                                          cfg.d_ff)
        assert tuple(moe["wo"].shape) == (cfg.n_experts, cfg.d_ff,
                                          cfg.d_model)
        for key in ("wg", "wi", "wo", "ln"):
            assert moe[key].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                moe[key].view(torch.int16).numpy(),
                np.asarray(tree["layers"]["moe"][key][i]).view(np.int16))
        np.testing.assert_array_equal(
            moe["router"].numpy(),
            np.asarray(tree["layers"]["moe"]["router"][i]))
    port = build_model(get_arch("mixtral-8x7b-smoke"), device="cpu")
    mine = port.init_params(0)["layers"][0]["moe"]
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in out["layers"][0]["moe"].items()}


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

# prompts away from greedy near-ties (tests/test_kv_quant.py:176)
REQS = [([2, 9, 14, 6, 3, 8], 4), ([7, 12, 5], 4), ([10, 1, 10, 1, 6], 4)]
# (arch, layout, chunk, kv_dtype): mixtral's window needs pages to chunk
ENGINE_CASES = (
    [("qwen3-moe-235b-a22b-smoke", lay, ch, "f32")
     for lay in ("contiguous", "paged") for ch in (1, 4)]
    + [("mixtral-8x7b-smoke", "contiguous", 1, "f32"),
       ("mixtral-8x7b-smoke", "paged", 1, "f32"),
       ("mixtral-8x7b-smoke", "paged", 4, "f32")]
    + [(arch, "paged", ch, "int8") for arch in ARCHS for ch in (1, 4)])


def _engine(cls, cache_cls, cfg_cls, model, params, layout, chunk, kv):
    return cls(model, params, batch=2, max_len=16,
               cache=cache_cls(layout=layout, page_size=4, kv_dtype=kv),
               config=cfg_cls(steps_per_sync=3, prefill_chunk=chunk))


@pytest.mark.parametrize("arch,layout,chunk,kv_dtype", ENGINE_CASES)
def test_moe_engine_matches_jax_engine(arch, layout, chunk, kv_dtype):
    """Batch 2 over three requests, so rows go idle and are refilled while
    capacity counts them: identical token lists, step counts, prompt
    tokens and (paged) peak pages and resident KV bytes."""
    jcfg, tree, jparams = jax_params(seed=0, arch=arch)
    jeng = _engine(JaxServingEngine, JaxCacheConfig, JaxEngineConfig,
                   jax_build_model(jcfg), jparams, layout, chunk, kv_dtype)
    jrids = [jeng.submit(t, g) for t, g in REQS]
    want = jeng.run()
    eng = _engine(ServingEngine, CacheConfig, EngineConfig,
                  build_model(get_arch(arch), device="cpu"),
                  params_from_jax(tree, device="cpu"), layout, chunk,
                  kv_dtype)
    rids = [eng.submit(t, g) for t, g in REQS]
    got = eng.run()
    assert rids == list(jrids)
    for rid in rids:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    s, js = eng.stats(), jeng.stats()
    keys = ["prefill_steps", "decode_steps", "prompt_tokens",
            "generated_tokens"]
    if layout == "paged":
        keys += ["kv_pages", "kv_pages_peak", "kv_resident_bytes_peak"]
    assert {k: s[k] for k in keys} == {k: js[k] for k in keys}
    assert not eng.busy()


def test_engine_refuses_contiguous_chunks_on_windowed_moe():
    """mixtral has a sliding window: chunked prefill needs the paged
    layout, as in the JAX engine."""
    _, tree, _ = jax_params(arch="mixtral-8x7b-smoke")
    model = build_model(get_arch("mixtral-8x7b-smoke"), device="cpu")
    with pytest.raises(ValueError, match="needs layout='paged'"):
        ServingEngine(model, params_from_jax(tree, device="cpu"), batch=2,
                      max_len=8, config=EngineConfig(prefill_chunk=4))


def test_serve_cli_moe_int8_and_check(capsys):
    """The CLI serves a moe arch at a cut depth from an int8 pool, prints
    the resident KV bytes, and passes ``--check`` with capacity lifted."""
    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--arch", "mixtral-8x7b-smoke",
                       "--n-layers", "3", "--batch", "2", "--requests", "3",
                       "--prompt-len", "6", "--gen", "5", "--layout",
                       "paged", "--page-size", "4", "--kv-dtype", "int8",
                       "--prefill-chunk", "4", "--check"]) == 0
    out = capsys.readouterr().out
    assert "kv dtype int8: peak pages" in out and "bytes of KV" in out
    assert "decode path matches teacher-forced forward" in out
