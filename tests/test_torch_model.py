"""The port's dense LM on the CPU against ``repro.models.lm``: the same
params (JAX init, perturbed biases and norm weights) and the same tokens
give the same per-step logits at f32 (atol = rtol = 1e-5: both sides
compute in IEEE f32 and differ only in summation order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

from torch_parity import ARCH, jax_params  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def test_decode_steps_match_jax():
    """~12 steps with per-row positions and an active mask: row 1 sits out
    steps 3-6, so the rows drift apart in depth; its cache is untouched
    while it is inactive."""
    jcfg, tree, jparams = jax_params()
    cfg = get_arch(ARCH)
    params = params_from_jax(tree, device="cpu")
    b, max_len, n_steps = 3, 16, 12
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (n_steps, b)).astype(np.int32)
    jstate = jax_lm.init_decode_state(jcfg, b, max_len, per_row_pos=True)
    state = lm.init_decode_state(cfg, b, max_len, per_row_pos=True,
                                 device="cpu")
    for step in range(n_steps):
        act = np.ones((b,), bool)
        if 3 <= step <= 6:
            act[1] = False
        before = (state["k"][:, 1].clone(), state["v"][:, 1].clone())
        jlogits, jstate = jax_lm.decode_step(
            jcfg, jparams, jstate, jnp.asarray(toks[step]),
            active=jnp.asarray(act))
        logits, state = lm.decode_step(
            cfg, params, state, torch.from_numpy(toks[step]),
            active=torch.from_numpy(act))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        np.testing.assert_array_equal(state["pos"].numpy(),
                                      np.asarray(jstate["pos"]))
        if not act[1]:
            assert torch.equal(state["k"][:, 1], before[0])
            assert torch.equal(state["v"][:, 1], before[1])
    assert state["pos"].tolist() == [12, 8, 12]
    for key in ("k", "v"):
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(jstate[key]), **TOL)


def test_lockstep_decode_and_reset_match_jax():
    """Scalar ``pos`` (all rows in lockstep), then ``reset_decode_rows`` of
    one row of a per-row state: same caches and clocks as JAX."""
    jcfg, tree, jparams = jax_params(seed=3)
    cfg = get_arch(ARCH)
    params = params_from_jax(tree, device="cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (4, 2)).astype(np.int32)
    jstate = jax_lm.init_decode_state(jcfg, 2, 8)
    state = lm.init_decode_state(cfg, 2, 8, device="cpu")
    for t in toks:
        jlogits, jstate = jax_lm.decode_step(jcfg, jparams, jstate,
                                             jnp.asarray(t))
        logits, state = lm.decode_step(cfg, params, state,
                                       torch.from_numpy(t))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
    assert int(state["pos"]) == int(jstate["pos"]) == 4

    jstate = jax_lm.init_decode_state(jcfg, 2, 8, per_row_pos=True)
    state = lm.init_decode_state(cfg, 2, 8, per_row_pos=True, device="cpu")
    for t in toks:
        _, jstate = jax_lm.decode_step(jcfg, jparams, jstate, jnp.asarray(t))
        _, state = lm.decode_step(cfg, params, state, torch.from_numpy(t))
    mask = np.array([True, False])
    jstate = jax_lm.reset_decode_rows(jcfg, jstate, jnp.asarray(mask))
    state = lm.reset_decode_rows(cfg, state, torch.from_numpy(mask))
    assert state["pos"].tolist() == np.asarray(jstate["pos"]).tolist() == [0, 4]
    for key in ("k", "v"):
        assert not state[key][:, 0].any()
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(jstate[key]), **TOL)


def test_tied_head_is_not_copied():
    """The LM head is the transposed view of the embedding."""
    _, tree, _ = jax_params()
    cfg = get_arch(ARCH)
    params = params_from_jax(tree, device="cpu")
    model = build_model(cfg, device="cpu")
    h = torch.ones(2, cfg.d_model)
    np.testing.assert_allclose(
        model.lm_logits(params, h).numpy(),
        (h @ params["embed"].T).numpy(), **TOL)
    assert params["embed"].T.data_ptr() == params["embed"].data_ptr()


def test_params_from_jax_bf16_bits():
    """bf16 leaves cross through a 16-bit integer view, bit for bit, and
    the stacked layer axis is split into per-layer dicts."""
    import ml_dtypes

    rng = np.random.default_rng(7)
    emb = rng.standard_normal((8, 4)).astype(ml_dtypes.bfloat16)
    wq = rng.standard_normal((3, 4, 4)).astype(ml_dtypes.bfloat16)
    out = params_from_jax({"embed": emb, "ln_f": np.ones(4, np.float32),
                           "layers": {"attn": {"wq": wq}}}, device="cpu")
    assert out["embed"].dtype == torch.bfloat16
    assert np.array_equal(out["embed"].view(torch.int16).numpy(),
                          emb.view(np.int16))
    assert len(out["layers"]) == 3
    assert np.array_equal(out["layers"][2]["attn"]["wq"].view(
        torch.int16).numpy(), wq[2].view(np.int16))
    with pytest.raises(NotImplementedError, match="families"):
        params_from_jax({"cross": {}}, device="cpu")


def _same_paged_state(state, jstate):
    """Pools on the real pages, block tables and allocators equal JAX's."""
    n_pages = jstate["kp"].shape[1]
    top = int(jstate["page_top"])
    assert int(state["page_top"]) == top
    np.testing.assert_array_equal(state["block_table"].numpy(),
                                  np.asarray(jstate["block_table"]))
    np.testing.assert_array_equal(state["page_free"][:top].numpy(),
                                  np.asarray(jstate["page_free"])[:top])
    np.testing.assert_array_equal(state["page_rc"][:n_pages].numpy(),
                                  np.asarray(jstate["page_rc"]))
    for key in ("kp", "vp"):
        np.testing.assert_allclose(state[key][:, :n_pages].numpy(),
                                   np.asarray(jstate[key]), **TOL)


def _same_state(state, jstate, paged):
    np.testing.assert_array_equal(state["pos"].numpy(),
                                  np.asarray(jstate["pos"]))
    if paged:
        _same_paged_state(state, jstate)
    else:
        for key in ("k", "v"):
            np.testing.assert_allclose(state[key].numpy(),
                                       np.asarray(jstate[key]), **TOL)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_chunk_then_decode_match_jax(layout):
    """Chunks of ragged per-row widths (partial chunks, width 1, a row
    that sits one chunk out), then decode steps, then a release and a
    refill: the logits at each row's last real position, the caches (or
    pools and block tables) and the clocks equal JAX's after every call.
    Page size 4 with chunk 4 starting mid-page crosses page boundaries."""
    jcfg, tree, jparams = jax_params(seed=4)
    cfg = get_arch(ARCH)
    params = params_from_jax(tree, device="cpu")
    b, max_len, c, page = 3, 24, 4, 4
    paged = layout == "paged"
    kw = dict(layout=layout, page_size=page) if paged else {}
    jstate = jax_lm.init_decode_state(jcfg, b, max_len, per_row_pos=True,
                                      **kw)
    state = lm.init_decode_state(cfg, b, max_len, per_row_pos=True,
                                 device="cpu", **kw)
    rng = np.random.default_rng(8)
    schedule = [  # (widths, active)
        ([4, 3, 1], [True, True, True]),
        ([2, 4, 4], [True, False, True]),
        ([4, 1, 3], [True, True, True]),
    ]
    for widths, act in schedule:
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
        _same_state(state, jstate, paged)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        a = np.array([True, step != 1, True])
        jlogits, jstate = jax_lm.decode_step(jcfg, jparams, jstate,
                                             jnp.asarray(tok),
                                             active=jnp.asarray(a))
        logits, state = lm.decode_step(cfg, params, state,
                                       torch.from_numpy(tok),
                                       active=torch.from_numpy(a))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        _same_state(state, jstate, paged)
    mask = np.array([False, True, False])
    jstate = jax_lm.reset_decode_rows(jcfg, jstate, jnp.asarray(mask))
    state = lm.reset_decode_rows(cfg, state, torch.from_numpy(mask))
    _same_state(state, jstate, paged)
    toks = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
    w = np.asarray([1, 4, 2], np.int32)
    jlogits, jstate = jax_lm.prefill_chunk(jcfg, jparams, jstate,
                                           jnp.asarray(toks), jnp.asarray(w))
    logits, state = lm.prefill_chunk(cfg, params, state,
                                     torch.from_numpy(toks),
                                     torch.from_numpy(w))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _same_state(state, jstate, paged)


def test_paged_decode_small_pool_matches_jax():
    """A pool of 5 pages for 3 rows of up to 4 blocks: rows past the
    free list stay unmapped and their writes drop, as in JAX."""
    jcfg, tree, jparams = jax_params(seed=5)
    cfg = get_arch(ARCH)
    params = params_from_jax(tree, device="cpu")
    b, max_len = 3, 8
    kw = dict(layout="paged", page_size=2, n_pages=5)
    jstate = jax_lm.init_decode_state(jcfg, b, max_len, per_row_pos=True,
                                      **kw)
    state = lm.init_decode_state(cfg, b, max_len, per_row_pos=True,
                                 device="cpu", **kw)
    assert state["kp"].shape[1] == 6      # five real pages + the sentinel
    rng = np.random.default_rng(9)
    for _ in range(5):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        jlogits, jstate = jax_lm.decode_step(jcfg, jparams, jstate,
                                             jnp.asarray(tok))
        logits, state = lm.decode_step(cfg, params, state,
                                       torch.from_numpy(tok))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        _same_paged_state(state, jstate)
    assert int(state["page_top"]) == 0
    assert (state["block_table"] < 0).any()
