"""The port's vision LM (the ``vlm`` branches of ``models/lm.py``) on the
CPU against ``repro.models.lm`` on JAX's reference backend, at
llama-3.2-vision-90b-smoke in f32: the same params (JAX's init, norms
perturbed and every cross ``gate`` set to a seeded nonzero value, so
``tanh(gate)`` lets the cross-attention reach the logits), the same
seeded vision embeddings and tokens.  Held: ``forward(vision=)``,
``Model.prefill``, ``train_loss`` and its grads, decode after
``prefill_vlm_cross_cache`` with a scalar and a per-row ``pos``,
``reset_decode_rows``, the lockstep loop's greedy tokens and one
``launch.train`` step's loss, within rtol = atol = 1e-4; tokens equal.
The engine, the paged layout and ``prefill_chunk`` raise, as in JAX."""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import use_backend as jax_use_backend  # noqa: E402
from repro.data import synthetic as jax_data  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_jax,
    to_jax_layout,
    train_state_from_jax,
)
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import optimizers as opt_mod  # noqa: E402
from repro_torch.serving import CacheConfig, ServingEngine  # noqa: E402

from torch_parity import jax_params  # noqa: E402

ARCH = "llama-3.2-vision-90b-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 3, 10


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def m():
    """Shared params, inputs and jitted JAX functions."""
    jcfg, tree, jparams = jax_params(arch=ARCH)
    cfg = get_arch(ARCH)
    rng = np.random.default_rng(21)
    vision = rng.standard_normal(
        (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return dict(
        jcfg=jcfg, tree=tree, jp=jparams, cfg=cfg,
        params=params_from_jax(tree, device="cpu"),
        model=build_model(cfg, device="cpu"), vision=vision, tokens=tokens,
        decode=jax.jit(lambda p, s, t: jax_lm.decode_step(jcfg, p, s, t)),
        decode_act=jax.jit(lambda p, s, t, a: jax_lm.decode_step(
            jcfg, p, s, t, active=a)),
        cross=jax.jit(lambda p, v, s: jax_lm.prefill_vlm_cross_cache(
            jcfg, p, v, s)))


def _states(m, batch, max_len, vision, **kw):
    jstate = jax_lm.init_decode_state(m["jcfg"], batch, max_len, **kw)
    state = lm.init_decode_state(m["cfg"], batch, max_len, device="cpu",
                                 **kw)
    with jax_use_backend("reference"):
        jstate = m["cross"](m["jp"], jnp.asarray(vision), jstate)
    state = lm.prefill_vlm_cross_cache(m["cfg"], m["params"],
                                       torch.from_numpy(vision), state)
    return state, jstate


def test_gates_are_live(m):
    gates = [float(cp["attn"]["gate"]) for cp in m["params"]["cross"]]
    assert len(gates) == 2 and min(abs(np.tanh(g)) for g in gates) > 0.1


def test_forward_and_prefill_match_jax(m):
    toks = m["tokens"][:, :S]
    vision = torch.from_numpy(m["vision"])
    with torch.no_grad():
        h = lm.forward(m["cfg"], m["params"], torch.from_numpy(toks),
                       vision=vision)
        h_other = lm.forward(m["cfg"], m["params"], torch.from_numpy(toks),
                             vision=vision.roll(1, dims=0))
        logits = m["model"].prefill(m["params"], {
            "tokens": torch.from_numpy(toks), "vision": vision})
    with jax_use_backend("reference"):
        jh = jax_lm.forward(m["jcfg"], m["jp"], jnp.asarray(toks),
                            vision=jnp.asarray(m["vision"]), remat=False)
        jlogits = jax_lm.prefill(m["jcfg"], m["jp"], jnp.asarray(toks),
                                 vision=jnp.asarray(m["vision"]))
    _close(h, jh)
    _close(logits, jlogits)
    # another row's vision moves the hidden states: the cross path is live
    assert (h_other - h).abs().max() > 1e-2
    with pytest.raises(ValueError, match="vision"):
        lm.forward(m["cfg"], m["params"], torch.from_numpy(toks))


def test_train_loss_and_grads_match_jax(m):
    params = params_from_jax(m["tree"], device="cpu")
    leaves = opt_mod.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(m["tokens"]),
             "vision": torch.from_numpy(m["vision"])}
    loss = lm.train_loss(m["cfg"], params, batch)
    grads = torch.autograd.grad(loss, leaves)
    with jax_use_backend("reference"):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jax_lm.train_loss(m["jcfg"], p, {
                "tokens": jnp.asarray(m["tokens"]),
                "vision": jnp.asarray(m["vision"])})))(m["jp"])
    _close(loss, jloss)
    got = to_jax_layout(opt_mod.tree_unflatten(params, list(grads)))
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(jax.tree.leaves(got))
    for path, want in flat:
        leaf = got
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, np.asarray(want),
                                   err_msg=jax.tree_util.keystr(path), **TOL)
    # the gates' grads are live
    assert np.abs(got["cross"]["attn"]["gate"]).min() > 0


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_after_cross_cache_matches_jax(m, per_row):
    """``prefill_vlm_cross_cache`` then six steps; per-row ``pos`` with
    row 1 idle at steps 2-3, whose caches stay untouched."""
    state, jstate = _states(m, B, 16, m["vision"], per_row_pos=per_row)
    for key in ("xk", "xv"):
        _close(state[key], jstate[key])
    rng = np.random.default_rng(5)
    toks = rng.integers(0, m["cfg"].vocab_size, (6, B)).astype(np.int32)
    with torch.no_grad(), jax_use_backend("reference"):
        for step, t in enumerate(toks):
            if per_row:
                act = np.array([True, step not in (2, 3), True])
                before = state["k"][:, :, 1].clone()
                jlogits, jstate = m["decode_act"](
                    m["jp"], jstate, jnp.asarray(t), jnp.asarray(act))
                logits, state = lm.decode_step(
                    m["cfg"], m["params"], state, torch.from_numpy(t),
                    active=torch.from_numpy(act))
                if not act[1]:
                    assert torch.equal(state["k"][:, :, 1], before)
            else:
                jlogits, jstate = m["decode"](m["jp"], jstate, jnp.asarray(t))
                logits, state = lm.decode_step(
                    m["cfg"], m["params"], state, torch.from_numpy(t))
            _close(logits, jlogits)
    np.testing.assert_array_equal(state["pos"].numpy(),
                                  np.asarray(jstate["pos"]))
    for key in ("k", "v"):
        _close(state[key], jstate[key])


def test_reset_decode_rows_matches_jax(m):
    """Row 1 of a per-row state reset at ``start`` 3: its self-attention
    caches (batch axis 2) and cross K/V zeroed, as JAX's."""
    state, jstate = _states(m, 2, 12, m["vision"][:2], per_row_pos=True)
    toks = np.array([[5, 7], [9, 11], [13, 2]], np.int32)
    with torch.no_grad(), jax_use_backend("reference"):
        for t in toks:
            _, jstate = m["decode"](m["jp"], jstate, jnp.asarray(t))
            _, state = lm.decode_step(m["cfg"], m["params"], state,
                                      torch.from_numpy(t))
    mask = np.array([False, True])
    jstate = jax_lm.reset_decode_rows(m["jcfg"], jstate, jnp.asarray(mask), 3)
    state = lm.reset_decode_rows(m["cfg"], state, torch.from_numpy(mask), 3)
    assert state["pos"].tolist() == np.asarray(jstate["pos"]).tolist() \
        == [3, 3]
    assert not state["k"][:, :, 1].any() and state["k"][:, :, 0].any()
    assert not state["xk"][:, 1].any() and state["xk"][:, 0].any()
    for key in ("k", "v", "xk", "xv"):
        _close(state[key], jstate[key])


@pytest.mark.parametrize("with_vision", [True, False])
def test_lockstep_tokens_match_jax(m, with_vision):
    """``serve_lockstep`` against a JAX loop of ``decode_step`` and
    ``argmax`` (``repro.launch.serve._serve_lockstep``'s) over the seeded
    vision embeddings, or (the CLI) zero ones."""
    n, gen = 6, 8
    prompt = m["tokens"][:, :n]
    vision = (m["vision"] if with_vision else np.zeros_like(m["vision"]))
    toks, _, _, _ = serve.serve_lockstep(
        m["model"], m["params"], torch.from_numpy(prompt), gen,
        vision=torch.from_numpy(vision) if with_vision else None)
    jstate = jax_lm.init_decode_state(m["jcfg"], B, n + gen + 1)
    with jax_use_backend("reference"):
        jstate = m["cross"](m["jp"], jnp.asarray(vision), jstate)
        for i in range(n):
            logits, jstate = m["decode"](m["jp"], jstate,
                                         jnp.asarray(prompt[:, i]))
        want = []
        for _ in range(gen):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            want.append(tok)
            logits, jstate = m["decode"](m["jp"], jstate, tok)
    np.testing.assert_array_equal(toks.numpy(),
                                  np.stack([np.asarray(t) for t in want], 1))


def test_train_step_loss_matches_jax(m):
    """One step of ``launch.steps.make_train_step`` from JAX's initial
    train state on ``launch.train.make_batch``'s batch (zero vision of
    JAX's shape, JAX's tokens), as JAX's ``make_train_step`` takes it:
    the same loss."""
    jcfg = m["jcfg"]
    opt = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jstate = jax_steps.init_train_state(jcfg, jax_opt.OptConfig(**opt),
                                        jax.random.PRNGKey(0))
    state = train_state_from_jax(jax.device_get(jstate), device="cpu")
    stream = synthetic.TokenStream(synthetic.TokenStreamSpec(
        jcfg.vocab_size, 12, 2))
    batch = train.make_batch(stream, 0, torch.device("cpu"), m["cfg"])
    jbatch = jax_train.make_batch(jcfg, jax_data.TokenStream(
        jax_data.TokenStreamSpec(jcfg.vocab_size, 12, 2)), 0, 2, 12)
    assert batch["vision"].shape == jbatch["vision"].shape == (2, 8, 64)
    assert not batch["vision"].any()
    batch["tokens"] = torch.from_numpy(np.array(jbatch["tokens"]))
    _, loss = steps.make_train_step(m["cfg"], opt_mod.OptConfig(**opt))(
        state, batch)
    with jax_use_backend("reference"):
        _, jloss = jax.jit(jax_steps.make_train_step(
            jcfg, jax_opt.OptConfig(**opt)))(jstate, jbatch)
    _close(loss, jloss)


def test_engine_paged_layout_and_chunks_raise(m):
    with pytest.raises(NotImplementedError, match="unsupported family"):
        ServingEngine(m["model"], m["params"], batch=2, max_len=16)
    with pytest.raises(NotImplementedError, match="paged"):
        m["model"].init_decode_state(2, 16, cache=CacheConfig(
            layout="paged", page_size=4))
    state = m["model"].init_decode_state(2, 16, per_row_pos=True)
    with pytest.raises(NotImplementedError, match="vlm"):
        m["model"].prefill_chunk(m["params"], state,
                                 torch.zeros((2, 4), dtype=torch.int64), 4)


def test_serve_cli_runs_the_lockstep_loop():
    out = io.StringIO()
    with redirect_stdout(out):
        assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "4", "--gen", "5"]) == 0
    text = out.getvalue()
    assert "engine features" not in text
    assert "lockstep, batch 2: 5 tokens after a 4-token prompt" in text
    assert len(json.loads(text.split("sample:")[1])) == 5
    # a depth that is no multiple of cross_attn_every (2) is refused
    with pytest.raises(ValueError, match="not a multiple"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--n-layers", "3"])
