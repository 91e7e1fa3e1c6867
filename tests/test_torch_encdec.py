"""The port's encoder-decoder family (``models/encdec.py``) on the CPU
against ``repro.models.encdec`` on JAX's reference backend, at
seamless-m4t-medium-smoke in f32: the same params (JAX's init, every norm
perturbed), the same seeded frames and tokens.  Held: ``encode``,
``decode_train``, ``train_loss`` and its grads, ``Model.prefill``,
``prefill_cross_cache``, decode with a scalar and a per-row ``pos``,
``prefill_chunk`` at widths [5, 3], ``reset_decode_rows``, the lockstep
loop's greedy tokens and one ``launch.train`` step's loss, within
rtol = atol = 1e-4 (both sides IEEE f32, summation order apart); tokens
equal.  The engine and the paged layout raise, as in JAX."""
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
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_jax,
    to_jax_layout,
    train_state_from_jax,
)
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve, steps, train  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import optimizers as opt_mod  # noqa: E402
from repro_torch.serving import CacheConfig, ServingEngine  # noqa: E402

from torch_parity import jax_params  # noqa: E402

ARCH = "seamless-m4t-medium-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S_ENC, S = 3, 12, 10


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def m():
    """Shared params, inputs and jitted JAX functions."""
    jcfg, tree, jparams = jax_params(arch=ARCH)
    cfg = get_arch(ARCH)
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)

    def jit(fn, **kw):
        return jax.jit(lambda *a: fn(jcfg, *a, **kw))

    with jax_use_backend("reference"):
        memory = jax_encdec.encode(jcfg, jparams, jnp.asarray(frames),
                                   remat=False)
    return dict(
        jcfg=jcfg, tree=tree, jp=jparams, cfg=cfg,
        params=params_from_jax(tree, device="cpu"),
        model=build_model(cfg, device="cpu"), frames=frames, tokens=tokens,
        memory=memory, decode=jit(jax_encdec.decode_step),
        decode_act=jax.jit(lambda p, s, t, a: jax_encdec.decode_step(
            jcfg, p, s, t, active=a)),
        chunk=jax.jit(lambda p, s, t, w: jax_encdec.prefill_chunk(
            jcfg, p, s, t, w)),
        cross=jit(jax_encdec.prefill_cross_cache))


def _states(m, batch, max_len, enc_len, **kw):
    """Fresh decode states of both sides, the cross K/V from the memory."""
    jstate = jax_encdec.init_decode_state(m["jcfg"], batch, max_len,
                                          enc_len, **kw)
    state = encdec.init_decode_state(m["cfg"], batch, max_len, enc_len,
                                     device="cpu", **kw)
    with jax_use_backend("reference"):
        jstate = m["cross"](m["jp"], m["memory"][:batch], jstate)
    with torch.no_grad():
        memory = encdec.encode(m["cfg"], m["params"],
                               torch.from_numpy(m["frames"][:batch]))
        state = encdec.prefill_cross_cache(m["cfg"], m["params"], memory,
                                           state)
    return state, jstate


def test_encode_decode_train_and_prefill_match_jax(m):
    frames = torch.from_numpy(m["frames"])
    toks = m["tokens"][:, :S]
    with torch.no_grad():
        memory = encdec.encode(m["cfg"], m["params"], frames)
        h = encdec.decode_train(m["cfg"], m["params"],
                                torch.from_numpy(toks), memory)
        h0 = encdec.decode_train(m["cfg"], m["params"],
                                 torch.from_numpy(toks),
                                 memory.roll(1, dims=0))
        logits = m["model"].prefill(m["params"], {
            "tokens": torch.from_numpy(toks), "frames": frames})
    with jax_use_backend("reference"):
        jh = jax_encdec.decode_train(m["jcfg"], m["jp"], jnp.asarray(toks),
                                     m["memory"], remat=False)
        jlogits = jax_build_model(m["jcfg"]).prefill(m["jp"], {
            "tokens": jnp.asarray(toks), "frames": jnp.asarray(m["frames"])})
    _close(memory, m["memory"])
    _close(h, jh)
    _close(logits, jlogits)
    # another row's memory moves the decoder: the cross path is live
    assert (h0 - h).abs().max() > 1e-2


def test_train_loss_and_grads_match_jax(m):
    params = params_from_jax(m["tree"], device="cpu")
    leaves = opt_mod.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(m["tokens"]),
             "frames": torch.from_numpy(m["frames"])}
    loss = encdec.train_loss(m["cfg"], params, batch)
    grads = torch.autograd.grad(loss, leaves)
    with jax_use_backend("reference"):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jax_encdec.train_loss(m["jcfg"], p, {
                "tokens": jnp.asarray(m["tokens"]),
                "frames": jnp.asarray(m["frames"])})))(m["jp"])
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


def test_prefill_cross_cache_matches_jax(m):
    state, jstate = _states(m, B, 16, 8)
    # replaced at the memory's length, as JAX replaces them
    assert state["xk"].shape[2] == jstate["xk"].shape[2] == S_ENC
    for key in ("xk", "xv"):
        _close(state[key], jstate[key])


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_matches_jax(m, per_row):
    """Six steps; per-row ``pos`` with row 1 idle at steps 2-3, whose
    caches stay untouched."""
    state, jstate = _states(m, B, 16, 8, per_row_pos=per_row)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, m["cfg"].vocab_size, (6, B)).astype(np.int32)
    with torch.no_grad(), jax_use_backend("reference"):
        for step, t in enumerate(toks):
            if per_row:
                act = np.array([True, step not in (2, 3), True])
                before = state["k"][:, 1].clone()
                jlogits, jstate = m["decode_act"](
                    m["jp"], jstate, jnp.asarray(t), jnp.asarray(act))
                logits, state = encdec.decode_step(
                    m["cfg"], m["params"], state, torch.from_numpy(t),
                    active=torch.from_numpy(act))
                if not act[1]:
                    assert torch.equal(state["k"][:, 1], before)
            else:
                jlogits, jstate = m["decode"](m["jp"], jstate, jnp.asarray(t))
                logits, state = encdec.decode_step(
                    m["cfg"], m["params"], state, torch.from_numpy(t))
            _close(logits, jlogits)
    np.testing.assert_array_equal(state["pos"].numpy(),
                                  np.asarray(jstate["pos"]))
    for key in ("k", "v"):
        _close(state[key], jstate[key])


def test_prefill_chunk_and_reset_match_jax(m):
    """Two chunks of C = 5 at widths [5, 3] then [2, 5] (per-row depths),
    then ``reset_decode_rows`` of row 0 at ``start`` 2."""
    state, jstate = _states(m, 2, 16, 8, per_row_pos=True)
    rng = np.random.default_rng(8)
    with torch.no_grad(), jax_use_backend("reference"):
        for widths in ([5, 3], [2, 5]):
            toks = rng.integers(0, m["cfg"].vocab_size, (2, 5)).astype(
                np.int32)
            w = np.array(widths, np.int32)
            jlogits, jstate = m["chunk"](m["jp"], jstate, jnp.asarray(toks),
                                         jnp.asarray(w))
            logits, state = encdec.prefill_chunk(
                m["cfg"], m["params"], state, torch.from_numpy(toks),
                torch.from_numpy(w))
            _close(logits, jlogits)
    assert state["pos"].tolist() == np.asarray(jstate["pos"]).tolist() \
        == [7, 8]
    for key in ("k", "v"):
        _close(state[key], jstate[key])
    mask = np.array([True, False])
    jstate = jax_encdec.reset_decode_rows(m["jcfg"], jstate,
                                          jnp.asarray(mask), 2)
    state = encdec.reset_decode_rows(m["cfg"], state,
                                     torch.from_numpy(mask), 2)
    assert state["pos"].tolist() == np.asarray(jstate["pos"]).tolist() \
        == [2, 8]
    for key in ("k", "v", "xk", "xv"):
        assert not state[key][:, 0].any()
        _close(state[key], jstate[key])
    with pytest.raises(ValueError, match="unhandled"):
        encdec.reset_decode_rows(m["cfg"], {**state, "extra": state["pos"]},
                                 torch.from_numpy(mask))


@pytest.mark.parametrize("with_frames", [True, False])
def test_lockstep_tokens_match_jax(m, with_frames):
    """``serve_lockstep`` against a JAX loop of ``decode_step`` and
    ``argmax`` (``repro.launch.serve._serve_lockstep``'s): the memory of
    the seeded frames, or (the CLI) the zero cross K/V."""
    n, gen = 6, 8
    prompt = m["tokens"][:, :n]
    toks, _, _, steps_run = serve.serve_lockstep(
        m["model"], m["params"], torch.from_numpy(prompt), gen,
        frames=torch.from_numpy(m["frames"]) if with_frames else None)
    assert steps_run == n + gen - 1
    jstate = jax_build_model(m["jcfg"]).init_decode_state(B, n + gen + 1)
    with jax_use_backend("reference"):
        if with_frames:
            jstate = m["cross"](m["jp"], m["memory"], jstate)
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
    train state on ``launch.train.make_batch``'s batch (zero frames of
    JAX's shape, and JAX's tokens: the two streams draw differently), as
    JAX's ``make_train_step`` takes it: the same loss."""
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
    assert batch["frames"].shape == jbatch["frames"].shape == (2, 4, 64)
    assert not batch["frames"].any()
    assert batch["tokens"].shape == jbatch["tokens"].shape
    batch["tokens"] = torch.from_numpy(np.array(jbatch["tokens"]))
    _, loss = steps.make_train_step(m["cfg"], opt_mod.OptConfig(**opt))(
        state, batch)
    with jax_use_backend("reference"):
        _, jloss = jax.jit(jax_steps.make_train_step(
            jcfg, jax_opt.OptConfig(**opt)))(jstate, jbatch)
    _close(loss, jloss)


def test_engine_and_paged_layout_raise(m):
    with pytest.raises(NotImplementedError, match="unsupported family"):
        ServingEngine(m["model"], m["params"], batch=2, max_len=16)
    with pytest.raises(NotImplementedError, match="contiguous-only"):
        m["model"].init_decode_state(2, 16, cache=CacheConfig(
            layout="paged", page_size=4))


def test_serve_cli_runs_the_lockstep_loop():
    out = io.StringIO()
    with redirect_stdout(out):
        assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "4", "--gen", "5",
                           "--prefill-chunk", "4"]) == 0
    text = out.getvalue()
    assert "engine features" in text          # the ignored engine flag
    assert "lockstep, batch 2: 5 tokens after a 4-token prompt" in text
    assert len(json.loads(text.split("sample:")[1])) == 5
