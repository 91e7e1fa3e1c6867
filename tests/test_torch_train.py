"""The port's training path on the CPU against the JAX package.

``OptConfig``, ``schedule`` and ``apply_updates`` against
``repro.optim.optimizers``; the token stream's successor table and its
batches; one and two ``make_train_step`` steps of the four served
families' smoke archs from JAX's initial train state on JAX's batches, and
the microbatched step; remat against no remat; and the training CLI, its
checkpoints, injected fault and resume included.

Tolerances.  The loss within 1e-5 of its value (f32, summation order).
The moments (m = 0.1 * clip * g, v = 0.05 * (clip * g)^2 after one step)
within rtol 2e-3 and 5e-5 of the leaf's largest value after the first
step, which holds the gradients, and 1e-3 after the second, whose
gradients are taken at params that differ as set out below (measured:
3e-4 of their scale).  Params and the f32 master weights within JAX's own
microbatch test's ``rtol=2e-3, atol=5e-5`` (``tests/test_system.py``),
with one exception, element by element.  Adam moves a weight by
lr * m / sqrt(v), so a relative gap r in that weight's first moment moves
it by up to about lr * r, which passes the atol once r > atol / lr = 5%.
Fed identical params, the two sides' gradients agree within 2e-5 of each
leaf's scale, so r > 5% happens only where a gradient sits at that noise
level: zamba2's smoke ``w_in`` has one such element (-1.5e-7 in JAX and
-5.8e-8 here, of a leaf whose largest is 0.14), and its update differs by
1.7e-4.  So an element whose first moment differed by more than 5% at
any step so far may miss the tolerance by up to two learning rates a
step (the most Adam's update can differ); every other element of every
leaf is held with no exception.
"""
import dataclasses
import io
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.data import synthetic as jax_data  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import to_jax_layout, train_state_from_jax  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import optimizers as opt_mod  # noqa: E402

ARCHS = ["qwen2.5-3b-smoke", "mixtral-8x7b-smoke", "mamba2-2.7b-smoke",
         "zamba2-2.7b-smoke"]
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-3, atol=5e-5)
MOMENT_ATOL = 1e-3        # of the leaf's largest |value|


def _pairs(a, b, path=""):
    """(path, port leaf, JAX leaf) over two trees of the same keys."""
    if isinstance(b, dict):
        for k in b:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def _close(path, got, want, atol, may_miss=None, budget=0.0):
    """|got - want| <= atol + 2e-3 |want|, but where ``may_miss`` is set,
    within ``budget``."""
    gap = np.abs(got - want)
    out = gap > atol + PARAM_TOL["rtol"] * np.abs(want)
    if may_miss is not None:
        assert (gap[out & may_miss] <= budget).all(), (path, float(gap.max()))
        out &= ~may_miss
    assert not out.any(), (path, int(out.sum()), float(gap[out].max()))


def _close_state(port_state, jax_state, steps_taken, unsettled):
    """Params, master, m and v after ``steps_taken`` steps (module
    docstring).  ``unsettled`` (path -> bool array, kept by the caller
    across steps) gains the elements whose first moment differs by more
    than atol / lr of JAX's."""
    opt = jax.device_get(jax_state["opt"])
    assert int(port_state["opt"]["step"]) == int(opt["step"]) == steps_taken
    ratio = PARAM_TOL["atol"] / OPT["lr"]
    for path, g, w in _pairs(to_jax_layout(port_state["opt"]["m"]), opt["m"]):
        far = np.abs(g - w) > ratio * np.abs(w)
        unsettled[path] = unsettled[path] | far if path in unsettled else far
    budget = 2 * OPT["lr"] * steps_taken
    trees = [("params", port_state["params"], jax_state["params"])] + [
        (k, port_state["opt"][k], opt[k]) for k in opt if k != "step"]
    for key, port, ref in trees:
        for path, g, w in _pairs(to_jax_layout(port), jax.device_get(ref)):
            if key in ("params", "master"):
                _close(key + path, g, w, PARAM_TOL["atol"], unsettled[path],
                       budget)
            else:
                scale = float(np.abs(w).max())
                _close(key + path, g, w,
                       (5e-5 if steps_taken == 1 else MOMENT_ATOL) * scale)


def _jax_batch(cfg, step, batch=4, seq=17):
    inputs, targets = jax_data.TokenStream(
        jax_data.TokenStreamSpec(cfg.vocab_size, seq, batch)).batch(step)
    return np.asarray(jnp.concatenate([inputs, targets[:, -1:]], axis=1))


# ---------------------------------------------------------------------------
# optimizer and data
# ---------------------------------------------------------------------------

def test_opt_config_and_schedule_match_jax():
    assert dataclasses.asdict(opt_mod.OptConfig()) == dataclasses.asdict(
        jax_opt.OptConfig())
    cfg = dict(lr=2e-3, warmup_steps=5, total_steps=20, min_lr_ratio=0.2)
    port, ref = opt_mod.OptConfig(**cfg), jax_opt.OptConfig(**cfg)
    for step in range(0, 25, 3):
        got = opt_mod.schedule(port, torch.tensor(step, dtype=torch.int32))
        want = jax_opt.schedule(ref, jnp.int32(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("name,clip", [("adamw", 1.0), ("adamw", 100.0),
                                       ("sgd", 1.0)])
def test_apply_updates_matches_jax(name, clip):
    """Two updates of a seeded tree (the clip active and not): the same
    f32 operations in the same order per leaf."""
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2)}}
    params = jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda p: (2 * rng.standard_normal(p.shape))
                          .astype(np.float32), params) for _ in range(2)]
    cfg = dict(name=name, grad_clip=clip, warmup_steps=1, total_steps=4)
    port_cfg, jax_cfg = opt_mod.OptConfig(**cfg), jax_opt.OptConfig(**cfg)
    # copies: the port updates in place, and a JAX array may share the
    # numpy buffer it was made from
    tp = jax.tree.map(torch.tensor, params)
    ts = opt_mod.init_opt_state(port_cfg, tp)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_opt.init_opt_state(jax_cfg, jp)
    for g in grads:
        tp, ts = opt_mod.apply_updates(
            port_cfg, jax.tree.map(torch.tensor, g), ts, tp)
        jp, js = jax_opt.apply_updates(jax_cfg, jax.tree.map(jnp.asarray, g),
                                       js, jnp.float32)
    for tree_p, tree_j in ((tp, jp), (ts, js)):
        for (path, got, want) in _pairs(
                jax.tree.map(lambda t: t.numpy(), tree_p),
                jax.device_get(tree_j)):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=path)


def test_token_stream():
    """The successor table is JAX's bit for bit; a batch is pure in
    (seed, step), successor chains with about 10% noise tokens."""
    spec = dict(vocab_size=1000, seq_len=65, batch_size=16, seed=3)
    port = synthetic.TokenStream(synthetic.TokenStreamSpec(**spec))
    ref = jax_data.TokenStream(jax_data.TokenStreamSpec(**spec))
    assert port.v == ref._v == 512
    np.testing.assert_array_equal(port.succ.numpy(), np.asarray(ref._succ))
    x, y = port.batch(5)
    x2, y2 = port.batch(5)
    assert x.shape == y.shape == (16, 64)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert torch.equal(x[:, 1:], y[:, :-1])
    assert not torch.equal(port.batch(6)[0], x)
    assert 0 <= int(x.min()) and int(x.max()) < 512
    # a token follows its predecessor unless either is noise: 0.9^2
    follows = (port.succ[x] == y).float().mean().item()
    assert abs(follows - 0.81) < 0.05


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------

def _both(arch, microbatches=1):
    cfg = jax_get_arch(arch)
    opt = jax_opt.OptConfig(**OPT)
    js = jax_steps.init_train_state(cfg, opt, jax.random.PRNGKey(0))
    ps = train_state_from_jax(jax.device_get(js), device="cpu")
    jstep = jax.jit(jax_steps.make_train_step(cfg, opt,
                                              microbatches=microbatches))
    pstep = steps.make_train_step(get_arch(arch), opt_mod.OptConfig(**OPT),
                                  microbatches=microbatches)
    return cfg, js, ps, jstep, pstep


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    """Two steps on two JAX batches: loss, params, master, m and v after
    each."""
    cfg, js, ps, jstep, pstep = _both(arch)
    unsettled = {}
    for step in range(2):
        tokens = _jax_batch(cfg, step)
        js, jloss = jstep(js, {"tokens": jnp.asarray(tokens)})
        ps, ploss = pstep(ps, {"tokens": torch.tensor(tokens)})
        np.testing.assert_allclose(float(ploss), float(jloss),
                                   rtol=LOSS_RTOL)
        _close_state(ps, js, step + 1, unsettled)


def test_microbatched_train_step_matches_jax():
    cfg, js, ps, jstep, pstep = _both("qwen2.5-3b-smoke", microbatches=2)
    tokens = _jax_batch(cfg, 0)
    js, jloss = jstep(js, {"tokens": jnp.asarray(tokens)})
    ps, ploss = pstep(ps, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=LOSS_RTOL)
    _close_state(ps, js, 1, {})


def test_remat_changes_no_gradient():
    """Rematerialized layers (and hybrid groups) give the grads of the
    plain forward bit for bit."""
    cfg = get_arch("zamba2-2.7b-smoke")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    for p in opt_mod.tree_leaves(params):
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    grads = []
    for remat in (True, False):
        h = lm.forward(cfg, params, tokens, remat=remat)
        grads.append(torch.autograd.grad(
            lm.lm_logits(cfg, params, h).square().mean(),
            opt_mod.tree_leaves(params)))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_remat_recomputes_on_the_callers_backend(monkeypatch):
    """For CUDA tensors autograd runs the backward, and with it the
    recomputation of each checkpointed layer, on a thread of its own,
    where the caller's thread-local ``use_backend`` does not hold; the
    recomputation must still take the caller's lowering.  Here the
    backward runs on another thread and every op records the backend it
    sees."""
    import threading

    from repro_torch.core import policy
    from repro_torch.kernels import ops

    seen = []

    def spy(t):
        seen.append(policy.current_backend())
        return False

    monkeypatch.setattr(ops, "use_hopper", spy)
    cfg = get_arch("qwen2.5-3b-smoke")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    for p in opt_mod.tree_leaves(params):
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(1))
    with policy.use_backend("reference"):
        loss = lm.train_loss(cfg, params, {"tokens": tokens})
    n_forward = len(seen)
    worker = threading.Thread(target=lambda: torch.autograd.grad(
        loss, opt_mod.tree_leaves(params)))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert len(seen) > n_forward              # the layers were recomputed
    assert set(seen) == {policy.Backend.REFERENCE}


def test_train_cli_runs_seq_minus_one_tokens_as_jax(monkeypatch):
    """Both CLIs build the stream at --seq tokens a row and train on
    (inputs, targets) of --seq - 1: the port's batch has --seq tokens,
    JAX's make_batch the same, from streams of the same spec."""
    specs = []
    real = synthetic.TokenStreamSpec

    def spy(*args, **kw):
        specs.append(real(*args, **kw))
        return specs[-1]

    monkeypatch.setattr(train, "TokenStreamSpec", spy)
    batches = []
    real_loop = train.train_loop

    def loop(step_fn, state, stream, *, steps, device, cfg=None, **kw):
        batches.append(train.make_batch(stream, 0, device, cfg)["tokens"])
        return real_loop(step_fn, state, stream, steps=steps, device=device,
                         cfg=cfg, **kw)

    monkeypatch.setattr(train, "train_loop", loop)
    with redirect_stdout(io.StringIO()):
        train.main(["--arch", "qwen2.5-3b-smoke", "--steps", "1",
                    "--batch", "2", "--seq", "12", "--device", "cpu"])
    cfg = jax_get_arch("qwen2.5-3b-smoke")
    jstream = jax_data.TokenStream(jax_data.TokenStreamSpec(
        cfg.vocab_size, 12, 2))
    jtokens = jax_train.make_batch(cfg, jstream, 0, 2, 12)["tokens"]
    assert specs[0].seq_len == 12
    assert tuple(batches[0].shape) == tuple(jtokens.shape) == (2, 12)
    # train_loss runs the forward on tokens[:, :-1]: --seq - 1 of them
    assert batches[0][:, :-1].shape[1] == 11


def test_train_cli_on_the_cpu(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        assert train.main(["--arch", "qwen2.5-3b-smoke", "--steps", "3",
                           "--batch", "2", "--seq", "16", "--log-every", "1",
                           "--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    losses = [float(line.split("loss=")[1].split()[0]) for line in lines
              if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    # --seq 16 builds 16-token rows, so the forward runs 15 tokens a row,
    # as repro.launch.train's does
    assert "3 steps x 2x15 tokens" in lines[0]
    assert lines[-1] == "done at step 3"
    # checkpoints every 2 steps and a fault before step 5 (from 0): the
    # run restores step 4 and runs steps 5 and 6 again; --resume from the
    # directory without step_6 continues at step 4 and logs only steps 5
    # and 6, with the losses of the first run
    argv = ["--arch", "qwen2.5-3b-smoke", "--steps", "6", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    runs = []
    for extra in (["--fail-at", "5"], ["--resume"]):
        out = io.StringIO()
        with redirect_stdout(out):
            assert train.main(argv + extra) == 0
        runs.append(out.getvalue().splitlines())
        if extra == ["--fail-at", "5"]:
            shutil.rmtree(tmp_path / "step_6")
    logged = [[(int(line.split(":")[0].split()[1]),
                line.split("loss=")[1].split()[0])
               for line in lines if line.startswith("step ")]
              for lines in runs]
    assert [s for s, _ in logged[0]] == [1, 2, 3, 4, 5, 5, 6]
    assert "recovered from 1 failure(s) via checkpoint restart" in runs[0]
    assert runs[0][-1] == runs[1][-1] == "done at step 6"
    assert "resumed from step 4" in runs[1]
    assert logged[1] == logged[0][-2:]
