"""The port's Caffe TRAIN phase on the CPU against ``repro.caffe``.

Both LeNets at batch 4 from JAX's init's params (biases perturbed) and
JAX's image batches: ``Net.backward_manual`` against the port's autograd
of ``forward_loss`` and both against JAX's ``backward_manual`` and
``jax.grad`` (also through the paper's transposed boundary mode); two
``Solver.make_train_step`` steps against JAX's from one state
(``convert.caffe_state_from_jax``) under each learning-rate policy; the
train step in every boundary mode; LeNet-MNIST ``solve`` for 30
iterations at batch 16 (``tests/test_caffe.py:211-221``); the functors
against ``repro.core.functor``; and ``examples/quickstart_torch.py`` on
the CPU and its refusal without a card.

Tolerances: gradients, params and velocities within JAX's own rtol 2e-3
/ atol 3e-5 (``tests/test_caffe.py:207``: f32 products over up to 800
terms in another order, through up to 6 layers); losses within 1e-5
relative; the iteration counter and the boundary modes' states (the same
arithmetic on relaid-out copies) within 1e-6; the functors within 1e-6.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.caffe import Net as JaxNet  # noqa: E402
from repro.caffe import Solver as JaxSolver  # noqa: E402
from repro.caffe import lenet as jax_lenet  # noqa: E402
from repro.core import functor as jax_functor  # noqa: E402
from repro.core import use_backend as jax_use_backend  # noqa: E402
from repro.data import synthetic as jax_data  # noqa: E402
from repro_torch.caffe import Net, Solver, lenet  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    caffe_params_from_jax,
    caffe_state_from_jax,
)
from repro_torch.core import functor  # noqa: E402
from repro_torch.data.synthetic import mnist_like  # noqa: E402

RTOL, ATOL = 2e-3, 3e-5
ROOT = Path(__file__).resolve().parents[1]

NETS = {"mnist": (jax_lenet.lenet_mnist, lenet.lenet_mnist,
                  jax_lenet.lenet_mnist_solver, lenet.lenet_mnist_solver,
                  jax_data.mnist_like),
        "cifar10": (jax_lenet.lenet_cifar10, lenet.lenet_cifar10,
                    jax_lenet.lenet_cifar10_solver,
                    lenet.lenet_cifar10_solver, jax_data.cifar10_like)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _perturb(tree, seed=2):
    """Non-zero biases (JAX's init leaves them 0)."""
    rng = np.random.default_rng(seed)
    for p in tree.values():
        if "b" in p:
            p["b"] = (0.1 * rng.standard_normal(p["b"].shape)).astype(
                np.float32)
    return tree


def _batches(stream_fn, n, batch=4):
    s = stream_fn(batch, seed=3)
    return [tuple(np.asarray(a) for a in s.batch(i)) for i in range(n)]


def _close_tree(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k in want[name]:
            np.testing.assert_allclose(
                got[name][k].detach().numpy(), np.asarray(want[name][k]),
                rtol=rtol, atol=atol, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("boundary", [None, "transfer+transpose"])
@pytest.mark.parametrize("name", list(NETS))
def test_backward_manual_matches_autograd_and_jax(name, boundary):
    jmk, pmk, _, _, stream = NETS[name]
    jnet = JaxNet(jmk())
    tree = _perturb(jax.device_get(jnet.init(jax.random.PRNGKey(1), 4)))
    (d, lab), = _batches(stream, 1)
    with jax_use_backend("reference"):
        j_auto = jax.jit(jax.grad(jnet.forward_loss))(tree, d, lab)
        j_manual = jax.jit(jnet.backward_manual)(tree, d, lab)
    net = Net(pmk(), boundary=boundary)
    params = caffe_params_from_jax(tree, device="cpu")
    manual = net.backward_manual(params, _t(d), _t(lab))
    leaves = {n: {k: v.clone().requires_grad_(True) for k, v in p.items()}
              for n, p in params.items()}
    flat = [v for p in leaves.values() for v in p.values()]
    grads = iter(torch.autograd.grad(net.forward_loss(leaves, _t(d),
                                                      _t(lab)), flat))
    auto = {n: {k: next(grads) for k in p} for n, p in leaves.items()}
    for got in (manual, auto):
        _close_tree(got, j_auto)
        _close_tree(got, j_manual)
    _close_tree(manual, {n: {k: v.numpy() for k, v in p.items()}
                         for n, p in auto.items()})


@pytest.mark.parametrize("name,policy", [
    ("mnist", "inv"), ("mnist", "step"), ("cifar10", "fixed"),
    ("cifar10", "inv")])
def test_train_steps_match_jax(name, policy):
    """Two steps from one state: params, velocities, the counter and the
    losses follow JAX's (the step policy halves the rate after step 1)."""
    jmk, pmk, jsolver_fn, psolver_fn, stream = NETS[name]
    kw = dict(lr_policy=policy, batch_size=4)
    if policy == "step":
        kw.update(gamma=0.5, step_size=1)
    jsolver = JaxSolver(JaxNet(jmk()), jsolver_fn(**kw))
    jstate = jsolver.init(jax.random.PRNGKey(1))
    jstate["params"] = _perturb(jax.device_get(jstate["params"]))
    state = caffe_state_from_jax(jax.device_get(jstate), device="cpu")
    assert state["iter"].shape == () and state["iter"].dtype == torch.int32
    step = Solver(Net(pmk()), psolver_fn(**kw)).make_train_step()
    with jax_use_backend("reference"):
        jstep = jsolver.make_train_step()
        for d, lab in _batches(stream, 2):
            jstate, jloss = jstep(jstate, d, lab)
            state, loss = step(state, _t(d), _t(lab))
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
            _close_tree(state["params"], jstate["params"])
            _close_tree(state["velocity"], jstate["velocity"])
            assert int(state["iter"]) == int(jstate["iter"])


def test_train_step_in_every_boundary_mode():
    """The crossings change no result: one step of LeNet-CIFAR-10 from one
    state gives the fused mode's params, each crossing paid in autograd's
    backward too."""
    jsolver = JaxSolver(JaxNet(jax_lenet.lenet_cifar10()),
                        jax_lenet.lenet_cifar10_solver(batch_size=4))
    jstate = jax.device_get(jsolver.init(jax.random.PRNGKey(1)))
    _perturb(jstate["params"])
    (d, lab), = _batches(jax_data.cifar10_like, 1)
    states = {}
    for boundary in (None, "transfer", "transfer+transpose"):
        state = caffe_state_from_jax(jstate, device="cpu")
        step = Solver(Net(lenet.lenet_cifar10(), boundary=boundary),
                      lenet.lenet_cifar10_solver()).make_train_step()
        states[boundary], _ = step(state, _t(d), _t(lab))
    for boundary in ("transfer", "transfer+transpose"):
        _close_tree(states[boundary]["params"],
                    {n: {k: v.numpy() for k, v in p.items()}
                     for n, p in states[None]["params"].items()},
                    rtol=1e-6, atol=1e-7)


def test_lenet_mnist_solve_trains():
    """``tests/test_caffe.py:211-221`` on the port: 30 iterations at batch
    16 halve the loss and pass 0.8 test accuracy."""
    solver = Solver(Net(lenet.lenet_mnist()), lenet.lenet_mnist_solver(
        max_iter=30, batch_size=16, test_interval=30, test_batches=2))
    stream = mnist_like(16, device="cpu")
    state, hist = solver.solve(
        torch.Generator().manual_seed(0), iter(stream),
        test_iter=lambda: stream.eval_iter(), device="cpu")
    assert len(hist["loss"]) == 30 and int(state["iter"]) == 30
    assert hist["loss"][-1] < hist["loss"][0] * 0.5
    assert hist["test_acc"][-1][0] == 30
    assert hist["test_acc"][-1][1] > 0.8


def test_functors_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    v = rng.standard_normal(7).astype(np.float32)
    cases = [
        ("for_each_elementwise", (lambda e, l: e * l + 1.0, x, v)),
        ("for_each_rows", (lambda row, w: row * w - row.sum(), x, v)),
        ("matrix_plus_vector_rows", (x, v)),
        ("for_each_tiles", (lambda t: t * 2.0 + t.sum(), x, (2, 3))),
    ]
    for fn, args in cases:
        want = getattr(jax_functor, fn)(
            *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args])
        got = getattr(functor, fn)(
            *[_t(a) if isinstance(a, np.ndarray) else a for a in args])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6, err_msg=fn)


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch_runs_on_the_cpu(capsys):
    hist = _quickstart().main(["--device", "cpu", "--iters", "2"])
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    assert [it for it, _ in hist["test_acc"]] == [2]
    assert "[reference] final loss" in capsys.readouterr().out


def test_training_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        _quickstart().main(["--iters", "1"])
    solver = Solver(Net(lenet.lenet_mnist()), lenet.lenet_mnist_solver())
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        solver.solve(torch.Generator().manual_seed(0), iter([]))
