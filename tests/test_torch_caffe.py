"""The port's Caffe forward path on the CPU against ``repro.caffe``: each
layer's forward at ``tests/test_caffe.py``'s shapes, ``Net.metrics`` of
both LeNets and the deploy net's ``prob`` blob at batch 4 against JAX's
reference backend (params from JAX's init through
``caffe_params_from_jax``, biases perturbed), the three boundary modes,
the image streams, the spec dataclasses, the containers and the
solver's state (the training parts are held to JAX in
``test_torch_caffe_train.py`` and ``test_torch_caffe_grad.py``).

Tolerances: layer outputs and logits within 1e-5 of their scale (f32
products in another order); losses within 1e-5 relative; accuracy, the
argmax and the prototypes exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.caffe import Net as JaxNet  # noqa: E402
from repro.caffe import lenet as jax_lenet  # noqa: E402
from repro.caffe import spec as jax_spec  # noqa: E402
from repro.caffe.layers import build_layer as jax_build_layer  # noqa: E402
from repro.configs import lenet_cifar10 as jax_cfg_cifar  # noqa: E402
from repro.configs import lenet_mnist as jax_cfg_mnist  # noqa: E402
from repro.core import use_backend as jax_use_backend  # noqa: E402
from repro.data import synthetic as jax_data  # noqa: E402
from repro_torch.caffe import Net, Solver, lenet, spec  # noqa: E402
from repro_torch.caffe.layers import build_layer  # noqa: E402
from repro_torch.configs import lenet_cifar10, lenet_mnist  # noqa: E402
from repro_torch.convert import caffe_params_from_jax  # noqa: E402
from repro_torch.core.container import Blob, MajorOrder, as_layout  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

TOL = 1e-5


def L(name, type_, bottoms, tops, **kw):
    return dict(name=name, type=type_, bottoms=tuple(bottoms),
                tops=tuple(tops), **kw)


def _both_layers(**kw):
    return jax_build_layer(jax_spec.LayerSpec(**kw)), \
        build_layer(spec.LayerSpec(**kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _forward_both(kw, bottom_shapes, bottoms, train=True):
    """One layer through JAX and the port: JAX's init's params (biases
    perturbed) on both sides."""
    jl, pl = _both_layers(**kw)
    jp, jshapes = jl.init(jax.random.PRNGKey(0), bottom_shapes)
    jp = {k: np.asarray(v) + (0.1 * np.random.default_rng(1).standard_normal(
        v.shape).astype(np.float32) if k == "b" else 0)
        for k, v in jp.items()}
    pp = caffe_params_from_jax({"l": jp}, device="cpu").get("l", {})
    assert pl.infer_shapes(bottom_shapes) == list(jshapes)
    jtops, jcache = jl.forward({k: jnp.asarray(v) for k, v in jp.items()},
                               [jnp.asarray(b) for b in bottoms], train)
    ptops, pcache = pl.forward(pp, [_t(b) for b in bottoms], train)
    for got, want in zip(ptops, jtops):
        _close(got.numpy(), want)
    return pcache, jcache


# -- each layer's forward ----------------------------------------------------

@pytest.mark.parametrize("stride,pad", [(1, 0), (1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("bias", [True, False])
def test_convolution_forward(stride, pad, bias):
    x = np.random.default_rng(2).standard_normal((2, 3, 8, 8)).astype(
        np.float32)
    _forward_both(L("c", "Convolution", ["data"], ["out"], num_output=4,
                    kernel_size=3, stride=stride, pad=pad, bias_term=bias),
                  [(2, 3, 8, 8)], [x])


def test_inner_product_forward():
    x = np.random.default_rng(3).standard_normal((4, 3, 5, 5)).astype(
        np.float32)
    _forward_both(L("ip", "InnerProduct", ["data"], ["out"], num_output=7),
                  [(4, 3, 5, 5)], [x])


@pytest.mark.parametrize("pool", ["max", "ave"])
@pytest.mark.parametrize("k,s", [(2, 2), (3, 2)])
def test_pooling_forward(pool, k, s):
    x = np.random.default_rng(4).standard_normal((2, 3, 9, 9)).astype(
        np.float32)
    pcache, jcache = _forward_both(
        L("p", "Pooling", ["data"], ["out"], kernel_size=k, stride=s,
          pool=pool), [(2, 3, 9, 9)], [x])
    assert pcache["x_shape"] == tuple(jcache["x_shape"])
    if pool == "max":
        np.testing.assert_array_equal(pcache["arg"].numpy(),
                                      np.asarray(jcache["arg"]))


@pytest.mark.parametrize("slope", [0.0, 0.1])
def test_relu_forward(slope):
    x = np.array([-2.0, -0.5, 0.0, 0.5, 2.0], np.float32)
    _forward_both(L("r", "ReLU", ["x"], ["y"], negative_slope=slope),
                  [(5,)], [x])


def test_softmax_forward():
    x = 5 * np.random.default_rng(5).standard_normal((6, 10)).astype(
        np.float32)
    pcache, _ = _forward_both(L("s", "Softmax", ["x"], ["p"]), [(6, 10)],
                              [x])
    np.testing.assert_allclose(pcache["p"].sum(-1).numpy(), np.ones(6),
                               rtol=1e-6)


def test_softmax_with_loss_forward():
    x = np.random.default_rng(6).standard_normal((8, 10)).astype(np.float32)
    lab = np.random.default_rng(7).integers(0, 10, 8).astype(np.int32)
    pcache, jcache = _forward_both(
        L("l", "SoftmaxWithLoss", ["x", "label"], ["loss"],
          loss_weight=0.5), [(8, 10), (8,)], [x, lab])
    _close(pcache["probs"].numpy(), jcache["probs"])


@pytest.mark.parametrize("top_k", [1, 5])
def test_accuracy_forward(top_k):
    rng = np.random.default_rng(8)
    x = rng.integers(0, 3, (16, 10)).astype(np.float32)   # ties
    lab = rng.integers(0, 10, 16).astype(np.int32)
    _forward_both(L("a", "Accuracy", ["x", "label"], ["acc"], top_k=top_k),
                  [(16, 10), (16,)], [x, lab], train=False)


# -- the nets ----------------------------------------------------------------

NETS = {"mnist": (jax_lenet.lenet_mnist, lenet.lenet_mnist,
                  jax_data.mnist_like),
        "cifar10": (jax_lenet.lenet_cifar10, lenet.lenet_cifar10,
                    jax_data.cifar10_like)}


def _deploy(mk, spec_module):
    """Caffe's lenet.prototxt form: the net's layers and a Softmax ``prob``
    on ``ip2``; run without labels, the loss and accuracy are skipped."""
    s = mk()
    return dataclasses.replace(s, layers=s.layers + (spec_module.LayerSpec(
        name="prob", type="Softmax", bottoms=("ip2",), tops=("prob",)),))


def _net_inputs(name, batch=4):
    jmk, pmk, stream = NETS[name]
    jnet = JaxNet(jmk())
    tree = jax.device_get(jnet.init(jax.random.PRNGKey(1), batch))
    rng = np.random.default_rng(2)
    for p in tree.values():
        if "b" in p:
            p["b"] = (0.1 * rng.standard_normal(p["b"].shape)).astype(
                np.float32)
    d, lab = stream(batch, seed=3).batch(0)
    return jmk, pmk, tree, np.asarray(d), np.asarray(lab)


@pytest.fixture(scope="module")
def jax_nets():
    """Per net: the inputs and JAX's ip2 blob, metrics and loss under the
    reference backend (one jitted forward each)."""
    out = {}
    for name in NETS:
        jmk, pmk, tree, d, lab = _net_inputs(name)
        jnet = JaxNet(jmk())

        def run(p, d, lab, jnet=jnet):
            return (jnet.forward(p, d, lab, train=False)[0],
                    jnet.metrics(p, d, lab), jnet.forward_loss(p, d, lab))

        with jax_use_backend("reference"):
            blobs, m, loss = jax.jit(run)(tree, d, lab)
        out[name] = (pmk, tree, d, lab, np.asarray(blobs["ip2"]),
                     {k: float(v) for k, v in m.items()}, float(loss),
                     {k: tuple(v.shape) for k, v in blobs.items()})
    return out


@pytest.mark.parametrize("name", list(NETS))
def test_net_metrics_match_jax(jax_nets, name):
    pmk, tree, d, lab, ip2, jm, _, jshapes = jax_nets[name]
    net = Net(pmk())
    pp = caffe_params_from_jax(tree, device="cpu")
    blobs, _ = net.forward(pp, _t(d), _t(lab), train=False)
    m = Solver(net, lenet.lenet_mnist_solver()).make_eval_step()(
        pp, _t(d), _t(lab))
    _close(blobs["ip2"].numpy(), ip2)
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=TOL)
    assert float(m["accuracy"]) == jm["accuracy"]
    np.testing.assert_allclose(float(net.forward_loss(pp, _t(d), _t(lab))),
                               jm["loss"], rtol=TOL)
    # every blob shape is JAX's
    assert {k: tuple(v.shape) for k, v in blobs.items()} == jshapes


def test_deploy_net_prob_matches_jax():
    jmk, pmk, tree, d, _ = _net_inputs("mnist")
    jnet = JaxNet(_deploy(jmk, jax_spec))
    with jax_use_backend("reference"):
        jblobs, jcaches = jax.jit(jnet.forward)(tree, d)
    net = Net(_deploy(pmk, spec))
    blobs, caches = net.forward(caffe_params_from_jax(tree, device="cpu"),
                                _t(d))
    assert "loss" not in blobs and "accuracy" not in blobs
    assert set(caches) == set(jcaches)
    _close(blobs["prob"].numpy(), jblobs["prob"])
    np.testing.assert_allclose(blobs["prob"].sum(-1).numpy(), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("name", list(NETS))
def test_boundary_modes_give_equal_losses(jax_nets, name):
    """The paper's §4.3 crossings change no result: the three modes give
    JAX's loss, and the transposed blobs are column-major."""
    pmk, tree, d, lab, _, _, want, _ = jax_nets[name]
    pp = caffe_params_from_jax(tree, device="cpu")
    for boundary in (None, "transfer", "transfer+transpose"):
        net = Net(pmk(), boundary=boundary)
        got = float(net.forward_loss(pp, _t(d), _t(lab)))
        assert got == pytest.approx(want, rel=1e-6), boundary
    crossed = Net(pmk(), boundary="transfer+transpose")._cross(_t(d))
    assert crossed.stride() == tuple(reversed(
        torch.empty(tuple(reversed(d.shape))).stride()))
    with pytest.raises(ValueError, match="boundary"):
        Net(pmk(), boundary="transpose")


def test_init_shapes_and_fillers():
    """Param shapes and blob shapes are JAX's; xavier is bounded by
    sqrt(3 / fan_in), gaussian has the spec's std, biases are zero, and
    the draws are pure in the generator's seed."""
    for jmk, pmk, _ in NETS.values():
        jnet, net = JaxNet(jmk()), Net(pmk())
        jp = jnet.init(jax.random.PRNGKey(0), 4)
        pp = net.init(torch.Generator().manual_seed(0), 4, device="cpu")
        assert {k: {n: tuple(v.shape) for n, v in p.items()}
                for k, p in pp.items()} == \
            {k: {n: tuple(v.shape) for n, v in p.items()}
             for k, p in jp.items()}
        assert net.blob_shapes == jnet.blob_shapes
        again = net.init(torch.Generator().manual_seed(0), 4, device="cpu")
        for layer in net.layers:
            if layer.name not in pp:
                continue
            w = pp[layer.name]["w"]
            assert torch.equal(w, again[layer.name]["w"])
            assert not pp[layer.name]["b"].any()
            s = layer.spec
            fan_in = w[0].numel() if s.type == "Convolution" else w.shape[0]
            if s.weight_filler == "xavier":
                assert float(w.abs().max()) <= (3.0 / fan_in) ** 0.5
                assert float(w.abs().max()) > 0.9 * (3.0 / fan_in) ** 0.5
            else:
                assert abs(float(w.std()) / s.filler_std - 1) < 0.1


def test_solver_state_and_what_waits_for_training():
    solver = Solver(Net(lenet.lenet_mnist()), lenet.lenet_mnist_solver())
    state = solver.init(torch.Generator().manual_seed(0), device="cpu")
    assert set(state) == {"params", "velocity", "iter"}
    assert int(state["iter"]) == 0 and state["iter"].dtype == torch.int32
    for name, p in state["params"].items():
        for k, v in p.items():
            assert state["velocity"][name][k].shape == v.shape
            assert not state["velocity"][name][k].any()
    # the training parts run (``test_torch_caffe_train.py`` holds them to
    # JAX): the explicit backward gives a gradient per param, and a train
    # step advances the counter in place and moves the params
    data, label = synthetic.mnist_like(4, device="cpu").batch(0)
    grads = solver.net.backward_manual(state["params"], data, label)
    assert {n: {k: v.shape for k, v in p.items()} for n, p in grads.items()} \
        == {n: {k: v.shape for k, v in p.items()}
            for n, p in state["params"].items()}
    w0 = state["params"]["ip2"]["w"].clone()
    out, loss = solver.make_train_step()(state, data, label)
    assert out is state and int(state["iter"]) == 1
    assert torch.isfinite(loss) and not torch.equal(w0,
                                                    state["params"]["ip2"]["w"])


# -- data, specs, containers --------------------------------------------------

@pytest.mark.parametrize("mk", ["mnist_like", "cifar10_like"])
def test_image_stream(mk):
    """Prototypes bit-identical to JAX's; batches pure in (seed, step), on
    the stream's device, each image its class prototype plus noise of the
    spec's scale."""
    port = getattr(synthetic, mk)(16, seed=5, device="cpu")
    ref = getattr(jax_data, mk)(16, seed=5)
    assert dataclasses.asdict(port.spec) == dataclasses.asdict(ref.spec)
    np.testing.assert_array_equal(port.protos.numpy(),
                                  np.asarray(ref._protos))
    d, lab = port.batch(7)
    d2, lab2 = port.batch(7)
    assert torch.equal(d, d2) and torch.equal(lab, lab2)
    assert not torch.equal(port.batch(8)[0], d)
    assert d.shape == (16, *port.spec.shape) and d.dtype == torch.float32
    assert lab.dtype == torch.int64 and 0 <= int(lab.min()) \
        and int(lab.max()) < 10
    noise = d - port.protos[lab]
    assert abs(float(noise.std()) / port.spec.noise - 1) < 0.05
    assert port.batch(0, batch_size=3)[0].shape[0] == 3
    first = next(iter(port))
    assert torch.equal(first[0], port.batch(0)[0])
    assert torch.equal(next(port.eval_iter())[1], port.batch(10_000)[1])


def test_specs_match_jax_field_for_field():
    for cls in ("LayerSpec", "NetSpec", "SolverSpec"):
        jf = dataclasses.fields(getattr(jax_spec, cls))
        pf = dataclasses.fields(getattr(spec, cls))
        assert [(f.name, f.default) for f in pf] == \
            [(f.name, f.default) for f in jf], cls
    for name in ("lenet_mnist", "lenet_cifar10", "lenet_mnist_solver",
                 "lenet_cifar10_solver"):
        assert dataclasses.asdict(getattr(lenet, name)()) == \
            dataclasses.asdict(getattr(jax_lenet, name)()), name
    assert dataclasses.asdict(lenet_mnist.NET) == \
        dataclasses.asdict(jax_cfg_mnist.NET)
    assert dataclasses.asdict(lenet_cifar10.SOLVER) == \
        dataclasses.asdict(jax_cfg_cifar.SOLVER)
    assert lenet.lenet_mnist().layer("ip1").num_output == 500
    for policy in ("inv", "fixed", "step"):
        kw = dict(lr_policy=policy, gamma=0.5 if policy == "step" else 1e-4,
                  step_size=3)
        ps, js = spec.SolverSpec(**kw), jax_spec.SolverSpec(**kw)
        for it in (0, 1, 7, 100):
            np.testing.assert_allclose(float(ps.learning_rate(it)),
                                       float(js.learning_rate(it)),
                                       rtol=1e-6)


def test_containers():
    x = torch.arange(24.0).reshape(2, 3, 4)
    col = as_layout(x, MajorOrder.ROW, MajorOrder.COLUMN)
    assert torch.equal(col, x) and col.stride() == (1, 2, 6)
    assert col.data_ptr() != x.data_ptr()
    assert as_layout(x, MajorOrder.ROW, MajorOrder.ROW) is x
    assert torch.equal(as_layout(col, MajorOrder.COLUMN, MajorOrder.ROW), x)
    b = Blob(x)
    assert (b.shape, b.count, b.num, b.dtype) == ((2, 3, 4), 24, 2,
                                                  torch.float32)
    assert b.diff is None and not b.ensure_diff().diff.any()
    assert b.reshape((6, 4)).shape == (6, 4)
    assert torch.equal(b.as_matrix(2, 12, transpose=True), x.reshape(2, 12).T)
    assert b.as_vector().shape == (24,)
    assert Blob.zeros((3,)).count == 3
    assert torch.equal(b.with_diff(x).diff, x) and b.with_data(x).diff is None
