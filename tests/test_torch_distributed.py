"""The port's checkpoint/restart, fault tolerance, meshes, gradient
compression and manual-data-parallel step on the CPU, against the JAX
package.

JAX's own cases of these modules (``tests/test_distributed.py``,
``tests/test_system.py``) are mirrored on the port.  Checkpoint
directories cross both ways bit for bit: JAX's ``Checkpointer`` writes a
bf16 ``init_train_state`` of a dense and a hybrid smoke arch (``groups``
stacks two axes) that the port restores in place, and the port writes one
that JAX restores.  Compression is held to JAX's bit for bit, the manual-DP
step to JAX's within ``test_torch_train``'s tolerances (and, with codec
``none``, to the port's own ``make_train_step`` bit for bit), and a
restarted run of a port train state to the fault-free run bit for bit (the
CPU is deterministic).  Every process group is torn down by the ``gloo``
fixture that made it.
"""
import dataclasses
import io
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.data import synthetic as jax_data  # noqa: E402
from repro.distributed import checkpoint as jax_ckpt  # noqa: E402
from repro.distributed import fault_tolerance as jax_ft  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.optim import compress as jax_gc  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import to_jax_layout, train_state_from_jax  # noqa: E402
from repro_torch.data.synthetic import TokenStream, TokenStreamSpec  # noqa: E402
from repro_torch.distributed.checkpoint import Checkpointer  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    ElasticPlan,
    FaultInjector,
    StragglerPolicy,
    plan_after_failure,
    run_with_restarts,
)
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.optim import compress as GC  # noqa: E402
from repro_torch.optim.optimizers import OptConfig, tree_leaves  # noqa: E402
from test_torch_train import (  # noqa: E402
    LOSS_RTOL,
    MOMENT_ATOL,
    OPT,
    _close_state,
    _jax_batch,
    _pairs,
)

CPU = torch.device("cpu")


@pytest.fixture
def gloo():
    """The single-rank gloo mesh ("data", "model"), its group destroyed
    after the test."""
    mesh = mesh_mod.make_mesh_for(1, 1, device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def _bits(x):
    """A tensor or array as numpy, floats as integers of their bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same(a, b, what=""):
    assert tuple(a.shape) == tuple(b.shape), what
    assert str(a.dtype).split(".")[-1] == str(b.dtype).split(".")[-1], what
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def _same_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        _same(x, y, f"leaf {i}")


# ---------------------------------------------------------------------------
# checkpoint (tests/test_distributed.py's cases)
# ---------------------------------------------------------------------------

def _state():
    return {
        "params": {"w": torch.arange(6.0).reshape(2, 3),
                   "b": torch.ones(3, dtype=torch.bfloat16),
                   "layers": [{"a": torch.full((2,), float(i))}
                              for i in range(3)]},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "m": {"w": torch.full((2, 3), 0.5), "b": torch.zeros(3)}},
    }


def _zeros(tree):
    def z(t):
        if isinstance(t, dict):
            return {k: z(v) for k, v in t.items()}
        if isinstance(t, list):
            return [z(v) for v in t]
        return torch.zeros_like(t)
    return z(tree)


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    st_ = _state()
    ck.save(10, st_)
    assert ck.all_steps() == [10]
    target = _zeros(st_)
    for p in tree_leaves(target["params"]):
        p.requires_grad_(True)
    ids = [id(t) for t in tree_leaves(target)]
    got = ck.restore(10, target)
    assert got is target and [id(t) for t in tree_leaves(got)] == ids
    _same_trees(got, st_)
    assert all(p.is_leaf and p.requires_grad
               for p in tree_leaves(got["params"]))
    # the per-layer list is one stacked leaf, under JAX's path name
    assert np.load(tmp_path / "step_10" / "params~layers~a.npy").shape == \
        (3, 2)


def test_checkpoint_retention_and_latest(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state())
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_async(tmp_path):
    """The snapshot is taken before ``save`` returns: an in-place update
    right after it does not reach the file."""
    ck = Checkpointer(tmp_path, keep=3)
    st_ = _state()
    want = _zeros(st_)
    for a, b in zip(tree_leaves(want), tree_leaves(st_)):
        a.copy_(b)
    ck.save(5, st_, blocking=False)
    for t in tree_leaves(st_):
        t.add_(1)
    ck.wait()
    assert not ck.pending() and ck.latest_step() == 5
    _same_trees(ck.restore(5, _zeros(st_)), want)


def test_checkpoint_async_error_reaches_wait(tmp_path, monkeypatch):
    ck = Checkpointer(tmp_path)

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", fail)
    ck.save(1, _state(), blocking=False)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert ck.all_steps() == []


def test_checkpoint_atomicity(tmp_path):
    """A leftover .tmp dir (crashed writer) is never listed as a step."""
    ck = Checkpointer(tmp_path)
    (tmp_path / "step_99.tmp").mkdir()
    assert ck.all_steps() == []
    ck.save(1, _state())
    assert ck.all_steps() == [1]


def test_checkpoint_manifest(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(3, _state(), extra={"mesh": "16x16", "data_position": 3})
    m = ck.manifest(3)
    assert m["step"] == 3 and m["mesh"] == "16x16"
    assert m["data_position"] == 3 and m["format"] == 1
    assert m["dtypes"]["params~b"] == "bfloat16"
    assert m["leaves"] == sorted(m["leaves"]) and "opt~step" in m["leaves"]


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

CKPT_ARCHS = ["qwen2.5-3b-smoke", "zamba2-2.7b-smoke"]


@pytest.fixture(scope="module")
def jax_states():
    """arch -> (JAX bf16 ``init_train_state`` of it, the port's config)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = dataclasses.replace(jax_get_arch(arch), dtype="bfloat16")
            js = jax_steps.init_train_state(cfg, jax_opt.OptConfig(**OPT),
                                            jax.random.PRNGKey(0))
            cache[arch] = (js, dataclasses.replace(get_arch(arch),
                                                   dtype="bfloat16"))
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_jax_checkpoint_restores_into_the_port(tmp_path, jax_states, arch):
    js, pcfg = jax_states(arch)
    jax_ckpt.Checkpointer(tmp_path).save(3, js)
    want = train_state_from_jax(jax.device_get(js), device="cpu")
    target = steps.init_train_state(pcfg, OptConfig(**OPT), 1, device="cpu")
    ids = [id(t) for t in tree_leaves(target)]
    got = Checkpointer(tmp_path).restore(3, target)
    assert [id(t) for t in tree_leaves(got)] == ids
    assert all(p.is_leaf and p.requires_grad
               for p in tree_leaves(got["params"]))
    _same_trees(got, want)


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_port_checkpoint_restores_into_jax(tmp_path, jax_states, arch):
    js, pcfg = jax_states(arch)
    state = steps.init_train_state(pcfg, OptConfig(**OPT), 1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for t in tree_leaves(state["opt"]["m"]) + tree_leaves(
                state["opt"]["v"]):
            t.normal_(generator=gen)
        state["opt"]["step"].fill_(4)
    Checkpointer(tmp_path / "port").save(4, state)
    jax_ckpt.Checkpointer(tmp_path / "jax").save(4, js)
    pm = Checkpointer(tmp_path / "port").manifest(4)
    jm = jax_ckpt.Checkpointer(tmp_path / "jax").manifest(4)
    assert pm["leaves"] == jm["leaves"] and pm["dtypes"] == jm["dtypes"]
    got = jax_ckpt.Checkpointer(tmp_path / "port").restore(4, js)
    want = to_jax_layout(state)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want) == len(pm["leaves"])
    for path, g in flat_got:
        w = np.asarray(flat_want[path])
        g = np.asarray(g)
        if g.dtype.name == "bfloat16":
            w = w.astype(g.dtype)       # exact: to_jax_layout widened it
        _same(g, w, jax_ckpt._path_str(path))


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_run_with_restarts_recovers(tmp_path):
    ck = Checkpointer(tmp_path)
    inj = FaultInjector(fail_at=[5])
    calls = {"n": 0}

    def train_fn(start, state):
        calls["n"] += 1
        for s in range(start, 10):
            inj.maybe_fail(s)
            state["x"].add_(1)
            if (s + 1) % 2 == 0:
                ck.save(s + 1, state)
        return state, 10

    state, final, restarts = run_with_restarts(
        train_fn, ck, {"x": torch.zeros(())}, max_restarts=2)
    assert final == 10 and restarts == 1 and calls["n"] == 2
    assert float(state["x"]) == 10.0


def test_run_with_restarts_gives_up(tmp_path):
    ck = Checkpointer(tmp_path)

    def train_fn(start, state):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError):
        run_with_restarts(train_fn, ck, {}, max_restarts=2)


def _train_setup():
    cfg = get_arch("qwen2.5-3b-smoke")
    opt = OptConfig(**OPT)
    stream = TokenStream(TokenStreamSpec(cfg.vocab_size, 9, 2))
    return (cfg, stream, steps.make_train_step(cfg, opt),
            lambda: steps.init_train_state(cfg, opt, 0, device="cpu"))


@pytest.fixture(scope="module")
def fault_free():
    """4 steps of the smoke qwen train state with no fault: (losses, final
    state)."""
    cfg, stream, step_fn, fresh = _train_setup()
    state = fresh()
    losses = [rec["loss"] for rec in train.train_loop(
        step_fn, state, stream, steps=4, device=CPU, cfg=cfg)]
    return losses, state


@pytest.mark.parametrize("init", ["callable", "state"])
@pytest.mark.parametrize("fault", ["before-first-ckpt", "after-first-ckpt",
                                   "inside-a-step"])
def test_restart_of_a_train_state_is_bitwise_fault_free(
        tmp_path, fault_free, init, fault):
    """A fault before the first checkpoint (step 1 of 4, checkpoints every
    2) restarts from a fresh initial state, not the one the first step
    updated in place; a fault after it (step 3), or inside step 3 after
    the update wrote half of the leaves, restores every leaf of
    checkpoint 2.  Both end bit for bit as the fault-free run."""
    cfg, stream, step_fn, fresh = _train_setup()
    ck = Checkpointer(tmp_path, keep=2)
    fail_at = {"before-first-ckpt": [1], "after-first-ckpt": [3]}.get(
        fault, [])
    injector = FaultInjector(fail_at)
    calls = {"n": 0}

    def faulty_step(state, batch):
        calls["n"] += 1
        state, loss = step_fn(state, batch)
        if fault == "inside-a-step" and calls["n"] == 3:
            leaves = tree_leaves(state)
            with torch.no_grad():
                for t in leaves[: len(leaves) // 2]:
                    t.add_(1)
            raise RuntimeError("fault inside the update")
        return state, loss

    losses = {}

    def train_range(start, state):
        for rec in train.train_loop(faulty_step, state, stream, steps=4,
                                    device=CPU, cfg=cfg, start=start,
                                    ckpt=ck, ckpt_every=2,
                                    injector=injector):
            losses[rec["step"]] = rec["loss"]
        ck.wait()
        return state, 4

    state, final, restarts = run_with_restarts(
        train_range, ck, fresh if init == "callable" else fresh(),
        max_restarts=2)
    want_losses, want_state = fault_free
    assert (final, restarts) == (4, 1)
    assert [losses[s] for s in range(1, 5)] == want_losses
    _same_trees(state, want_state)


# ---------------------------------------------------------------------------
# elastic plan, meshes, straggler policy
# ---------------------------------------------------------------------------

def test_elastic_plan_after_failure():
    plan = plan_after_failure(total_devices=256, lost=13, model_parallel=16)
    assert plan.viable()
    assert plan.data_parallel == 15          # 243 // 16
    assert plan.devices_used == 240
    assert plan.global_batch_for(16) == 240

    dead = plan_after_failure(total_devices=16, lost=8, model_parallel=16)
    assert not dead.viable()


@pytest.mark.parametrize("total,lost,mp", [(256, 13, 16), (16, 8, 16),
                                           (512, 1, 8), (4, 1, 1),
                                           (8, 0, 4)])
def test_elastic_plan_matches_jax(total, lost, mp):
    got = plan_after_failure(total, lost, mp)
    want = jax_ft.plan_after_failure(total, lost, mp)
    assert (got.viable(), got.data_parallel, got.devices_used,
            got.global_batch_for(16)) == (
        want.viable(), want.data_parallel, want.devices_used,
        want.global_batch_for(16))


def test_elastic_mesh_builds_on_available_devices():
    mesh = ElasticPlan(n_devices=1, model_parallel=1).make_mesh(device="cpu")
    try:
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
    finally:
        torch.distributed.destroy_process_group()


def test_elastic_restore_onto_new_mesh(tmp_path, gloo):
    """Checkpoints are mesh-agnostic: restore with the (1, 1) mesh, or a
    tree of devices, as the placement."""
    ck = Checkpointer(tmp_path)
    st_ = _state()
    ck.save(1, st_)
    _same_trees(ck.restore(1, _zeros(st_), shardings=gloo), st_)
    devices = {"params": {"w": "cpu", "b": "cpu", "layers": ["cpu"] * 3},
               "opt": {"step": "cpu", "m": {"w": "cpu", "b": "cpu"}}}
    _same_trees(ck.restore(1, _zeros(st_), shardings=devices), st_)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(1, _zeros(st_), shardings={"params": "cpu"})


def test_mesh_factories(gloo):
    assert gloo.mesh_dim_names == ("data", "model")
    assert mesh_mod.data_axes_of(gloo) == ("data",)
    assert mesh_mod.model_axes_of(gloo) == ("model",)
    # a mesh spans the whole process group, as jax.make_mesh spans every
    # device
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        mesh_mod.make_mesh_for(2, device="cpu")
    with pytest.raises(ValueError, match="model parallel"):
        mesh_mod.make_mesh_for(3, 2, device="cpu")
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} ranks"):
            mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                          device="cpu")


def test_straggler_detection():
    pol = StragglerPolicy(n_hosts=8, threshold=2.0)
    normal = [1.0] * 8
    for _ in range(3):
        assert pol.observe(normal) == []
    slow = list(normal)
    slow[3] = 10.0
    for _ in range(5):
        bad = pol.observe(slow)
    assert bad == [3]


def test_straggler_reassignment_deterministic_and_excluding():
    pol = StragglerPolicy(n_hosts=8)
    a1 = pol.assignment(step=42, exclude=[3])
    a2 = pol.assignment(step=42, exclude=[3])
    assert a1 == a2
    assert 3 not in set(a1.values())
    assert set(a1.keys()) == set(range(8))


@pytest.mark.parametrize("seed", [0, 1])
def test_straggler_policy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    got, want = StragglerPolicy(n_hosts=6), jax_ft.StragglerPolicy(n_hosts=6)
    for step in range(8):
        times = rng.uniform(0.5, 1.5, 6)
        times[step % 6] *= 5
        assert got.observe(times) == want.observe(times)
        np.testing.assert_array_equal(got.ema, want.ema)
        excl = [step % 6]
        assert got.assignment(step, excl) == want.assignment(step, excl)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def _grad_tree(seed):
    """A seeded grad tree with an all-zero leaf (the 1e-12 scale floor)
    and an error-feedback tree of its structure."""
    rng = np.random.default_rng(seed)
    g = {"a": (0.1 * rng.standard_normal((8, 16))).astype(np.float32),
         "b": {"c": np.zeros((5,), np.float32),
               "d": (10 * rng.standard_normal(3)).astype(np.float32)}}
    ef = jax.tree.map(lambda x: (0.01 * rng.standard_normal(x.shape))
                      .astype(np.float32), g)
    ef["b"]["c"][:] = 0
    return g, ef


def _port(tree):
    return jax.tree.map(torch.tensor, tree)


@pytest.mark.parametrize("codec", GC.CODECS)
def test_compress_matches_jax_bitwise(codec):
    g, ef = _grad_tree(0)
    pq, ps, pe = GC.compress(_port(g), _port(ef), codec)
    jq, js_, je = jax_gc.compress(jax.tree.map(jnp.asarray, g),
                                  jax.tree.map(jnp.asarray, ef), codec)
    for got, want in ((pq, jq), (pe, je)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            _same(a, np.asarray(b))
    if codec == "int8":
        for a, b in zip(tree_leaves(ps), jax.tree.leaves(js_)):
            _same(a, np.asarray(b))
        assert float(tree_leaves(ps)[1]) == np.float32(1e-12) / 127
    else:
        assert ps is None and js_ is None
    pd = GC.decompress(pq, ps, codec)
    jd = jax_gc.decompress(jq, js_, codec)
    for a, b in zip(tree_leaves(pd), jax.tree.leaves(jd)):
        _same(a, np.asarray(b))


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_compress_roundtrip_error_bounded(codec):
    g = {"w": torch.tensor(0.1 * np.random.default_rng(0).standard_normal(
        (64, 64)), dtype=torch.float32)}
    ef = GC.init_error_feedback(g)
    q, scales, ef2 = GC.compress(g, ef, codec)
    deq = GC.decompress(q, scales, codec)
    assert float((deq["w"] - g["w"]).abs().max()) < 2e-3
    torch.testing.assert_close(ef2["w"], g["w"] - deq["w"], rtol=0,
                               atol=1e-7)


def test_error_feedback_preserves_sum():
    """Over many steps, compressed sum + residual == true sum."""
    rng = np.random.default_rng(0)
    total = torch.zeros(32)
    applied = torch.zeros(32)
    ef = {"g": torch.zeros(32)}
    for _ in range(50):
        g = {"g": torch.tensor(0.01 * rng.standard_normal(32),
                               dtype=torch.float32)}
        total += g["g"]
        q, s, ef = GC.compress(g, ef, "int8")
        applied += GC.decompress(q, s, "int8")["g"]
    torch.testing.assert_close(applied + ef["g"], total, rtol=0, atol=1e-5)


@settings(max_examples=25, deadline=None)
@given(st.sampled_from(["bf16", "int8"]), st.integers(0, 2**31 - 1),
       st.floats(0.001, 10.0))
def test_compression_error_feedback_invariant(codec, seed, scale):
    """decode(encode(g + ef)) + new_ef == g + ef (EF bookkeeping)."""
    rng = np.random.default_rng(seed)
    g = {"x": torch.tensor(rng.standard_normal(16) * scale,
                           dtype=torch.float32)}
    ef = {"x": torch.tensor(rng.standard_normal(16) * 0.01,
                            dtype=torch.float32)}
    q, s, ef2 = GC.compress(g, ef, codec)
    deq = GC.decompress(q, s, codec)
    torch.testing.assert_close(deq["x"] + ef2["x"], g["x"] + ef["x"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("codec", GC.CODECS)
def test_psum_compressed_matches_jax_shard_map(gloo, codec):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    g, ef = _grad_tree(1)
    jmesh = jax.make_mesh((1,), ("d",))
    jred, jef = shard_map(
        lambda g, e: jax_gc.psum_compressed(g, e, "d", codec),
        mesh=jmesh, in_specs=(P(), P()), out_specs=P(), check_rep=False,
    )(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, ef))
    pg = _port(g)
    red, new_ef = GC.psum_compressed(pg, _port(ef), gloo.get_group("data"),
                                     codec)
    for got, want in ((red, jred), (new_ef, jef)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            _same(a, np.asarray(b))
    _same_trees(pg, _port(g))               # the caller's grads untouched


def test_psum_compressed_keeps_a_transposed_grads_layout(gloo, monkeypatch):
    """A weight's grad may be a transposed view: the all-reduce runs on a
    contiguous view of its memory (NCCL refuses strided tensors; gloo,
    here, would not), so the result keeps the grad's strides (the
    optimizer's global norm sums in that order) and its values."""
    real = torch.distributed.all_reduce

    def nccl_rule(t, *args, **kw):
        assert t.is_contiguous(), t.stride()
        return real(t, *args, **kw)

    monkeypatch.setattr(torch.distributed, "all_reduce", nccl_rule)
    g = {"w": torch.arange(12.0).reshape(3, 4).t()}
    for codec in GC.CODECS:
        ef = GC.init_error_feedback(g)
        red, _ = GC.psum_compressed(g, ef, gloo.get_group("data"), codec)
        want = GC.decompress(*GC.compress(g, ef, codec)[:2], codec)
        assert red["w"].stride() == g["w"].stride() == (1, 4)
        _same(red["w"], want["w"])


# ---------------------------------------------------------------------------
# the manual-DP step
# ---------------------------------------------------------------------------

def _close_dp_state(port_state, jax_state, steps_taken, unsettled, flips):
    """``_close_state`` for a compressed step.  The codec rounds each
    corrected gradient (grad + error feedback) to a bf16 or int8 step;
    where the two sides' values sit within their summation noise of a
    rounding boundary, each side rounds its own value the other way: their
    new residuals have opposite signs and differ by one step.  Such a
    "flipped" element (``flips``: path -> (mask, m budget), kept across
    steps) may not pass 1% of a leaf.  Elsewhere the residuals are held
    at the grads' own scale (that of m / (1 - b1): a residual carries its
    gradient's absolute noise) like the moments.  At a flipped element
    m may differ by (1 - b1) times the residual gaps summed over the steps
    that flipped (the payload moved by that much), v and the residual are
    not held, and the params and master take ``_close_state``'s budget
    for unsettled elements (two learning rates a step)."""
    b1 = OptConfig().b1
    rel = 5e-5 if steps_taken == 1 else MOMENT_ATOL
    jopt = jax.device_get(jax_state["opt"])
    fake = {"params": to_jax_layout(port_state["params"]),
            "opt": {"step": port_state["opt"]["step"].numpy(),
                    "ef": jopt["ef"]}}
    for key in ("master", "m", "v"):
        fake["opt"][key] = to_jax_layout(port_state["opt"][key])
    for (path, e_p, e_j), (_, m_p, m_j) in zip(
            _pairs(to_jax_layout(port_state["opt"]["ef"]), jopt["ef"]),
            _pairs(fake["opt"]["m"], jopt["m"])):
        atol = rel * np.abs(m_j).max() / (1 - b1)
        gap = np.abs(e_p - e_j)
        flip = (np.sign(e_p) != np.sign(e_j)) & (gap > atol)
        mask, budget = flips.get(path, (np.zeros(gap.shape, bool), 0.0))
        mask, budget = mask | flip, budget + (1 - b1) * np.where(flip, gap,
                                                                 0.0)
        flips[path] = (mask, budget)
        assert mask.mean() <= 1e-2, (path, int(mask.sum()))
        out = (gap > atol + 2e-3 * np.abs(e_j)) & ~mask
        assert not out.any(), ("ef" + path, int(out.sum()),
                               float(gap[out].max()))
        m_atol = rel * np.abs(m_j).max() + 2e-3 * np.abs(m_j)
        assert (np.abs(m_p - m_j) <= budget + m_atol)[mask].all(), path
        unsettled[path] = unsettled.get(path, False) | mask
        # the flipped elements' moments are held above, not below
        node_m, node_v = fake["opt"]["m"], fake["opt"]["v"]
        ref_v = jopt["v"]
        for k in path.strip("/").split("/")[:-1]:
            node_m, node_v, ref_v = node_m[k], node_v[k], ref_v[k]
        last = path.rsplit("/", 1)[1]
        node_m[last] = np.where(mask, m_j, m_p)
        node_v[last] = np.where(mask, np.asarray(ref_v[last]), node_v[last])
    _close_state(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), fake),
                 jax_state,
                 steps_taken, unsettled)


@pytest.mark.parametrize("codec", GC.CODECS)
def test_manual_dp_step_matches_jax(gloo, codec):
    """Two steps from JAX's params on JAX's batches against JAX's
    ``make_manual_dp_train_step`` on a one-device mesh: the loss within
    ``LOSS_RTOL``; params, master, m, v and the error feedback by
    ``_close_state``, with ``_close_dp_state``'s rounding decisions."""
    cfg = jax_get_arch("qwen2.5-3b-smoke")
    jopt = jax_opt.OptConfig(**OPT)
    js = jax_steps.init_train_state(cfg, jopt, jax.random.PRNGKey(0))
    js["opt"]["ef"] = jax_gc.init_error_feedback(js["params"])
    ps = train_state_from_jax(jax.device_get(js), device="cpu")
    jstep = jax.jit(jax_steps.make_manual_dp_train_step(
        cfg, jopt, jax.make_mesh((1,), ("data",)), codec))
    pstep = steps.make_manual_dp_train_step(get_arch(cfg.name),
                                            OptConfig(**OPT), gloo, codec)
    unsettled, flips = {}, {}
    for step in range(2):
        tokens = _jax_batch(cfg, step)
        js, jloss = jstep(js, {"tokens": jnp.asarray(tokens)})
        ps, ploss = pstep(ps, {"tokens": torch.tensor(tokens)})
        np.testing.assert_allclose(float(ploss), float(jloss),
                                   rtol=LOSS_RTOL)
        _close_dp_state(ps, js, step + 1, unsettled, flips)


def test_manual_dp_without_codec_is_the_train_step_bitwise(gloo):
    cfg = get_arch("qwen2.5-3b-smoke")
    opt = OptConfig(**OPT)
    a = steps.init_train_state(cfg, opt, 0, device="cpu")
    b = steps.init_train_state(cfg, opt, 0, device="cpu")
    a["opt"]["ef"] = GC.init_error_feedback(a["params"])
    dp = steps.make_manual_dp_train_step(cfg, opt, gloo, "none")
    plain = steps.make_train_step(cfg, opt)
    stream = TokenStream(TokenStreamSpec(cfg.vocab_size, 9, 2))
    for s in range(2):
        batch = train.make_batch(stream, s, CPU)
        a, la = dp(a, batch)
        b, lb = plain(b, batch)
        _same(la, lb)
    ef = a["opt"].pop("ef")
    _same_trees(a, b)
    assert not any(bool(t.any()) for t in tree_leaves(ef))


# ---------------------------------------------------------------------------
# the two training CLIs
# ---------------------------------------------------------------------------

class _JaxStream:
    """The JAX package's token stream behind the port's interface, so the
    port's CLI trains on JAX's batches."""

    def __init__(self, spec):
        self.spec = spec
        self._ref = jax_data.TokenStream(jax_data.TokenStreamSpec(
            spec.vocab_size, spec.seq_len, spec.batch_size, spec.seed))

    def batch(self, step):
        return tuple(torch.from_numpy(np.asarray(x, np.int64))
                     for x in self._ref.batch(step))


def test_port_cli_resumes_a_jax_run(tmp_path, monkeypatch):
    """JAX's CLI writes steps 3 and 6; the port's CLI resumes from a copy
    holding only step 3, runs steps 4-6 on JAX's batches and writes a
    step 6 that matches JAX's under ``_close_state``'s rule."""
    argv = ["--arch", "qwen2.5-3b-smoke", "--steps", "6", "--batch", "2",
            "--seq", "9", "--ckpt-every", "3", "--log-every", "1"]
    with redirect_stdout(io.StringIO()):
        assert jax_train.main(argv + ["--ckpt-dir", str(tmp_path / "jax")]) \
            == 0
    jck = jax_ckpt.Checkpointer(tmp_path / "jax")
    assert jck.all_steps() == [3, 6]
    shutil.copytree(tmp_path / "jax" / "step_3", tmp_path / "port" / "step_3")
    monkeypatch.setattr(train, "TokenStream", _JaxStream)
    out = io.StringIO()
    with redirect_stdout(out):
        assert train.main(argv + ["--ckpt-dir", str(tmp_path / "port"),
                                  "--resume", "--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert "resumed from step 3" in lines
    assert [int(x.split(":")[0].split()[1]) for x in lines
            if x.startswith("step ")] == [4, 5, 6]
    assert lines[-1] == "done at step 6"
    pck = Checkpointer(tmp_path / "port")
    assert pck.all_steps() == [3, 6]
    assert pck.manifest(6)["data_position"] == 6
    cfg = jax_get_arch("qwen2.5-3b-smoke")
    opt = jax_opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=6)
    js = jck.restore(6, jax_steps.init_train_state(cfg, opt,
                                                   jax.random.PRNGKey(0)))
    ps = pck.restore(6, steps.init_train_state(
        get_arch(cfg.name), OptConfig(**OPT), 0, device="cpu"))
    _close_state(ps, js, 6, {})
