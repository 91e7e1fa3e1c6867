"""The port's recurrent families on the CPU against the JAX package: the
SSD scan (plain version) against ``repro.kernels.ref.ssd_scan`` and
``ssd_scan_pallas`` in interpret mode, the Mamba-2 blocks, the ssm and
hybrid LMs' decode, chunked prefill and row reset, and the serving engine
on mamba2-2.7b-smoke and zamba2-2.7b-smoke.  Inputs are made from seeds
with numpy; both sides compute in IEEE f32, so they are held to 1e-5
(summation order only) unless a test says otherwise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.core.policy import use_backend as jax_use_backend  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.mamba_scan import ssd_scan_pallas  # noqa: E402
from repro.models import components as jax_C  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.mamba_scan import ssd_scan  # noqa: E402
from repro_torch.models import components as C  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    ServingEngine,
)

from torch_parity import jax_params, requests  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
# the Pallas kernel in interpret mode against the oracle: JAX's own
# tolerance (tests/test_kernels.py:test_ssd_scan)
PALLAS_TOL = dict(atol=2e-4, rtol=2e-4)
RECURRENT = ["mamba2-2.7b-smoke", "zamba2-2.7b-smoke"]


def _ssd_inputs(b, s, h, p, n, seed, state=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal((h,))).astype(np.float32)
    bm = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)).astype(np.float32)
          if state else None)
    return x, dt, a, bm, cm, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 32, 4, 8, 16, 8), (1, 37, 3, 16, 32, 16), (2, 64, 2, 8, 8, 64)])
def test_ssd_scan_matches_jax(b, s, h, p, n, chunk, carried):
    """The shapes of tests/test_kernels.py:test_ssd_scan (37 is ragged),
    from a zero or a carried state: y and the final state against the
    oracle (1e-5) and the Pallas kernel in interpret mode (2e-4)."""
    ins = _ssd_inputs(b, s, h, p, n, seed=s + h, state=carried)
    y, fin = ssd_scan(*map(_t, ins[:5]), chunk=chunk,
                      initial_state=_t(ins[5]))
    jy, jfin = jax_ref.ssd_scan(*map(_j, ins[:5]), chunk=chunk,
                                initial_state=_j(ins[5]))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), **TOL)
    py, pfin = ssd_scan_pallas(*map(_j, ins[:5]), chunk=chunk,
                               initial_state=_j(ins[5]), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **PALLAS_TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(pfin), **PALLAS_TOL)
    assert fin.dtype == torch.float32 and y.dtype == torch.float32


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("c", [1, 5, 16])
def test_ssd_prefill_chunk_matches_jax(c, backend):
    """The serving scan (chunk widths <= 16, where both sides resolve the
    same SSD chunk) against ``repro.kernels.ops.ssd_prefill_chunk`` under
    each JAX backend; row 1's chunk is half padding (dt = 0)."""
    x, dt, a, bm, cm, h0 = _ssd_inputs(3, c, 4, 8, 16, seed=c, state=True)
    dt[1, c // 2 + 1:] = 0.0
    y, fin = ops.ssd_prefill_chunk(*map(_t, (x, dt, a, bm, cm, h0)),
                                   chunk=16)
    with jax_use_backend(backend):
        jy, jfin = jax_ops.ssd_prefill_chunk(*map(_j, (x, dt, a, bm, cm,
                                                       h0)), chunk=16)
    tol = TOL if backend == "reference" else PALLAS_TOL
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), **tol)


@pytest.mark.parametrize("op", ["ssd_scan", "ssd_prefill_chunk"])
def test_ssd_grouped_bc_matches_jax(op):
    """Two state groups over four heads take the plain version on the CPU
    through the ops layer (the kernel raises on them on the card): y and
    the final state against JAX's oracle, from a carried state for the
    serving scan."""
    rng = np.random.default_rng(31)
    x, dt, a, _, _, h0 = _ssd_inputs(2, 12, 4, 8, 16, seed=31, state=True)
    bm, cm = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
              for _ in range(2))
    if op == "ssd_scan":
        y = ops.ssd_scan(*map(_t, (x, dt, a, bm, cm)), chunk=4)
        jy = jax_ops.ssd_scan(*map(_j, (x, dt, a, bm, cm)), chunk=4)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        return
    y, fin = ops.ssd_prefill_chunk(*map(_t, (x, dt, a, bm, cm, h0)),
                                   chunk=4)
    jy, jfin = jax_ref.ssd_scan(*map(_j, (x, dt, a, bm, cm)), chunk=4,
                                initial_state=_j(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), **TOL)


def test_ssd_prefill_chunk_writes_out_in_place():
    """``out`` receives the new state, also when it is the carried state
    itself (as the LMs pass it): bit for bit the state and y of the call
    that returns a new tensor."""
    x, dt, a, bm, cm, h0 = _ssd_inputs(3, 5, 4, 8, 16, seed=33, state=True)
    args = tuple(map(_t, (x, dt, a, bm, cm)))
    y, fin = ops.ssd_prefill_chunk(*args, _t(h0.copy()), chunk=16)
    state = _t(h0.copy())
    y1, fin1 = ops.ssd_prefill_chunk(*args, state, chunk=16, out=state)
    assert fin1 is state
    assert torch.equal(fin1, fin) and torch.equal(y1, y)


def test_dt_zero_is_an_exact_state_noop():
    """A row whose dt is 0 everywhere keeps its carried state bit for bit
    (decode C = 1 and a chunk of 16 alike), and dt = 0 positions inside a
    row change nothing: the scan equals the scan without them."""
    for c in (1, 16):
        x, dt, a, bm, cm, h0 = _ssd_inputs(3, c, 4, 8, 16, seed=40 + c,
                                           state=True)
        dt[2] = 0.0
        _, fin = ops.ssd_prefill_chunk(*map(_t, (x, dt, a, bm, cm, h0)),
                                       chunk=16)
        assert torch.equal(fin[2], torch.from_numpy(h0[2]))
        _, jfin = jax_ref.ssd_scan(*map(_j, (x, dt, a, bm, cm)), chunk=16,
                                   initial_state=_j(h0))
        assert np.array_equal(np.asarray(jfin)[2], h0[2])
    x, dt, a, bm, cm, h0 = _ssd_inputs(1, 12, 2, 4, 8, seed=3, state=True)
    keep = np.array([i % 3 != 1 for i in range(12)])
    dt[:, ~keep] = 0.0
    _, fin = ssd_scan(*map(_t, (x, dt, a, bm, cm)), chunk=4,
                      initial_state=_t(h0))
    _, fin_k = ssd_scan(*(_t(np.ascontiguousarray(v[:, keep]))
                          for v in (x, dt)), _t(a),
                        *(_t(np.ascontiguousarray(v[:, keep]))
                          for v in (bm, cm)), chunk=4, initial_state=_t(h0))
    np.testing.assert_allclose(fin.numpy(), fin_k.numpy(), **TOL)


def test_ssd_scan_matches_sequential_decode():
    """The chunked scan against a loop of the one-token recurrence, from a
    carried state (JAX's tolerance for the same check)."""
    x, dt, a, bm, cm, h0 = _ssd_inputs(2, 12, 2, 4, 8, seed=9, state=True)
    y, fin = ssd_scan(*map(_t, (x, dt, a, bm, cm)), chunk=4,
                      initial_state=_t(h0))
    state, ys = _t(h0), []
    for t in range(12):
        yt, state = ref.ssd_decode_step(
            _t(x[:, t]), _t(dt[:, t]), _t(a), _t(bm[:, t]), _t(cm[:, t]),
            state)
        ys.append(yt)
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               **PALLAS_TOL)
    np.testing.assert_allclose(fin.numpy(), state.numpy(), **PALLAS_TOL)


def _layer0(arch):
    """(JAX cfg, JAX params, port params) of the first Mamba layer."""
    jcfg, tree, jparams = jax_params(arch=arch)
    params = params_from_jax(tree, device="cpu")
    if "groups" in tree:
        return (jcfg, {k: v[0, 0] for k, v in
                       jparams["groups"]["mamba"].items()},
                params["groups"][0][0]["mamba"])
    return (jcfg, {k: v[0] for k, v in jparams["layers"]["mamba"].items()},
            params["layers"][0]["mamba"])


@pytest.mark.parametrize("arch", RECURRENT)
def test_mamba_blocks_match_jax(arch):
    """``mamba_block`` over 20 tokens (crossing the smoke chunk of 16),
    then ``mamba_prefill_block`` with per-row widths (row 2 has no real
    token) and ``mamba_decode_block`` with row 0 inactive, against JAX's
    blocks and carried states; rows that do not run keep theirs bit for
    bit."""
    jcfg, jp, p = _layer0(arch)
    cfg = get_arch(arch)
    rng = np.random.default_rng(21)
    b, d = 3, cfg.d_model
    x = rng.standard_normal((b, 20, d)).astype(np.float32)
    got = C.mamba_block(cfg, p, _t(x))
    want = jax.jit(jax_C.mamba_block, static_argnums=0)(jcfg, jp, _j(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    h, hd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    s0 = rng.standard_normal((b, h, hd, n)).astype(np.float32)
    c0 = rng.standard_normal((b, cfg.ssm_conv - 1, cfg.d_inner)).astype(
        np.float32)
    valid = np.array([[True] * 5, [True] * 2 + [False] * 3, [False] * 5])
    xc = x[:, :5]
    y, s1, c1 = C.mamba_prefill_block(cfg, p, _t(xc), _t(s0), _t(c0),
                                      _t(valid))
    jy, js1, jc1 = jax.jit(jax_C.mamba_prefill_block, static_argnums=0)(
        jcfg, jp, _j(xc), _j(s0), _j(c0), _j(valid))
    for a_, b_ in ((y, jy), (s1, js1), (c1, jc1)):
        np.testing.assert_allclose(a_.numpy(), np.asarray(b_), **TOL)
    assert torch.equal(s1[2], _t(s0)[2]) and torch.equal(c1[2], _t(c0)[2])

    live = np.array([[False], [True], [True]])
    y, s2, c2 = C.mamba_decode_block(cfg, p, _t(x[:, 7]), s1, c1,
                                     valid=_t(live))
    jy, js2, jc2 = jax.jit(jax_C.mamba_decode_block, static_argnums=0)(
        jcfg, jp, _j(x[:, 7]), js1, jc1, valid=_j(live))
    for a_, b_ in ((y, jy), (s2, js2), (c2, jc2)):
        np.testing.assert_allclose(a_.numpy(), np.asarray(b_), **TOL)
    assert torch.equal(s2[0], s1[0]) and torch.equal(c2[0], c1[0])


def _close(got, want, what):
    """max |got - want| <= 1e-5 of max(1, max |want|): through several
    layers the two sides sum in different orders, and the raw in_proj
    outputs the conv state keeps reach |3|, so the bound scales with the
    largest value (measured: at most 5e-6 of it)."""
    want = np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), (what, err)


def _same_states(state, jstate, keys):
    for key in keys:
        want = np.asarray(jstate[key])
        got = state[key].numpy()
        if key in ("kp", "vp"):      # the port's pool has a sentinel page
            got = got[:, : want.shape[1]]
        _close(got, want, key)


@pytest.mark.parametrize("arch,layout", [
    ("mamba2-2.7b-smoke", "contiguous"), ("mamba2-2.7b-smoke", "paged"),
    ("zamba2-2.7b-smoke", "contiguous"), ("zamba2-2.7b-smoke", "paged")])
def test_prefill_decode_and_reset_match_jax(arch, layout):
    """Two chunked-prefill steps of width (4, 2, 3) and (4, 1, 4) with row
    1 inactive in the second, five decode steps with row 2 inactive in two
    of them, then a reset of row 0 and two more steps: logits, positions
    and every recurrent and KV state against JAX's at each step (within
    1e-5 of their scale, ``_close``).  Inactive
    rows keep their ssm/conv states bit for bit; the attention-free
    family has no pages under either layout."""
    jcfg, tree, jparams = jax_params(arch=arch, seed=2)
    cfg = get_arch(arch)
    params = params_from_jax(tree, device="cpu")
    b, max_len = 3, 24
    kw = dict(per_row_pos=True, layout=layout, page_size=4)
    jstate = jax_lm.init_decode_state(jcfg, b, max_len, **kw)
    state = lm.init_decode_state(cfg, b, max_len, device="cpu", **kw)
    assert set(state) == set(jstate)
    if cfg.family == "ssm":
        assert "block_table" not in state
    keys = sorted(set(state) - {"pos", "block_table", "page_free",
                                "page_top", "page_rc"})
    rng = np.random.default_rng(8)

    def both(fn_j, fn_t, *args, active):
        nonlocal state, jstate
        before = {k: state[k].clone() for k in ("ssm", "conv")}
        jl, jstate = fn_j(jcfg, jparams, jstate,
                          *map(jnp.asarray, args), active=jnp.asarray(active))
        tl, state = fn_t(cfg, params, state, *map(torch.from_numpy, args),
                         active=torch.from_numpy(active))
        _close(tl.numpy(), jl, "logits")
        np.testing.assert_array_equal(state["pos"].numpy(),
                                      np.asarray(jstate["pos"]))
        _same_states(state, jstate, keys)
        for row in np.flatnonzero(~active):
            for k in ("ssm", "conv"):
                assert torch.equal(state[k][:, row], before[k][:, row])

    jprefill = jax.jit(jax_lm.prefill_chunk, static_argnums=0)
    jdecode = jax.jit(jax_lm.decode_step, static_argnums=0)
    for widths, active in (([4, 2, 3], [True, True, True]),
                           ([4, 1, 4], [True, False, True])):
        toks = rng.integers(0, cfg.vocab_size, (b, 4)).astype(np.int32)
        both(jprefill, lm.prefill_chunk, toks,
             np.array(widths, np.int32), active=np.array(active))
    for step in range(5):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        both(jdecode, lm.decode_step, tok,
             active=np.array([True, True, step not in (1, 3)]))
    mask = np.array([True, False, False])
    jstate = jax_lm.reset_decode_rows(jcfg, jstate, jnp.asarray(mask))
    state = lm.reset_decode_rows(cfg, state, torch.from_numpy(mask))
    assert not state["ssm"][:, 0].any() and not state["conv"][:, 0].any()
    _same_states(state, jstate, keys)
    for _ in range(2):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        both(jdecode, lm.decode_step, tok,
             active=np.ones((b,), bool))


def test_reset_guards_unknown_keys():
    cfg = get_arch("mamba2-2.7b-smoke")
    state = lm.init_decode_state(cfg, 2, 8, per_row_pos=True, device="cpu")
    with pytest.raises(ValueError, match="unhandled decode-state keys"):
        lm.reset_decode_rows(cfg, {**state, "snap_ssm": state["ssm"]},
                             torch.tensor([True, False]))


@pytest.mark.parametrize("arch", ["mamba2-2.7b-smoke", "zamba2-2.7b-smoke"])
def test_params_from_jax_recurrent_trees_bit_for_bit(arch):
    """ssm trees (layers stacked on one axis) and hybrid trees (groups on
    two, shared blocks unstacked), in f32 and through the bf16 route:
    every leaf of the port's params equals the JAX leaf bit for bit."""
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jax_get_arch(arch), dtype=dtype)
        _, tree, _ = jax_params(cfg=jcfg)
        params = params_from_jax(tree, device="cpu")

        def bits(a):
            a = np.ascontiguousarray(a)
            return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(
                np.int32)

        def same(t, a, path):
            assert t.dtype == {"bfloat16": torch.bfloat16,
                               "float32": torch.float32}[np.asarray(
                                   a).dtype.name], path
            assert np.array_equal(t.view({2: torch.int16, 4: torch.int32}[
                t.element_size()]).numpy(), bits(a)), path

        def walk(port, jt, path, index):
            if isinstance(jt, dict):
                assert set(port) == set(jt), path
                for k in jt:
                    walk(port[k], jt[k], f"{path}/{k}", index)
            else:
                same(port, np.asarray(jt)[index], path)

        for k in ("embed", "ln_f", "lm_head"):
            if k in tree:
                same(params[k], tree[k], k)
        if "layers" in tree:
            assert len(params["layers"]) == jcfg.n_layers
            for i, layer in enumerate(params["layers"]):
                walk(layer, tree["layers"], f"layers[{i}]", (i,))
        else:
            g, a = jcfg.n_layers // jcfg.attn_every, jcfg.attn_every
            assert [len(grp) for grp in params["groups"]] == [a] * g
            for i in range(g):
                for j in range(a):
                    walk(params["groups"][i][j], tree["groups"],
                         f"groups[{i}][{j}]", (i, j))
            for k in ("shared_attn", "shared_mlp"):
                walk(params[k], tree[k], k, ())


# (layout, prefill_chunk): the engine against the JAX engine
ENGINE_CASES = [(layout, chunk) for layout in ("contiguous", "paged")
                for chunk in (1, 4)]
MAX_LEN = 24


@pytest.fixture(scope="module")
def engine_runs():
    """The JAX engine's outputs per (arch, layout, chunk)."""
    runs = {}
    for arch in RECURRENT:
        jcfg, tree, jparams = jax_params(arch=arch)
        reqs = requests(6, 2, 12, 3, 8, jcfg.vocab_size, seed=13)
        jmodel = jax_build_model(jcfg)
        for layout, chunk in ENGINE_CASES:
            jeng = JaxServingEngine(
                jmodel, jparams, batch=4, max_len=MAX_LEN,
                cache=JaxCacheConfig(layout=layout, page_size=4,
                                     host_spill=False),
                config=JaxEngineConfig(steps_per_sync=3,
                                       prefill_chunk=chunk))
            rids = [jeng.submit(t, g) for t, g in reqs]
            runs[arch, layout, chunk] = (tree, reqs, rids, jeng.run(),
                                         jeng.stats(),
                                         jeng.peak_pages_in_use)
    return runs


@pytest.mark.parametrize("layout,chunk", ENGINE_CASES)
@pytest.mark.parametrize("arch", RECURRENT)
def test_engine_matches_jax_engine(engine_runs, arch, layout, chunk):
    """Prompts of 2-12 tokens and 3-8 generated: identical token lists,
    prefill and decode step counts, prompt tokens and peak pages (0: the
    attention-free family has none under either layout)."""
    tree, reqs, jrids, want, jstats, jpeak = engine_runs[arch, layout,
                                                         chunk]
    model = build_model(get_arch(arch), device="cpu")
    eng = ServingEngine(model, params_from_jax(tree, device="cpu"), batch=4,
                        max_len=MAX_LEN,
                        cache=CacheConfig(layout=layout, page_size=4,
                                          host_spill=False),
                        config=EngineConfig(steps_per_sync=3,
                                            prefill_chunk=chunk))
    rids = [eng.submit(t, g) for t, g in reqs]
    got = eng.run()
    assert rids == list(jrids)
    for rid in rids:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    s = eng.stats()
    keys = ["prefill_steps", "decode_steps", "prompt_tokens",
            "generated_tokens"]
    assert {k: s[k] for k in keys} == {k: jstats[k] for k in keys}
    assert (s["prefill_steps"] > 0) == (chunk > 1)
    assert eng.peak_pages_in_use == jpeak
    assert (jpeak > 0) == (layout == "paged" and arch.startswith("zamba"))
    assert not eng.busy()
