"""Prefix sharing in the port against the JAX package, on the CPU.

The four pager functions of sharing (``share_prefix``, ``cow_on_write``,
``copy_page_prefix``, ``copy_page_scale``) leave the same allocator
states, block tables and real pages as JAX's over seeded walks (the
port's trailing sentinel aside, ``[:n_pages]``), and keep the
conservation law at every step.  A snapshot capture and restore round
trip gives JAX's slot tables, refcounts and states.  The port's engine
serves the JAX engine's token streams and sharing statistics
(``shared_prompt_tokens``, ``cow_pages``, ``kv_pages_peak``,
``snap_slots_peak``) for the four families (moe with ``capacity_factor``
at its expert count, as ``tests/test_prefix_sharing.py``) x chunk {1, 4}
and the int8 pool, with sharing off giving the same tokens; and JAX's
scenarios: CoW divergence, a donor that completes first, release and
readmit cycles that conserve pages, slots and refcounts at every cycle,
and sampled streams that sharing does not change."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving import pager as jpager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    ServingEngine,
    pager,
)

from test_torch_pager import _check_partition  # noqa: E402
from torch_parity import jax_params  # noqa: E402


def _t(x, dtype=torch.int32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _same_state(ps, bt, jps, jbt) -> None:
    n = jps.free.shape[0]
    assert int(ps.top) == int(jps.top)
    np.testing.assert_array_equal(ps.free[:n].numpy(), np.asarray(jps.free))
    np.testing.assert_array_equal(ps.rc[:n].numpy(), np.asarray(jps.rc))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jbt))


def _walk(seed: int) -> int:
    """A seeded walk, JAX and the port side by side; returns how many rows
    moved by copy-on-write.  kind 0: alloc at the masked rows' positions;
    1: release them; 2: admit them (release, map a donor's first blocks,
    place each at their end or, as a fully shared prompt re-feeds its
    last token, one slot before it) and write there, copy-on-write
    first, as the engine's next step does; 3: copy-on-write at the
    masked rows' positions.  Each CoW also moves random pools' pages and
    scales."""
    rng = np.random.default_rng(seed)
    n_pages = int(rng.integers(4, 13))
    batch = int(rng.integers(2, 5))
    max_blocks = int(rng.integers(2, 5))
    page = int(rng.integers(1, 5))
    stacks, hkv, hd = 2, 2, 3
    dev = torch.device("cpu")
    st = {"ps": pager.init_pager(n_pages, dev),
          "bt": pager.init_block_table(batch, max_blocks, dev),
          "jps": jpager.init_pager(n_pages),
          "jbt": jpager.init_block_table(batch, max_blocks),
          "pool": rng.standard_normal((stacks, n_pages, page, hkv,
                                       hd)).astype(np.float32),
          "scale": rng.random((stacks, n_pages, hkv)).astype(np.float32),
          "moved": 0}
    tpool = torch.from_numpy(np.concatenate([st["pool"],
                                             st["pool"][:, :1]], 1))
    tscale = torch.from_numpy(np.concatenate([st["scale"],
                                              st["scale"][:, :1]], 1))
    pos = np.zeros((batch,), np.int32)

    def cow(mask):
        ps, bt, src, dst, lim, mv = pager.cow_on_write(
            st["ps"], st["bt"], _t(pos), _t(mask, torch.bool),
            page_size=page)
        jps, jbt, jsrc, jdst, jlim, jmv = jpager.cow_on_write(
            st["jps"], st["jbt"], jnp.asarray(pos), jnp.asarray(mask),
            page_size=page)
        np.testing.assert_array_equal(mv.numpy(), np.asarray(jmv))
        np.testing.assert_array_equal(lim.numpy(), np.asarray(jlim))
        for a, b in ((src, jsrc), (dst, jdst)):     # sentinel = n_pages
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        pager.copy_page_prefix(tpool, src, dst, lim)
        st["pool"] = np.asarray(jpager.copy_page_prefix(
            jnp.asarray(st["pool"]), jsrc, jdst, jlim))
        pager.copy_page_scale(tscale, src, dst)
        st["scale"] = np.asarray(jpager.copy_page_scale(
            jnp.asarray(st["scale"]), jsrc, jdst))
        np.testing.assert_array_equal(tpool[:, :n_pages].numpy(),
                                      st["pool"])
        np.testing.assert_array_equal(tscale[:, :n_pages].numpy(),
                                      st["scale"])
        st.update(ps=ps, bt=bt, jps=jps, jbt=jbt)
        st["moved"] += int(mv.sum())

    for _ in range(int(rng.integers(20, 40))):
        kind = int(rng.choice([0, 0, 0, 1, 2, 2, 3]))
        mask = rng.random(batch) < 0.5
        tm, jm = _t(mask, torch.bool), jnp.asarray(mask)
        ps, bt, jps, jbt = st["ps"], st["bt"], st["jps"], st["jbt"]
        if kind == 0:
            ps, bt = pager.alloc_on_write(ps, bt, _t(pos), tm,
                                          page_size=page)
            jps, jbt = jpager.alloc_on_write(jps, jbt, jnp.asarray(pos), jm,
                                             page_size=page)
            pos[mask] = np.minimum(pos[mask] + 1, max_blocks * page - 1)
        elif kind == 1:
            ps, bt = pager.release_rows(ps, bt, tm)
            jps, jbt = jpager.release_rows(jps, jbt, jm)
            pos[mask] = 0
        elif kind == 2:
            donors = np.flatnonzero(~mask)
            if not len(donors):
                continue
            src = rng.choice(donors, batch).astype(np.int32)
            # up to the donor's mapped blocks, sometimes one past them
            mapped = (bt.numpy() >= 0).sum(1)[src]
            nblk = rng.integers(0, mapped + 2).astype(np.int32)
            ps, bt = pager.release_rows(ps, bt, tm)
            jps, jbt = jpager.release_rows(jps, jbt, jm)
            ps, bt = pager.share_prefix(ps, bt, _t(src), _t(nblk), tm)
            jps, jbt = jpager.share_prefix(jps, jbt, jnp.asarray(src),
                                           jnp.asarray(nblk), jm)
            start = np.maximum(nblk * page - (rng.random(batch) < 0.7), 0)
            pos[mask] = np.minimum(start, max_blocks * page - 1)[mask]
        st.update(ps=ps, bt=bt, jps=jps, jbt=jbt)
        if kind in (2, 3):
            cow(mask)
        _check_partition(st["ps"], st["bt"])
        _same_state(st["ps"], st["bt"], st["jps"], st["jbt"])
    return st["moved"]


@pytest.mark.parametrize("seed", range(10))
def test_sharing_pager_walks_match_jax(seed):
    _walk(seed)


def test_cow_on_write_frees_a_page_every_holder_left():
    """Two rows holding one shared page (rc 2) both copy-on-write in one
    call: each takes a fresh page and the shared one, its refcount at 0,
    goes back on the stack, as in JAX."""
    dev = torch.device("cpu")
    ps = pager.init_pager(4, dev)
    ps = ps._replace(top=torch.tensor(3, dtype=torch.int32),
                     rc=_t([0, 0, 0, 2, 0]))
    bt = _t([[3, -1], [3, -1]])
    jps = jpager.PagerState(jnp.arange(4, dtype=jnp.int32),
                            jnp.asarray(3, jnp.int32),
                            jnp.asarray([0, 0, 0, 2], jnp.int32))
    ps, bt2, src, dst, lim, mv = pager.cow_on_write(ps, bt, _t([2, 1]),
                                                    page_size=4)
    jps, jbt2, *_ = jpager.cow_on_write(jps, jnp.asarray(bt.numpy()),
                                        jnp.asarray([2, 1]), page_size=4)
    _same_state(ps, bt2, jps, jbt2)
    assert mv.tolist() == [True, True] and src.tolist() == [3, 3]
    assert int(ps.top) == 2 and 3 in ps.free[:2].tolist()


def test_snapshot_capture_restore_roundtrip_matches_jax():
    """Decode steps ending at page boundaries capture the post-step state
    (slots, tables, refcounts and free lists exactly JAX's, the states
    within 1e-5); a sharer restored from the donor's two boundaries holds
    bit for bit the donor's snapshot, refcounted like pages through both
    releases."""
    arch, page = "mamba2-2.7b-smoke", 4
    jcfg, tree, jparams = jax_params(arch=arch)
    cfg = get_arch(arch)
    params = params_from_jax(tree, device="cpu")
    state = lm.init_decode_state(cfg, 2, 16, per_row_pos=True,
                                 layout="paged", page_size=page,
                                 snapshots=True, device="cpu")
    jstate = jax_lm.init_decode_state(jcfg, 2, 16, per_row_pos=True,
                                      layout="paged", page_size=page,
                                      snapshots=True)
    n_slots = jstate["snap_free"].shape[0]
    assert state["snap_ssm"].shape[0] == n_slots + 1
    active = np.array([True, False])
    snap_at = {}

    def same(keys=("snap_table", "snap_top")):
        for k in keys:
            np.testing.assert_array_equal(state[k].numpy(),
                                          np.asarray(jstate[k]))
        np.testing.assert_array_equal(state["snap_rc"][:n_slots].numpy(),
                                      np.asarray(jstate["snap_rc"]))
        top = int(state["snap_top"])
        np.testing.assert_array_equal(state["snap_free"][:top].numpy(),
                                      np.asarray(jstate["snap_free"])[:top])

    for t in range(1, 11):            # 10 tokens: boundaries 4 and 8
        tok = np.array([t, 0], np.int32)
        _, state = lm.decode_step(cfg, params, state, _t(tok),
                                  active=_t(active, torch.bool),
                                  snap_every=page)
        _, jstate = jax_lm.decode_step(jcfg, jparams, jstate,
                                       jnp.asarray(tok),
                                       active=jnp.asarray(active),
                                       snap_every=page)
        same()
        if int(state["pos"][0]) % page == 0:
            snap_at[int(state["pos"][0])] = state["ssm"][:, 0].clone()
    assert sorted(snap_at) == [4, 8]
    np.testing.assert_allclose(state["snap_ssm"][:n_slots].numpy(),
                               np.asarray(jstate["snap_ssm"]), atol=1e-5)
    state = lm.restore_snapshots(state, _t([False, True], torch.bool),
                                 _t([0, 0]), _t([0, 2]))
    jstate = jax_lm.restore_snapshots(jstate, jnp.asarray([False, True]),
                                      jnp.zeros((2,), jnp.int32),
                                      jnp.asarray([0, 2], jnp.int32))
    same()
    assert torch.equal(state["ssm"][:, 1], snap_at[8])
    np.testing.assert_allclose(state["ssm"].numpy(),
                               np.asarray(jstate["ssm"]), atol=1e-5)
    tbl = state["snap_table"].numpy()
    np.testing.assert_array_equal(tbl[1, :2], tbl[0, :2])
    for row in ([True, False], [False, True]):
        state = lm.reset_decode_rows(cfg, state, _t(row, torch.bool))
        jstate = jax_lm.reset_decode_rows(jcfg, jstate, jnp.asarray(row))
        same()
    assert int(state["snap_top"]) == n_slots
    assert (state["snap_rc"][:n_slots] == 0).all()


def _cfgs(arch):
    jcfg, pcfg = jax_get_arch(arch), get_arch(arch)
    if jcfg.n_experts:
        # sharing changes which tokens batch into a routing step
        jcfg = dataclasses.replace(jcfg,
                                   capacity_factor=float(jcfg.n_experts))
        pcfg = dataclasses.replace(pcfg,
                                   capacity_factor=float(pcfg.n_experts))
    return jcfg, pcfg


def _shared_requests(vocab, seed=5):
    """A long-lived donor plus sharers: a divergent tail, a fully shared
    prompt (the CoW case) and a longer tail, as JAX's test."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=8).tolist()
    return (prefix + [7, 9], 14), [(prefix + [3], 3), (list(prefix), 3),
                                   (prefix + [5, 1, 2], 4)]


def _staged(eng, donor, rest, warm=5):
    """The donor alone for ``warm`` cycles, so its prompt pages are
    written, then the rest."""
    rid0 = eng.submit(*donor)
    for _ in range(warm):
        eng.step()
    rids = [rid0] + [eng.submit(t, g) for t, g in rest]
    outs = eng.run()
    return [np.asarray(outs[r]).tolist() for r in rids]


def _pair(arch, *, batch=4, max_len=26, kv_dtype="f32", **kw):
    """(JAX engine, port engine, port engine without sharing) over the
    same params: paged, page 4, ``steps_per_sync`` 2."""
    jcfg, pcfg = _cfgs(arch)
    jcfg, tree, jparams = jax_params(cfg=jcfg)
    params = params_from_jax(tree, device="cpu")
    model = build_model(pcfg, device="cpu")

    def cfgs(cache_cls, cfg_cls, share):
        return dict(batch=batch, max_len=max_len,
                    cache=cache_cls(layout="paged", page_size=4,
                                    kv_dtype=kv_dtype),
                    config=cfg_cls(steps_per_sync=2, prefix_sharing=share,
                                   **kw))

    return (JaxServingEngine(jax_build_model(jcfg), jparams,
                             **cfgs(JaxCacheConfig, JaxEngineConfig, True)),
            ServingEngine(model, params, **cfgs(CacheConfig, EngineConfig,
                                                True)),
            ServingEngine(model, params, **cfgs(CacheConfig, EngineConfig,
                                                False)))


SHARE_STATS = ("shared_prompt_tokens", "cow_pages", "kv_pages_peak",
               "snap_slots_peak", "snap_slots", "prefill_steps",
               "decode_steps", "prompt_tokens", "generated_tokens")


def _drained(eng) -> None:
    """Every page and snapshot slot back on its free list."""
    ms = eng._mstate
    for pre, n in (("page", eng.n_pages), ("snap", eng.n_snap_slots)):
        if f"{pre}_top" in ms:
            assert int(ms[f"{pre}_top"]) == n
            assert (ms[f"{pre}_rc"][:n] == 0).all()
    for key in ("block_table", "snap_table"):
        if key in ms:
            assert (ms[key] == -1).all()


SHARE_CASES = ([(arch, chunk, "f32")
                for arch in ("qwen2.5-3b-smoke", "qwen3-moe-235b-a22b-smoke",
                             "mamba2-2.7b-smoke", "zamba2-2.7b-smoke")
                for chunk in (1, 4)]
               + [("qwen2.5-3b-smoke", 4, "int8"),
                  ("zamba2-2.7b-smoke", 4, "int8")])


@pytest.mark.parametrize("arch,chunk,kv_dtype", SHARE_CASES)
def test_sharing_matches_jax_engine(arch, chunk, kv_dtype):
    """Tokens and sharing statistics exactly JAX's; sharing engaged (a CoW
    for the fully shared attention prompt, none for the recurrent
    families), the same tokens as without sharing, and every page and
    slot back at drain."""
    jeng, eng, off = _pair(arch, kv_dtype=kv_dtype, prefill_chunk=chunk)
    donor, rest = _shared_requests(jeng.model.cfg.vocab_size)
    want = _staged(jeng, donor, rest)
    got = _staged(eng, donor, rest)
    assert got == want
    assert _staged(off, donor, rest) == got
    s, js = eng.stats(), jeng.stats()
    keys = [k for k in SHARE_STATS if k in js]
    assert {k: s[k] for k in keys} == {k: js[k] for k in keys}
    assert set(s) >= set(keys)
    assert s["shared_prompt_tokens"] > 0, "sharing never engaged"
    recurrent = eng.model.cfg.family in ("ssm", "hybrid")
    assert (s["cow_pages"] == 0) == recurrent
    if "kv_pages_peak" in s:
        assert s["kv_pages_peak"] < off.stats()["kv_pages_peak"]
    _drained(eng)


def test_cow_divergence_matches_jax():
    """Every sharer copies the donor's last page on write (a fully shared
    prompt, or a divergent token right past the pages): the donor keeps
    decoding from its own pages, and its fully shared twin agrees with
    it."""
    jeng, eng, off = _pair("qwen2.5-3b-smoke", prefill_chunk=4)
    prefix = np.random.default_rng(11).integers(
        0, eng.model.cfg.vocab_size, size=8).tolist()
    donor = (list(prefix), 14)
    rest = [(list(prefix), 4), (prefix + [1], 4), (prefix + [2, 3], 4)]
    got = _staged(eng, donor, rest)
    assert got == _staged(jeng, donor, rest) == _staged(off, donor, rest)
    assert eng.cow_pages == jeng.cow_pages >= 1
    assert got[0][:4] == got[1]
    _drained(eng)


def test_donor_completing_first_matches_jax():
    """A short-lived donor finishes; the long-lived sharer inherits its
    index entries, so a later request still matches (8, then 16 shared
    tokens), as in JAX."""
    jeng, eng, _ = _pair("qwen2.5-3b-smoke", batch=2, max_len=50,
                         prefill_chunk=4)
    prefix = np.random.default_rng(23).integers(
        0, eng.model.cfg.vocab_size, size=8).tolist()
    shared = {}
    for e in (jeng, eng):
        rid_a = e.submit(prefix + [1], 4)
        e.step()
        e.submit(prefix + [2], 40)
        while rid_a not in e.outputs:
            e.step()
        first = e.shared_prompt_tokens
        rid_c = e.submit(prefix + [3], 2)
        while rid_c not in e.outputs:
            e.step()
        shared[e is eng] = (first, e.shared_prompt_tokens,
                            [np.asarray(o).tolist()
                             for _, o in sorted(e.run().items())])
    assert shared[True] == shared[False]
    assert shared[True][:2] == (8, 16)
    _drained(eng)


def _check_pools(eng) -> None:
    ms = eng._mstate
    if eng._paged:
        _check_partition(pager.PagerState(ms["page_free"], ms["page_top"],
                                          ms["page_rc"]),
                         ms["block_table"])
    if eng._snap:
        _check_partition(pager.PagerState(ms["snap_free"], ms["snap_top"],
                                          ms["snap_rc"]),
                         ms["snap_table"])


@pytest.mark.parametrize("arch", ["qwen2.5-3b-smoke", "zamba2-2.7b-smoke"])
def test_release_readmit_cycles_conserve_and_match(arch):
    """More requests than rows, sharable and unrelated prompts: donors
    leave, rows are refilled and later prompts match later donors.  The
    page and snapshot pools keep the conservation law after every cycle;
    tokens and statistics are JAX's; everything returns at drain."""
    jeng, eng, _ = _pair(arch, prefill_chunk=4)
    rng = np.random.default_rng(13)
    vocab = eng.model.cfg.vocab_size
    prefix = rng.integers(0, vocab, size=8).tolist()
    reqs = [(prefix + [6], 14)]
    for i in range(7):
        if i % 3 == 2:        # unrelated prompt: never matches
            reqs.append((rng.integers(0, vocab, size=6).tolist(), 3))
        else:
            reqs.append((prefix + rng.integers(0, vocab,
                                               size=i % 3).tolist(), 3))
    outs = {}
    for e in (jeng, eng):
        rids = [e.submit(*reqs[0])]
        for _ in range(5):
            e.step()
            if e is eng:
                _check_pools(eng)
        rids += [e.submit(t, g) for t, g in reqs[1:]]
        while e.queue or any(r is not None for r in e._slot_req):
            e.step()
            if e is eng:
                _check_pools(eng)
        outs[e is eng] = [np.asarray(e.outputs[r]).tolist() for r in rids]
    assert outs[True] == outs[False]
    s, js = eng.stats(), jeng.stats()
    keys = [k for k in SHARE_STATS if k in js]
    assert {k: s[k] for k in keys} == {k: js[k] for k in keys}
    assert s["shared_prompt_tokens"] > 0
    _drained(eng)


@pytest.mark.parametrize("arch", ["qwen2.5-3b-smoke", "mamba2-2.7b-smoke"])
def test_sampled_streams_with_sharing_match_jax(arch):
    """Keys are (row key, position), so skipping prefill positions by
    sharing changes no sampled token: JAX's streams, and the port's
    without sharing."""
    kw = dict(prefill_chunk=4, temperature=1.0, top_k=8, seed=1)
    jeng, eng, off = _pair(arch, **kw)
    donor, rest = _shared_requests(eng.model.cfg.vocab_size)
    got = _staged(eng, donor, rest)
    assert got == _staged(jeng, donor, rest) == _staged(off, donor, rest)
    assert eng.shared_prompt_tokens > 0


def test_sharing_requires_paged_layout():
    """The JAX message, from ``validate_configs``."""
    _, tree, _ = jax_params()
    model = build_model(get_arch("qwen2.5-3b-smoke"), device="cpu")
    with pytest.raises(ValueError, match="prefix sharing needs "
                                         "layout='paged'"):
        ServingEngine(model, params_from_jax(tree, device="cpu"), batch=2,
                      max_len=16, config=EngineConfig(prefix_sharing=True))
