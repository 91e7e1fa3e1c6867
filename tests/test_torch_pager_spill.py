"""The port's host tier on the CPU against the JAX package: the pager's
``spill_rows``, ``restore_rows`` and ``copy_pages``, the decode state's
host tier, the request queue's order, cancels and back-pressure, and the
fault plan's events.

``tests/test_pager.py``'s random walk (decode writes with copy-on-write,
releases of both tiers, prefix-sharing admissions, spills, restores gated
on the device pool's room) runs through both pagers in lockstep: after
every step each tier's free list, top, refcounts and table are equal on
the real entries (``[:n]``: the port's trailing entry is its sentinel),
the ``(src, dst)`` ids of every move are equal (both use ``n`` as the
sentinel), the pools that ``copy_pages`` moved are equal page for page,
and the port keeps the conservation law in both tiers.  A spilled row
that shares keeps its peer's pages resident, an int8 pool's scales ride
the same ids, and snapshot pools move along axis 0."""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as jax_get_arch  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serving import QueueFullError as JaxQueueFullError  # noqa: E402
from repro.serving import RequestQueue as JaxRequestQueue  # noqa: E402
from repro.serving import faults as jax_faults  # noqa: E402
from repro.serving import pager as jpager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    FaultEvent,
    FaultPlan,
    QueueEmpty,
    QueueFullError,
    Request,
    RequestQueue,
    pager,
)
from repro_torch.serving.config import configs_from_flags  # noqa: E402


def _t(x, dtype=torch.int32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _same(ps, bt, jps, jbt, what):
    n = jps.free.shape[0]
    top = int(ps.top)
    assert top == int(jps.top), what
    np.testing.assert_array_equal(ps.free[:top].numpy(),
                                  np.asarray(jps.free)[:top], err_msg=what)
    np.testing.assert_array_equal(ps.rc[:n].numpy(), np.asarray(jps.rc),
                                  err_msg=what)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jbt), err_msg=what)


def _check_partition(ps, bt):
    """Free-list prefix and mapped entries partition the real pages; each
    mapped page's rc is its number of table entries; no sentinel is
    handed out."""
    n = ps.free.shape[0] - 1
    top = int(ps.top)
    free_ids = set(ps.free[:top].tolist())
    assert len(free_ids) == top and all(0 <= p < n for p in free_ids)
    table = bt.numpy()
    assert (table < n).all(), "the sentinel was mapped"
    counts = Counter(table[table >= 0].tolist())
    rc = ps.rc.numpy()
    for p in range(n):
        want = 0 if p in free_ids else counts[p]
        assert rc[p] == want and (p in free_ids) != (counts[p] >= 1), p


def _walk(seed, n_pages=10, batch=4, max_blocks=4, page=2):
    """``tests/test_pager.py``'s ``_run_sequence`` kinds on both pagers,
    with a payload pool and its host tier moved by ``copy_pages``."""
    rng = np.random.default_rng(seed)
    n_h = batch * max_blocks
    ps, bt = pager.init_pager(n_pages, "cpu"), pager.init_block_table(
        batch, max_blocks, "cpu")
    hs, ht = pager.init_pager(n_h, "cpu"), pager.init_block_table(
        batch, max_blocks, "cpu")
    jps, jbt = jpager.init_pager(n_pages), jpager.init_block_table(
        batch, max_blocks)
    jhs, jht = jpager.init_pager(n_h), jpager.init_block_table(
        batch, max_blocks)
    data = rng.standard_normal((1, n_pages, page, 1, 2)).astype(np.float32)
    pool = torch.zeros((1, n_pages + 1, page, 1, 2))
    pool[:, :n_pages] = torch.from_numpy(data)
    hpool = torch.zeros((1, n_h + 1, page, 1, 2))
    jpool, jhpool = jnp.asarray(data), jnp.zeros((1, n_h, page, 1, 2))
    pos = np.zeros((batch,), np.int32)
    spilled = np.zeros((batch,), bool)
    moves = 0
    for step in range(60):
        kind = int(rng.integers(0, 5))
        mask = rng.random(batch) < 0.5
        if kind == 1:
            ps, bt = pager.release_rows(ps, bt, _t(mask, torch.bool))
            hs, ht = pager.release_rows(hs, ht, _t(mask, torch.bool))
            jps, jbt = jpager.release_rows(jps, jbt, jnp.asarray(mask))
            jhs, jht = jpager.release_rows(jhs, jht, jnp.asarray(mask))
            pos[mask] = 0
            spilled[mask] = False
        elif kind == 2:
            src = int(rng.integers(0, batch))
            mask[src] = False
            mask &= ~spilled
            if spilled[src]:
                mask[:] = False
            if mask.any():
                m = _t(mask, torch.bool)
                ps, bt = pager.release_rows(ps, bt, m)
                jps, jbt = jpager.release_rows(jps, jbt, jnp.asarray(mask))
                row = bt.numpy()[src]
                nblk = 0
                while nblk < max_blocks and row[nblk] >= 0:
                    nblk += 1
                ps, bt = pager.share_prefix(ps, bt, _t([src] * batch),
                                            _t([nblk] * batch), m)
                jps, jbt = jpager.share_prefix(
                    jps, jbt, jnp.full((batch,), src, jnp.int32),
                    jnp.full((batch,), nblk, jnp.int32), jnp.asarray(mask))
                pos[mask] = max(nblk * page - 1, 0)
        elif kind in (3, 4):
            mask &= ~spilled if kind == 3 else spilled
            need = int((ht.numpy()[mask] >= 0).sum())
            if not mask.any() or (kind == 4 and need > int(ps.top)):
                continue
            fn, jfn = ((pager.spill_rows, jpager.spill_rows) if kind == 3
                       else (pager.restore_rows, jpager.restore_rows))
            ps, bt, hs, ht, src, dst = fn(ps, bt, hs, ht,
                                          _t(mask, torch.bool))
            jps, jbt, jhs, jht, jsrc, jdst = jfn(jps, jbt, jhs, jht,
                                                 jnp.asarray(mask))
            np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
            np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
            assert src.dtype == dst.dtype == torch.int64
            if kind == 3:
                pager.copy_pages(hpool, pool, src, dst)
                jhpool = jpager.copy_pages(jhpool, jpool, jsrc, jdst)
            else:
                pager.copy_pages(pool, hpool, src, dst)
                jpool = jpager.copy_pages(jpool, jhpool, jsrc, jdst)
            spilled[mask] = kind == 3
            moves += 1
        else:
            mask &= ~spilled
            ps, bt, *_ = pager.cow_on_write(ps, bt, _t(pos),
                                            _t(mask, torch.bool),
                                            page_size=page)
            jps, jbt, *_ = jpager.cow_on_write(jps, jbt, jnp.asarray(pos),
                                               jnp.asarray(mask),
                                               page_size=page)
            ps, bt = pager.alloc_on_write(ps, bt, _t(pos),
                                          _t(mask, torch.bool),
                                          page_size=page)
            jps, jbt = jpager.alloc_on_write(jps, jbt, jnp.asarray(pos),
                                             jnp.asarray(mask),
                                             page_size=page)
            pos[mask] += 1
        _same(ps, bt, jps, jbt, f"device tier, step {step}")
        _same(hs, ht, jhs, jht, f"host tier, step {step}")
        _check_partition(ps, bt)
        _check_partition(hs, ht)
        assert not ((bt.numpy() >= 0) & (ht.numpy() >= 0)).any()
        np.testing.assert_array_equal(pool[:, :n_pages].numpy(),
                                      np.asarray(jpool))
        np.testing.assert_array_equal(hpool[:, :n_h].numpy(),
                                      np.asarray(jhpool))
    return moves


@pytest.mark.parametrize("seed", range(6))
def test_spill_restore_walk_matches_jax(seed):
    assert _walk(seed) > 0


def test_spill_of_shared_row_keeps_peer_pages_matches_jax():
    """A donor spilled while a sharer maps its pages: a private host copy,
    the shared pages stay resident for the peer, and the restore takes
    fresh private pages — the same state on both sides at every step."""
    ps, bt = pager.init_pager(4, "cpu"), pager.init_block_table(2, 2, "cpu")
    hs, ht = pager.init_pager(4, "cpu"), pager.init_block_table(2, 2, "cpu")
    jps, jbt = jpager.init_pager(4), jpager.init_block_table(2, 2)
    jhs, jht = jpager.init_pager(4), jpager.init_block_table(2, 2)
    donor = np.asarray([True, False])
    for p in range(4):
        ps, bt = pager.alloc_on_write(ps, bt, _t([p, 0]),
                                      _t(donor, torch.bool), page_size=2)
        jps, jbt = jpager.alloc_on_write(jps, jbt, jnp.asarray([p, 0]),
                                         jnp.asarray(donor), page_size=2)
    ps, bt = pager.share_prefix(ps, bt, _t([0, 0]), _t([2, 2]),
                                _t([False, True], torch.bool))
    jps, jbt = jpager.share_prefix(jps, jbt, jnp.zeros((2,), jnp.int32),
                                   jnp.full((2,), 2, jnp.int32),
                                   jnp.asarray([False, True]))
    shared = bt.numpy()[0].copy()
    for fn, jfn in ((pager.spill_rows, jpager.spill_rows),
                    (pager.restore_rows, jpager.restore_rows)):
        ps, bt, hs, ht, _, _ = fn(ps, bt, hs, ht, _t(donor, torch.bool))
        jps, jbt, jhs, jht, _, _ = jfn(jps, jbt, jhs, jht,
                                       jnp.asarray(donor))
        _same(ps, bt, jps, jbt, fn.__name__)
        _same(hs, ht, jhs, jht, fn.__name__)
        if fn is pager.spill_rows:
            assert int(ps.top) == 2          # the peer holds the pages
            np.testing.assert_array_equal(bt.numpy()[1], shared)
            assert (ps.rc.numpy()[shared] == 1).all()
    restored = bt.numpy()[0]
    assert not set(restored.tolist()) & set(shared.tolist())
    assert (ps.rc.numpy()[restored] == 1).all()


def test_int8_scales_ride_the_same_ids_as_jax():
    """An int8 pool and its per-(page, head) scales spill and restore with
    one pair of id vectors; payload and scales come back bit for bit,
    equal to JAX's on the real pages."""
    rng = np.random.default_rng(3)
    n, page, hkv, hd = 4, 2, 2, 4
    q = rng.integers(-127, 128, (1, n, page, hkv, hd)).astype(np.int8)
    sc = rng.random((1, n, hkv)).astype(np.float32)
    pool = torch.zeros((1, n + 1, page, hkv, hd), dtype=torch.int8)
    pool[:, :n] = torch.from_numpy(q)
    scales = torch.zeros((1, n + 1, hkv))
    scales[:, :n] = torch.from_numpy(sc)
    hpool, hscales = torch.zeros_like(pool), torch.zeros_like(scales)
    ps, bt = pager.init_pager(n, "cpu"), pager.init_block_table(2, 2, "cpu")
    hs, ht = pager.init_pager(n, "cpu"), pager.init_block_table(2, 2, "cpu")
    jps, jbt = jpager.init_pager(n), jpager.init_block_table(2, 2)
    jhs, jht = jpager.init_pager(n), jpager.init_block_table(2, 2)
    for p in range(4):
        ps, bt = pager.alloc_on_write(ps, bt, _t([p, p]), page_size=2)
        jps, jbt = jpager.alloc_on_write(jps, jbt, jnp.full((2,), p),
                                         page_size=2)
    jq, jsc = jnp.asarray(q), jnp.asarray(sc)
    jhq, jhsc = jnp.zeros_like(jq), jnp.zeros_like(jsc)
    victim = np.asarray([True, False])
    row = bt.numpy()[0].copy()
    want_q, want_sc = q[0, row], sc[0, row]
    ps, bt, hs, ht, src, dst = pager.spill_rows(ps, bt, hs, ht,
                                                _t(victim, torch.bool))
    jps, jbt, jhs, jht, jsrc, jdst = jpager.spill_rows(
        jps, jbt, jhs, jht, jnp.asarray(victim))
    pager.copy_pages(hpool, pool, src, dst)
    pager.copy_pages(hscales, scales, src, dst)
    jhq = jpager.copy_pages(jhq, jq, jsrc, jdst)
    jhsc = jpager.copy_pages(jhsc, jsc, jsrc, jdst)
    np.testing.assert_array_equal(hpool[:, :n].numpy(), np.asarray(jhq))
    np.testing.assert_array_equal(hscales[:, :n].numpy(), np.asarray(jhsc))
    pool.zero_()                         # the restore must bring it back
    scales.zero_()
    ps, bt, hs, ht, src, dst = pager.restore_rows(ps, bt, hs, ht,
                                                  _t(victim, torch.bool))
    pager.copy_pages(pool, hpool, src, dst)
    pager.copy_pages(scales, hscales, src, dst)
    back = bt.numpy()[0]
    np.testing.assert_array_equal(pool[0, back].numpy(), want_q)
    np.testing.assert_array_equal(scales[0, back].numpy(), want_sc)


def test_copy_pages_snapshot_axis_matches_jax():
    """Axis 0 (slot-major snapshot pools): whole slots move, sentinel ids
    move nothing real (JAX drops them; the port's land in its sentinel
    slot)."""
    data = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    src_pool = torch.zeros((5, 3))
    src_pool[:4] = torch.from_numpy(data)
    hpool = torch.zeros((6, 3))
    src, dst = [2, 0, 4], [1, 3, 5]
    got = pager.copy_pages(hpool, src_pool, _t(src, torch.int64),
                           _t(dst, torch.int64), axis=0)
    want = jpager.copy_pages(jnp.zeros((5, 3)), jnp.asarray(data),
                             jnp.asarray(src), jnp.asarray(dst), axis=0)
    assert got is hpool
    np.testing.assert_array_equal(got[:5].numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="unsupported page axis 2"):
        pager.copy_pages(hpool, src_pool, _t(src, torch.int64),
                         _t(dst, torch.int64), axis=2)


@pytest.mark.parametrize("arch,kv_dtype,snapshots", [
    ("qwen2.5-3b-smoke", "f32", False), ("qwen2.5-3b-smoke", "int8", False),
    ("zamba2-2.7b-smoke", "bf16", True), ("mamba2-2.7b-smoke", "f32", True)])
def test_host_tier_state_matches_jax(arch, kv_dtype, snapshots):
    """``init_decode_state(host_spill=True)`` gives JAX's keys, dtypes and
    shapes (the port's page and slot axes one longer: the sentinel); pure
    ssm gets no host tier.  A spill and a restore of an empty row keep
    the state's keys, and ``reset_decode_rows`` still refuses a key it
    does not know."""
    cache = CacheConfig(layout="paged", page_size=4, snapshots=snapshots,
                        host_spill=True, kv_dtype=kv_dtype)
    state = lm.init_decode_state(get_arch(arch), 2, 16, per_row_pos=True,
                                 cache=cache, device="cpu")
    jstate = jax_lm.init_decode_state(jax_get_arch(arch), 2, 16,
                                      per_row_pos=True, cache=cache)
    assert set(state) == set(jstate)
    axis = {"hkp": 1, "hvp": 1, "hksc": 1, "hvsc": 1, "kp": 1, "vp": 1,
            "ksc": 1, "vsc": 1}
    for key, want in jstate.items():
        shape = list(want.shape)
        if key in axis:
            shape[1] += 1
        elif key.endswith(("_free", "_rc")) or key in (
                "snap_ssm", "snap_conv", "hsnap_ssm", "hsnap_conv"):
            shape[0] += 1
        assert list(state[key].shape) == shape, key
        assert str(state[key].dtype).split(".")[-1] == str(want.dtype), key
    assert ("host_table" in state) == (arch != "mamba2-2.7b-smoke")
    if "host_table" in state:
        none = torch.zeros((2,), dtype=torch.bool)
        for fn in (lm.spill_rows, lm.restore_rows):
            assert set(fn(state, none)) == set(state)
    else:
        with pytest.raises(ValueError, match="host_spill=True"):
            lm.spill_rows(state, torch.zeros((2,), dtype=torch.bool))
    with pytest.raises(ValueError, match="unhandled decode-state keys"):
        lm.reset_decode_rows(get_arch(arch),
                             {**state, "hkp_extra": state["pos"]},
                             torch.zeros((2,), dtype=torch.bool))


def test_request_queue_matches_jax():
    """(priority desc, deadline budget asc, arrival asc); cancel;
    ``max_pending`` back-pressure naming the id; rejections consume no
    id; the default workload is first in, first out."""
    got = []
    for cls, full in ((RequestQueue, QueueFullError),
                      (JaxRequestQueue, JaxQueueFullError)):
        q = cls(max_len=64, max_pending=5)
        ids = [q.submit([1, 2], 4), q.submit([1, 2], 4, priority=1),
               q.submit([1, 2], 4, deadline_ms=50.0),
               q.submit([1, 2], 4, deadline_ms=500.0),
               q.submit([3], 2, priority=1, deadline_ms=5.0)]
        with pytest.raises(full, match="request 5: queue full") as err:
            q.submit([1, 2], 4)
        trace = [str(err.value), q.pending_ids(), q.peek().req_id,
                 q.cancel(ids[2]).req_id, q.cancel(ids[2])]
        trace.append([q.pop().req_id for _ in range(len(q))])
        with pytest.raises(ValueError, match="request 5") as err:
            q.submit([1] * 100, 4)
        trace.append(str(err.value))
        fifo = cls()
        trace.append([fifo.submit([i + 1], 1) for i in range(4)])
        trace.append([fifo.pop().req_id for _ in range(4)])
        got.append(trace)
    assert got[0] == got[1]
    assert got[0][5] == [4, 1, 3, 0]
    with pytest.raises(QueueEmpty):
        RequestQueue().pop()
    spec = Request.spec([5, 6], 3, priority=2, deadline_ms=9.0)
    assert (spec.req_id, spec.tokens.tolist(), spec.priority) == (-1, [5, 6],
                                                                  2)


@pytest.mark.parametrize("kw", [
    dict(cycle=0, kind="boom"), dict(cycle=0, kind="cancel"),
    dict(cycle=0, kind="poison"), dict(cycle=0, kind="deadline"),
    dict(cycle=0, kind="exhaust_pool"), dict(cycle=-1, kind="release_pool")])
def test_fault_event_errors_match_jax(kw):
    msgs = []
    for cls in (FaultEvent, jax_faults.FaultEvent):
        with pytest.raises(ValueError) as err:
            cls(**kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_fault_plan_matches_jax():
    events = [dict(cycle=3, kind="poison", req_id=1),
              dict(cycle=1, kind="exhaust_pool", pages=5),
              dict(cycle=3, kind="cancel", req_id=2),
              dict(cycle=5, kind="release_pool")]
    plans = [FaultPlan(tuple(FaultEvent(**e) for e in events)),
             jax_faults.FaultPlan(tuple(jax_faults.FaultEvent(**e)
                                        for e in events))]
    assert plans[0].describe() == plans[1].describe()
    assert plans[0].last_cycle == plans[1].last_cycle == 5
    assert ([e.kind for e in plans[0].at(3)]
            == [e.kind for e in plans[1].at(3)] == ["poison", "cancel"])
    assert FaultPlan().describe() == "(empty plan)"


def test_configs_from_flags_leave_host_spill_to_the_engine():
    """``--n-pages`` leaves ``host_spill`` None, as JAX's flags do, so a
    small pool preempts; ``host_spill=False`` still means queue."""
    from repro.serving import config as jax_config

    class Args:
        layout, page_size, n_pages = "paged", 16, 8
        prefill_budget = 2

    cache, config = configs_from_flags(Args)
    jcache, jconfig = jax_config.configs_from_flags(Args)
    assert cache.host_spill is None and jcache.host_spill is None
    assert config.prefill_budget == jconfig.prefill_budget == 2
    assert CacheConfig(host_spill=False).host_spill is False
