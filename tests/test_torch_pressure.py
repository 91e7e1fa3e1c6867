"""Serving under pressure in the port against the JAX package, on the CPU.

``tests/test_pressure.py``'s scenarios run through ``repro.serving``'s
engine and the port's on the same params (``convert.params_from_jax``):
preemption into the host tier and restore (qwen2.5-3b and, with prefix
sharing, zamba2-2.7b, whose snapshot slots spill too), a preemption in
mid-prefill under ``prefill_budget=1``, cancels of a queued request, of a
row in mid-prefill (every family, both layouts), of a spilled row and of a
prefix donor with live sharers, a deadline storm, a pool-exhaustion window
with a poisoned row, and mamba2, which has no pages to spill but cancels
cleanly.  Each scenario is one script driven through both engines' public
surface (``submit`` with priorities and deadlines, ``step``, ``cancel``,
``set_fault_plan``, ``run``); the port must give JAX's tokens, its
``preemptions``, ``restores``, ``cancelled``, ``expired`` and poisoned
records, its step and token counts and its peak pages, and leave every
tier of both engines conserved (each free list full, each table unmapped).
The port's own bar as JAX's: the preempted streams equal an unpressured
run's token for token.  JAX's runs are cached per module.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving import CacheConfig as JaxCacheConfig  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import FaultEvent as JaxFaultEvent  # noqa: E402
from repro.serving import FaultPlan as JaxFaultPlan  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CacheConfig,
    EngineConfig,
    FaultEvent,
    FaultPlan,
    RequestHandle,
    ServingEngine,
)

from torch_parity import jax_params  # noqa: E402

QWEN, ZAMBA, MAMBA = ("qwen2.5-3b-smoke", "zamba2-2.7b-smoke",
                      "mamba2-2.7b-smoke")
# (engine, cache config, engine config, fault event, fault plan) per side
SIDES = {"jax": (JaxServingEngine, JaxCacheConfig, JaxEngineConfig,
                 JaxFaultEvent, JaxFaultPlan),
         "port": (ServingEngine, CacheConfig, EngineConfig, FaultEvent,
                  FaultPlan)}
STATS = ("decode_steps", "prefill_steps", "prompt_tokens",
         "generated_tokens", "kv_pages_peak", "snap_slots_peak",
         "preemptions", "restores", "cancelled", "expired",
         "shared_prompt_tokens")
# allocator tiers: (prefix of free/top/rc, table)
TIERS = (("page", "block_table"), ("host", "host_table"),
         ("snap", "snap_table"), ("hsnap", "hsnap_table"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's smoke-size steps are hundreds of tiny ops, for which
    torch's worker threads only add contention beside the other test
    processes; the count is restored for the next module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg, tree, jparams = jax_params(arch=arch)
    return {"jax": (jax_build_model(jcfg), jparams),
            "port": (build_model(get_arch(arch), device="cpu"),
                     params_from_jax(tree, device="cpu"))}


def _mk(side, arch, *, batch=2, max_len=32, layout="paged", n_pages=16,
        **kw):
    """An engine of ``side`` as ``test_pressure.py``'s ``_mk``: page 4,
    ``steps_per_sync`` 2, chunk 4 unless ``kw`` says otherwise."""
    eng_cls, cache_cls, config_cls = SIDES[side][:3]
    model, params = _models(arch)[side]
    config = dict(steps_per_sync=2, prefill_chunk=4)
    config.update(kw)
    return eng_cls(model, params, batch=batch, max_len=max_len,
                   cache=cache_cls(layout=layout, page_size=4,
                                   n_pages=n_pages if layout == "paged"
                                   else None),
                   config=config_cls(**config))


def _plan(side, *events):
    event, plan = SIDES[side][3:]
    return plan(events=tuple(event(**e) for e in events))


def _conserved(eng, side):
    """Every tier's free list full and table unmapped (the port's on its
    real entries: its allocators carry a trailing sentinel)."""
    ms = eng._mstate
    sentinel = 1 if side == "port" else 0
    for pre, table in TIERS:
        if pre + "_top" not in ms:
            continue
        n = np.asarray(ms[pre + "_free"]).shape[0] - sentinel
        assert int(ms[pre + "_top"]) == n, f"{side} {pre}: slots leaked"
        assert (np.asarray(ms[pre + "_rc"])[:n] == 0).all(), (side, pre)
        assert (np.asarray(ms[table]) == -1).all(), f"{side} {table}"


# -- the scenarios: one script each, run on either side ---------------------

def preempt(side, arch):
    """A priority-1 arrival that cannot reserve pages spills the resident
    low-priority row and restores it after (sharing on)."""
    eng = _mk(side, arch, n_pages=6, prefix_sharing=True)
    eng.submit(list(range(1, 9)), 10, priority=0)
    eng.step()
    eng.submit(list(range(21, 27)), 8, priority=1)
    return eng, eng.run()


def mid_prefill(side, arch, n_pages=8, budget=1):
    """The victim is still ingesting its 24-token prompt, one chunk a
    cycle under ``prefill_budget=1``, when the priority-1 arrival spills
    it."""
    eng = _mk(side, arch, max_len=40, n_pages=n_pages, steps_per_sync=1,
              prefill_budget=budget)
    eng.submit(list(range(1, 25)), 8, priority=0)
    eng.step()
    eng.submit(list(range(31, 37)), 6, priority=1)
    return eng, eng.run()


def cancel_queued(side, layout):
    eng = _mk(side, QWEN, batch=1, layout=layout)
    ra = eng.submit(list(range(1, 7)), 8)
    rb = eng.submit(list(range(11, 17)), 8)   # queued behind ra
    eng.step()
    assert eng.cancel(rb) is True
    assert eng.cancel(rb) is False            # already gone
    assert eng.cancel(10 ** 6) is False       # unknown id
    outs = eng.run()
    assert sorted(outs) == [ra] and rb in eng.cancelled
    return eng, outs


def cancel_mid_prefill(side, arch, layout):
    eng = _mk(side, arch, max_len=40, layout=layout, n_pages=20,
              prefill_budget=1)
    ra = eng.submit(list(range(1, 25)), 8)    # several chunks
    eng.step()                                # mid-prefill
    rb = eng.submit(list(range(31, 37)), 6)
    assert eng.cancel(ra) is True
    outs = eng.run()
    assert sorted(outs) == [rb] and ra in eng.cancelled
    return eng, outs


def cancel_spilled(side, arch):
    eng = _mk(side, arch, n_pages=6)
    ra = eng.submit(list(range(1, 9)), 10, priority=0)
    eng.step()
    rb = eng.submit(list(range(21, 27)), 8, priority=1)
    eng.step()                                # ra spilled, rb admitted
    assert eng.preemptions == 1
    assert eng.cancel(ra) is True             # cancelled while spilled
    outs = eng.run()
    assert sorted(outs) == [rb] and ra in eng.cancelled
    assert eng.restores == 0                  # doomed rows never restore
    return eng, outs


def cancel_donor(side, arch):
    """A prefix donor cancelled while two sharers map its pages (or
    snapshot slots)."""
    eng = _mk(side, arch, batch=4, max_len=26, n_pages=24,
              prefix_sharing=True)
    vocab = _models(arch)["port"][0].cfg.vocab_size
    prefix = np.random.default_rng(5).integers(0, vocab, size=8).tolist()
    rd = eng.submit(prefix + [7, 9], 14)
    for _ in range(3):
        eng.step()                            # the donor's prefix is written
    eng.submit(prefix + [3], 5)
    eng.submit(list(prefix), 5)
    assert eng.cancel(rd) is True
    outs = eng.run()
    assert rd in eng.cancelled and rd not in outs
    assert eng.shared_prompt_tokens > 0, "sharing never engaged"
    return eng, outs


def deadline(side):
    """A deadline storm: a resident and a queued request both expire at
    cycle 2 (``deadline_ms`` 0)."""
    eng = _mk(side, QWEN)
    rs = eng.submit(list(range(1, 7)), 10)
    ra = eng.submit(list(range(11, 17)), 10)                # resident
    rq = eng.submit(list(range(21, 27)), 10, priority=-1)   # queued
    eng.set_fault_plan(_plan(
        side, dict(cycle=2, kind="deadline", req_id=ra, deadline_ms=0.0),
        dict(cycle=2, kind="deadline", req_id=rq, deadline_ms=0.0)))
    outs = eng.run()
    assert sorted(outs) == [rs] and {ra, rq} <= eng.expired
    return eng, outs


def exhaust_poison(side):
    """5 of 8 pages held hostage from cycle 1 to 5 stall the second
    request, which is poisoned at cycle 3 and drains with no output."""
    eng = _mk(side, QWEN, n_pages=8)
    rs = eng.submit(list(range(1, 7)), 8)
    rp = eng.submit(list(range(11, 17)), 8)
    eng.set_fault_plan(_plan(
        side, dict(cycle=1, kind="exhaust_pool", pages=5),
        dict(cycle=3, kind="poison", req_id=rp),
        dict(cycle=5, kind="release_pool")))
    outs = eng.run()
    assert sorted(outs) == [rs] and rp in eng.poisoned
    return eng, outs


def ssm_cancel(side):
    """Pure ssm: no pages, no host tier, no preemption counters; a cancel
    drains the recurrent lane."""
    eng = _mk(side, MAMBA, layout="contiguous")
    assert not eng._spillable
    rs = eng.submit(list(range(1, 7)), 8)
    rc = eng.submit(list(range(11, 17)), 8)
    eng.step()
    assert eng.cancel(rc) is True
    outs = eng.run()
    assert sorted(outs) == [rs] and rc in eng.cancelled
    assert "preemptions" not in eng.stats()
    return eng, outs


SCENARIOS = {
    "preempt-qwen": (preempt, QWEN),
    "preempt-zamba2-sharing": (preempt, ZAMBA),
    "mid-prefill-qwen": (mid_prefill, QWEN),
    "mid-prefill-zamba2": (mid_prefill, ZAMBA),
    "cancel-queued-paged": (cancel_queued, "paged"),
    "cancel-queued-contiguous": (cancel_queued, "contiguous"),
    **{f"cancel-mid-prefill-{a.split('-')[0]}-{lay}":
       (cancel_mid_prefill, a, lay)
       for a in (QWEN, MAMBA, ZAMBA) for lay in ("contiguous", "paged")},
    "cancel-spilled-qwen": (cancel_spilled, QWEN),
    "cancel-spilled-zamba2": (cancel_spilled, ZAMBA),
    "cancel-donor-qwen": (cancel_donor, QWEN),
    "cancel-donor-zamba2": (cancel_donor, ZAMBA),
    "deadline-storm": (deadline,),
    "exhaust-and-poison": (exhaust_poison,),
    "ssm-not-spillable": (ssm_cancel,),
}


def _record(eng, outs):
    st = eng.stats()
    return ({int(r): np.asarray(o).tolist() for r, o in outs.items()},
            {k: st.get(k) for k in STATS},
            (set(eng.cancelled), set(eng.expired), set(eng.poisoned)))


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    fn, *args = SCENARIOS[case]
    eng, outs = fn("jax", *args)
    _conserved(eng, "jax")
    return _record(eng, outs)


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_pressure_scenario_matches_jax(case):
    fn, *args = SCENARIOS[case]
    eng, outs = fn("port", *args)
    _conserved(eng, "port")
    got, want = _record(eng, outs), _jax_run(case)
    assert got[0] == want[0], "token streams"
    assert got[1] == want[1], "counters"
    assert got[2] == want[2], "cancelled, expired, poisoned"
    if fn in (preempt, mid_prefill):
        assert eng.preemptions >= 1 and eng.restores >= 1


@pytest.mark.parametrize("arch", [QWEN, ZAMBA])
def test_preempted_streams_equal_unpressured(arch):
    """The port's own bar, as JAX's: a preempted and restored request,
    whether its prompt was resident or still being ingested, gives the
    tokens of a run with room for both."""
    for fn, roomy in ((preempt, None), (mid_prefill, 20)):
        if roomy is None:
            eng = _mk("port", arch, n_pages=16, prefix_sharing=True)
            eng.submit(list(range(1, 9)), 10, priority=0)
            eng.submit(list(range(21, 27)), 8, priority=1)
            base = eng.run()
            pres = fn("port", arch)[1]
        else:
            base = mid_prefill("port", arch, n_pages=roomy, budget=0)[1]
            pres = fn("port", arch)[1]
        assert sorted(base) == sorted(pres) == [0, 1]
        for rid in base:
            np.testing.assert_array_equal(pres[rid], base[rid])


def test_submit_takes_a_spec_and_returns_a_handle():
    """``submit(Request.spec(...))`` as JAX's: the handle is the id, and
    ``handle.cancel()`` cancels; a spec with ``max_new_tokens`` again, or
    no ``max_new_tokens`` at all, is a ``TypeError``."""
    from repro_torch.serving import Request

    eng = _mk("port", QWEN, batch=1)
    h0 = eng.submit(Request.spec([1, 2, 3], 4, priority=2, deadline_ms=1e6))
    h1 = eng.submit([4, 5, 6], 4)
    assert isinstance(h0, RequestHandle) and h0 == 0 and h1.rid == 1
    assert eng.queue.peek().priority == 2
    with pytest.raises(TypeError, match="must not also be passed"):
        eng.submit(Request.spec([1], 2), 2)
    with pytest.raises(TypeError, match="needs max_new_tokens"):
        eng.submit([1, 2])
    assert h1.cancel() is True and 1 in eng.cancelled
    assert sorted(eng.run()) == [0]
    _conserved(eng, "port")
