"""Continuous-batching serving engine (the port's ``repro.serving.engine``:
the dense, moe, ssm and hybrid families, contiguous or paged KV layout,
the paged pool in the model's dtype, bf16 or int8, token-by-token or
chunked prefill, greedy or sampled decoding, prefix sharing, serving
under pressure: priorities, deadlines, cancellation, preemption into a
host tier, prefill budgets and scripted faults, and speculative
decoding).

The control state of every batch row lives on the device as fixed-shape
tensors (``SlotState``): the token buffer holds the prompt and then the
generated tokens, so feeding the model is one gather whether a row is in
its prompt or generating.  ``engine_step`` is one decode step (or, with
``chunk > 1``, one chunked-prefill step) for all rows with no host
interaction; a cycle (``step``) is

    admit    — the cycle's scripted faults fire, queued requests past
               their deadline leave, spilled rows that fit come back, and
               queued requests enter free rows (host->device copies from
               pinned memory, no sync); under the paged layout a request
               is admitted only if its worst-case pages fit the pool's
               unreserved remainder, preempting rows of strictly lower
               priority into the host tier where that makes it fit; with
               prefix sharing it maps a resident donor's prompt pages
               (and restores its recurrent-state snapshot) and starts at
               the first unshared token,
    prefill  — chunked-prefill steps while some row has >= 2 prompt
               tokens left (``prefill_chunk > 1`` only, at most
               ``prefill_budget`` of them when it is set), no host sync,
    decode   — ``steps_per_sync`` engine steps (or draft-and-verify steps)
               back to back, no host sync; rows a budget stop left
               mid-prompt are frozen,
    harvest  — one device->host readback (tokens, active rows, under
               speculation progress and the accept counter, and the free
               counts of the page and snapshot pools); finished rows
               return their tokens, and they and the cancelled, poisoned
               and expired rows release their pages and slots in every
               tier.

The host keeps a mirror of per-row progress: a row's progress after a step
is a pure function of its prompt and total lengths and the chunk width, so
the prefill schedule and time-to-first-token are known without reading the
device.  ``admit`` (spill and restore included), ``prefill`` and ``decode``
must never synchronise with the device; ``chip_smoke.py`` runs them under
``torch.cuda.set_sync_debug_mode("error")`` (the port of the JAX engine's
``no_transfer_audit``).

Sampling (``temperature > 0``) draws each token with JAX's own Threefry
streams (``serving/prng.py``): row keys come from ``(seed, req_id)`` at
admission and each token is keyed by ``fold_in(key, position)``, so the
sampled streams equal the JAX engine's and do not depend on the batch,
``steps_per_sync`` or the chunk schedule.

Prefix sharing (``prefix_sharing=True``, paged layout) keeps the JAX
engine's host-side index of page-aligned prompt chunks (chained hashes,
verified token by token, no device sync).  Attention families read the
donor's pages (refcounted) and copy-on-write the one page a fully shared
prompt writes again; the recurrent families restore the donor's state
snapshot at the last shared boundary, which every snapshot engine
captures because its chunks are clipped to end on page boundaries.

Under pressure the port keeps the JAX engine's scheduler contract (the
class docstring): the queue orders by priority, deadline budget and
arrival; a head that cannot reserve its pages spills victims of strictly
lower priority to the host tier (``model.spill_rows``: on the card one
page-copy launch a pool into pinned host memory) and they come back
(``model.restore_rows``) as soon as their reservation fits; cancelled,
poisoned and expired rows drain at the harvest through the release path.

Speculative decoding (``spec=SpecConfig(k, drafter)``, greedy, chunk >= 2)
turns the decode phase into draft and verify, as JAX's: a drafter
(``serving/drafter.py``: n-gram prompt lookup, or the hybrid family's own
Mamba layers) proposes K tokens a row, one ``prefill_chunk(logits_all=
True)`` of width K + 1 scores them, and each row keeps its leading run of
drafts equal to the verifier's argmax, so the tokens are plain greedy
decode's.  Attention families roll a rejected suffix back by rewinding
``pos`` and ``pager.release_tail``; the recurrent ones, whose state the
port writes in place, score on a discarded pass that leaves the state
byte-identical (``lm.score_chunk``: scratch ``ssm``/``conv`` and, for
the hybrid's KV, the touched pages saved and written back) and commit
with a second pass of the accepted width.  Strides then depend on the
data, so the host mirror takes the device's progress at the harvest.

Unlike JAX's jitted steps, the port runs eagerly; the caches, page pools
and the token buffer are updated in place.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import TYPE_CHECKING, Dict, List, NamedTuple, Optional, Set

import numpy as np
import torch

from repro_torch.serving import prng
from repro_torch.serving.config import (
    CacheConfig,
    EngineConfig,
    from_kwargs,
    validate_configs,
)
from repro_torch.serving.drafter import make_drafter
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.pager import (
    PagerState,
    pages_needed,
    release_tail,
    share_prefix,
)
from repro_torch.serving.queue import Request, RequestQueue

if TYPE_CHECKING:  # the model imports the pager, which lives here
    from repro_torch.models.model import Model


class SlotState(NamedTuple):
    """Per-row serving control state — device tensors, fixed shapes."""

    tokens: torch.Tensor      # (B, max_len) int64: prompt then generated
    prompt_len: torch.Tensor  # (B,) int64
    total_len: torch.Tensor   # (B,) int64: prompt_len + max_new_tokens
    progress: torch.Tensor    # (B,) int64: tokens fed to the model so far
    active: torch.Tensor      # (B,) bool: row currently serving a request
    rng: torch.Tensor         # (B, 2) int64: the row's uint32 sampling key


def init_slots(batch: int, max_len: int, device: torch.device) -> SlotState:
    return SlotState(
        tokens=torch.zeros((batch, max_len), dtype=torch.int64, device=device),
        prompt_len=torch.ones((batch,), dtype=torch.int64, device=device),
        total_len=torch.ones((batch,), dtype=torch.int64, device=device),
        progress=torch.zeros((batch,), dtype=torch.int64, device=device),
        active=torch.zeros((batch,), dtype=torch.bool, device=device),
        rng=torch.zeros((batch, 2), dtype=torch.int64, device=device),
    )


def _sample(logits: torch.Tensor, slots: SlotState, wpos: torch.Tensor,
            temperature: float, top_k: int) -> torch.Tensor:
    """Next token of every row (``repro.serving.engine._sample``).  At
    ``temperature <= 0`` the greedy argmax (the first maximum, as
    ``jnp.argmax``).  Otherwise the f32 logits over the temperature
    (times its f32 reciprocal, as XLA folds the division by a constant),
    cut below the ``top_k``-th value, and drawn by ``categorical`` under
    ``fold_in(row key, wpos)``: a token's key depends only on the row's
    admission key and the position it lands at, so the schedule of steps
    that reaches a position cannot change it."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    sub = prng.fold_in(slots.rng, wpos)
    lg = logits.float() * float(np.float32(1) / np.float32(temperature))
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, -torch.inf, lg)
    return prng.categorical(sub, lg)


def engine_step(model: "Model", params, mstate, slots: SlotState, *,
                chunk: int = 1, temperature: float = 0.0, top_k: int = 0,
                cow: bool = False, snap_every: int = 0):
    """One decode (``chunk == 1``) or chunked-prefill step for every row,
    no host interaction.

    Decode: row b feeds ``tokens[b, progress[b]]``.  Prefill: row b feeds
    ``tokens[b, progress[b] : progress[b] + width[b]]`` with ``width =
    clip(prompt_len - progress, 1, limit)``, ``limit = chunk``, so a
    chunk never crosses into generated positions and the last one ends at
    ``prompt_len - 1``; decode-phase rows ride along at width 1.  The
    sampled token is written at ``progress + stride`` once that position
    is past the prompt.  A row is done after the step that produces its
    last token (``progress`` reaches ``total_len - 1``).  Inactive rows
    keep their lane but never advance, never write their caches and never
    take pages (``active`` flows into the model step).

    ``cow`` runs copy-on-write in the model step (engines that can share
    pages).  ``snap_every`` (snapshot engines) also cuts ``limit`` to end
    each chunk on a page boundary it would cross, so every boundary is a
    step's end and gets its snapshot; the host mirror's ``_chunk_limit``
    replays the same cut.
    """
    b, max_len = slots.tokens.shape
    if chunk > 1:
        limit = torch.full_like(slots.progress, chunk)
        if snap_every:
            limit = torch.minimum(limit,
                                  snap_every - slots.progress % snap_every)
        width = torch.minimum((slots.prompt_len - slots.progress).clamp(
            min=1), limit)
        gidx = (slots.progress[:, None]
                + torch.arange(chunk, device=slots.tokens.device)[None, :]
                ).clamp(0, max_len - 1)
        toks = slots.tokens.gather(1, gidx)
        logits, mstate = model.prefill_chunk(params, mstate, toks, width,
                                             active=slots.active, cow=cow,
                                             snap_every=snap_every)
        stride = width
    else:
        feed_idx = slots.progress.clamp(0, max_len - 1)
        tok = slots.tokens.gather(1, feed_idx[:, None])[:, 0]
        logits, mstate = model.decode_step(params, mstate, tok,
                                           active=slots.active, cow=cow,
                                           snap_every=snap_every)
        stride = 1
    wpos = slots.progress + stride
    nxt = _sample(logits, slots, wpos, temperature, top_k)
    writes = slots.active & (wpos >= slots.prompt_len) & (wpos < max_len)
    # one column per row: a clamped column of a row that does not write
    # takes back its own old value, and no other row shares the row
    col = wpos.clamp(max=max_len - 1)[:, None]
    tokens = slots.tokens
    tokens.scatter_(1, col, torch.where(writes[:, None], nxt[:, None],
                                        tokens.gather(1, col)))
    progress = slots.progress + stride * slots.active.long()
    active = slots.active & (progress < slots.total_len - 1)
    return mstate, SlotState(tokens, slots.prompt_len, slots.total_len,
                             progress, active, slots.rng)


def _timed(method):
    """Add the method's wall time to ``self.seconds`` (the engine's busy
    time, read by ``stats``), however the caller drives the phases."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return method(self, *args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0
    return wrapper


class RequestHandle(int):
    """What ``submit`` returns: the request id (an ``int``, so it indexes
    ``outputs`` and ``ttft`` and compares equal to the id) with
    ``handle.rid`` and ``handle.cancel()``."""

    def __new__(cls, rid: int, engine: "ServingEngine"):
        self = super().__new__(cls, rid)
        self._engine = engine
        return self

    @property
    def rid(self) -> int:
        """The request id as a plain ``int``."""
        return int(self)

    def cancel(self) -> bool:
        """Cancel this request (``ServingEngine.cancel``)."""
        return self._engine.cancel(self.rid)


class ServingEngine:
    """Fixed-shape continuous-batching engine over a ``Model``.

    >>> eng = ServingEngine(model, params, batch=4, max_len=128,
    ...                     cache=CacheConfig(layout="paged"),
    ...                     config=EngineConfig(prefill_chunk=16))
    >>> h = eng.submit([3, 17, 5], max_new_tokens=16)   # RequestHandle
    >>> outs = eng.run()          # {rid: np.ndarray of generated tokens}

    The engine runs on ``model.device``.  ``cache``/``config`` take the
    typed configuration; the legacy kwarg pile (``layout=``,
    ``prefill_chunk=``, ...) still works through ``from_kwargs``, with a
    ``DeprecationWarning`` at the construction site, and mixing both
    styles is a ``TypeError``.

    ``spec=SpecConfig(k=K, drafter=...)`` (greedy, ``prefill_chunk >=
    2``) drafts K tokens a row and verifies them in one chunk step, each
    row advancing by its accepted length; the tokens are plain greedy
    decode's, and ``stats()`` gains ``spec_proposed``, ``spec_accepted``,
    ``spec_emitted`` and ``spec_accept_rate``.  ``drafter="hybrid_ssm"``
    needs the hybrid family and no prefix sharing.

    ``temperature > 0`` samples (optionally cut to the ``top_k`` best);
    each request's key is a pure function of (``seed``, request id), so
    its tokens equal the JAX engine's and do not depend on the batch or
    on the order of admission.

    ``prefix_sharing=True`` (paged layout): a request whose prompt starts
    with page-aligned chunks a resident row has already written maps that
    row's pages (and, for ssm and hybrid, restores its state snapshot at
    the last shared boundary) and starts prefill at the first unshared
    token.  Tokens are those of the engine without sharing; what changes
    is TTFT and resident KV.  Admission still reserves the full worst
    case plus one copy-on-write spare for a fully shared attention prompt
    (a donor may finish first and leave the sharer the only holder), and
    the snapshot pool is sized to the worst case, so neither allocator
    can run dry inside a step.  MoE: sharing changes which tokens batch
    into a routing step, so token identity needs ``capacity_factor >=
    n_experts``, as in JAX.

    Scheduler contract (the JAX engine's).  Admission orders the queue by
    (priority desc, deadline budget asc, arrival asc).  When the head
    cannot reserve its worst-case pages, victims are spilled: resident
    rows of strictly lower priority, lowest priority first, then least
    progress, then oldest; a spill moves the row's KV pages (and snapshot
    slots) to the host tier and keeps its lane and live recurrent state in
    place, and the victims are committed only if they admit the head.
    Spilled rows come back (highest priority, then oldest) as soon as
    their reservation fits, deferring to a strictly-higher-priority queue
    head that could itself fit.  ``host_spill`` defaults to the paged
    layout (``CacheConfig(host_spill=False)`` queues instead of
    preempting).  ``cancel(req_id)`` and deadlines (``submit + deadline_ms``
    on the host's monotonic clock) take effect at once for queued
    requests and at the next harvest for resident, mid-prefill and
    spilled rows, which drain through the release path in every tier
    with no output.  ``prefill_budget`` bounds the chunked-prefill steps
    of a cycle; rows it stops mid-prompt are frozen through the cycle's
    decode, so their chunk boundaries (and so their logits) stay the
    unpressured schedule's.  A ``FaultPlan`` (``fault_plan=`` or
    ``set_fault_plan``) scripts pool exhaustion, cancels, deadline storms
    and poisoned rows against the cycle clock, through the same paths.
    """

    def __init__(self, model: "Model", params, *, batch: int, max_len: int,
                 cache: Optional[CacheConfig] = None,
                 config: Optional[EngineConfig] = None,
                 fault_plan: Optional[FaultPlan] = None, **legacy) -> None:
        if legacy:
            if cache is not None or config is not None:
                raise TypeError(
                    "pass cache=CacheConfig(...) / config=EngineConfig(...) "
                    "or the legacy kwargs, not both"
                )
            # the warning points at the caller's construction site
            cache, config = from_kwargs(_stacklevel=3, **legacy)
        self.cache = cache if cache is not None else CacheConfig()
        self.config = config if config is not None else EngineConfig()
        validate_configs(self.cache, self.config)
        if model.cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            # encdec and vlm are served by launch/serve.py's lockstep loop
            raise NotImplementedError(
                f"serving engine: unsupported family {model.cfg.family!r}")
        if (self.config.prefill_chunk > 1 and model.cfg.window
                and self.cache.layout != "paged"
                and model.cfg.family in ("dense", "moe", "hybrid")):
            raise ValueError(
                "chunked prefill on a sliding-window arch needs "
                "layout='paged' (the contiguous ring cache recycles slots "
                "the in-chunk queries still read)"
            )
        self.model = model
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.device = model.device
        self.steps_per_sync = self.config.steps_per_sync
        self.prefill_chunk = self.config.prefill_chunk
        self.prefill_budget = self.config.prefill_budget
        self.page_size = self.cache.page_size
        self.prefix_sharing = self.config.prefix_sharing
        self.temperature = self.config.temperature
        self.top_k = self.config.top_k
        self.spec = self.config.spec
        self._seed = int(self.config.seed)
        self.queue = RequestQueue(max_len=max_len)
        host_spill = self.cache.host_spill
        if host_spill is None:
            # preemption only where there are pages to spill
            host_spill = self.cache.layout == "paged"
        # the snapshot store exists when asked for, or implied by sharing
        # on a recurrent family
        self._mstate = model.init_decode_state(
            batch, max_len, per_row_pos=True,
            cache=dataclasses.replace(
                self.cache,
                snapshots=self.cache.snapshots or self.prefix_sharing,
                host_spill=host_spill))
        # speculative decoding: a stateful drafter's private recurrence
        # joins the decode state, so reset, spill and restore treat it as
        # lane state; the recurrent families' scoring pass runs on scratch
        # buffers allocated here once
        self._drafter = None
        self._scratch = None
        self._acc = None
        if self.spec is not None:
            self._drafter = make_drafter(self.spec, model.cfg)
            if self._drafter.stateful:
                self._mstate = {**self._mstate,
                                **self._drafter.init_state(batch,
                                                           self.device)}
            if model.cfg.family in ("ssm", "hybrid"):
                self._scratch = model.init_scratch(self._mstate,
                                                   self.spec.k + 1)
            # [accepted, proposed, emitted], read at the harvest
            self._acc = torch.zeros((3,), dtype=torch.int64,
                                    device=self.device)
        # attention-free families have no pages whatever the layout
        self._paged = "block_table" in self._mstate
        self._snap = "snap_table" in self._mstate
        # the host tier exists for paged families with KV pages
        self._spillable = "host_table" in self._mstate
        self._recurrent = model.cfg.family in ("ssm", "hybrid")
        self.n_pages = 0
        self._kv_bytes_per_page = 0
        if self._paged:
            kp = self._mstate["kp"]       # (layers, n_pages + 1, page, ...)
            self.n_pages = kp.shape[1] - 1
            # the payload's bytes at its storage width (int8: 1); an int8
            # pool's scale pools are left out, as the JAX engine leaves
            # them out
            self._kv_bytes_per_page = (2 * kp.element_size() * kp.shape[0]
                                       * int(np.prod(kp.shape[2:])))
        self.n_snap_slots = (self._mstate["snap_free"].shape[0] - 1
                             if self._snap else 0)
        # every family shares: dense and moe through aliased pages, ssm
        # through restored snapshots, hybrid through both.  Only engines
        # that can share a page run the CoW pass (recurrent rows resume on
        # an unshared boundary and never write a shared page), and only
        # snapshot engines capture and clip chunks to boundaries.
        self._share_eligible = self.prefix_sharing and (self._paged
                                                        or self._snap)
        self._cow = self._share_eligible and self._paged
        self._snap_every = self.page_size if self._snap else 0
        self._slots = init_slots(batch, max_len, self.device)
        # host mirror: which request occupies each row (None = free), how
        # far it has been fed, and its worst-case page reservation; a
        # spilled row keeps its lane and request, and ``_spill_need``
        # holds the pages it re-reserves when it comes back
        self._slot_req: List[Optional[Request]] = [None] * batch
        self._row_progress: List[int] = [0] * batch
        self._row_pages: List[int] = [0] * batch
        self._row_spilled: List[bool] = [False] * batch
        self._spill_need: List[int] = [0] * batch
        self._pages_reserved = 0
        # host-side prefix index: chained chunk hash -> (slot, epoch); an
        # epoch bump invalidates a released slot's entries, and a match
        # is verified token for token, so a collision never maps pages
        self._prefix_index: Dict[int, tuple] = {}
        self._slot_epoch: List[int] = [0] * batch
        self._slot_hashes: List[List[int]] = [[] for _ in range(batch)]
        self._crossed: List[int] = []   # first token produced, not yet read
        self.outputs: Dict[int, np.ndarray] = {}
        self.steps = 0            # decode steps executed (all rows per step)
        self.prefill_steps = 0    # chunked-prefill steps executed
        self.generated = 0        # tokens returned to callers
        self.prompt_tokens = 0    # prompt tokens fed (host arithmetic)
        # speculation: the device counter's values at the last harvest
        self.spec_proposed = 0    # verifiable draft positions scored
        self.spec_accepted = 0    # drafts equal to the verifier's argmax
        self.spec_emitted = 0     # tokens emitted by verify steps
        self.shared_prompt_tokens = 0   # prompt tokens skipped by sharing
        self.cow_pages = 0              # CoW copies (host-predicted)
        self.peak_pages_in_use = 0
        self.peak_snaps_in_use = 0
        self.preemptions = 0
        self.restores = 0
        self.seconds = 0.0        # wall time inside the cycle's phases
        self.ttft: Dict[int, float] = {}        # req_id -> seconds
        self._t_submit: Dict[int, float] = {}
        # deadlines (absolute, host clock), resident rows marked for the
        # next harvest's drain, and the records of requests that never
        # completed
        self._deadline: Dict[int, float] = {}
        self._cancel_req: Set[int] = set()
        self._poison_req: Set[int] = set()
        self.cancelled: Set[int] = set()
        self.expired: Set[int] = set()
        self.poisoned: Set[int] = set()
        # the fault plan's cycle clock and the pages it holds hostage
        self.fault_plan = fault_plan
        self._cycle = 0
        self._fault_hold_pages = 0

    # -- request intake ------------------------------------------------------

    def submit(self, tokens, max_new_tokens: Optional[int] = None, *,
               priority: int = 0,
               deadline_ms: Optional[float] = None) -> RequestHandle:
        """Queue a request; returns its ``RequestHandle``.  Takes ``(tokens,
        max_new_tokens, priority=, deadline_ms=)`` or one
        ``Request.spec(...)``.  ``priority`` (larger first) and
        ``deadline_ms`` (a budget from now, None = none) feed the
        scheduler contract of the class docstring.  Under the paged layout
        a request that could never reserve its pages is rejected now."""
        if isinstance(tokens, Request):
            req = tokens
            if max_new_tokens is not None:
                raise TypeError(
                    "submit(Request, ...) takes the whole spec from the "
                    "Request — max_new_tokens must not also be passed"
                )
            tokens, max_new_tokens = req.tokens, req.max_new_tokens
            priority, deadline_ms = req.priority, req.deadline_ms
        elif max_new_tokens is None:
            raise TypeError(
                "submit() needs max_new_tokens unless a Request spec "
                "is passed"
            )
        if self._paged:
            need = pages_needed(len(tokens) + max_new_tokens, self.page_size)
            if need > self.n_pages:
                # the queue would otherwise starve behind it
                rid = self.queue.peek_next_id()
                raise ValueError(
                    f"request {rid}: needs {need} pages > pool size "
                    f"{self.n_pages} (prompt {len(tokens)} + "
                    f"{max_new_tokens} new, page_size {self.page_size})"
                )
        rid = self.queue.submit(tokens, max_new_tokens, priority=priority,
                                deadline_ms=deadline_ms)
        now = time.perf_counter()
        self._t_submit[rid] = now
        if deadline_ms is not None:
            self._deadline[rid] = now + deadline_ms / 1e3
        return RequestHandle(rid, self)

    def cancel(self, req_id: int) -> bool:
        """Cancel a request wherever it is.  Queued: removed now.
        Resident (active, mid-prefill or spilled): marked, and drained
        through the release path at the next harvest with no output.
        False when the id is unknown or already finished."""
        if self.queue.cancel(req_id) is not None:
            self.cancelled.add(req_id)
            self._deadline.pop(req_id, None)
            self._t_submit.pop(req_id, None)
            return True
        if any(r is not None and r.req_id == req_id for r in self._slot_req):
            self._cancel_req.add(req_id)
            return True
        return False

    def set_fault_plan(self, plan: Optional[FaultPlan]) -> None:
        """Arm a plan with the cycle clock rewound to 0."""
        self.fault_plan = plan
        self._cycle = 0

    def _apply_faults(self) -> None:
        """Fire the armed plan's events of the current cycle, through the
        normal scheduler paths (``serving/faults.py`` has the kinds)."""
        if self.fault_plan is None:
            return
        for e in self.fault_plan.at(self._cycle):
            if e.kind == "exhaust_pool":
                self._fault_hold_pages = min(e.pages, self.n_pages)
            elif e.kind == "release_pool":
                self._fault_hold_pages = 0
            elif e.kind == "cancel":
                self.cancel(e.req_id)
            elif e.kind == "deadline":
                self._deadline[e.req_id] = (time.perf_counter()
                                            + e.deadline_ms / 1e3)
            elif e.kind == "poison":
                self._poison_req.add(e.req_id)

    def _effective_pages(self) -> int:
        """The pool the reservation ledger admits against, less the pages
        an ``exhaust_pool`` fault holds."""
        return self.n_pages - self._fault_hold_pages

    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self._slot_req)

    def _h2d(self, host: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a sync: on the card
        through a pinned staging copy and an asynchronous transfer."""
        t = torch.from_numpy(host)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- host-side prefix index (no device sync anywhere) --------------------

    def _prefix_chain(self, tokens: np.ndarray):
        """Chained hashes of the prompt's full page-aligned chunks: chunk
        i's hash folds in chunk i-1's, so a hit at depth i vouches for the
        whole prefix (a page's K/V depends on every token before it)."""
        s = self.page_size
        h = 0x51ED2701
        for i in range(len(tokens) // s):
            h = hash((h, tokens[i * s:(i + 1) * s].tobytes()))
            yield i, h

    def _register_prefix(self, b: int, tokens: np.ndarray) -> None:
        ep = self._slot_epoch[b]
        for _, h in self._prefix_chain(tokens):
            ent = self._prefix_index.get(h)
            if ent is not None:
                src, src_ep = ent
                if (src_ep == self._slot_epoch[src]
                        and self._slot_req[src] is not None
                        and not self._row_spilled[src]):
                    # a live row already serves this chunk: keep it (a
                    # sharer taking it over would take it to its own,
                    # likely earlier, end)
                    continue
            self._prefix_index[h] = (b, ep)
            self._slot_hashes[b].append(h)

    def _evict_prefix(self, b: int) -> None:
        """Invalidate slot b's index entries (its request left).  The epoch
        bump is what makes them stale; the deletes keep the index bounded
        by resident prompts."""
        old = (b, self._slot_epoch[b])
        self._slot_epoch[b] += 1
        dropped = False
        for h in self._slot_hashes[b]:
            if self._prefix_index.get(h) == old:
                del self._prefix_index[h]
                dropped = True
        self._slot_hashes[b] = []
        if dropped:
            # hand the dropped chunks to surviving holders: a sharer keeps
            # the donor's pages resident (refcounts), so it can donate
            # them onward (registration only fills gaps); a spilled row's
            # pages are on the host tier, so it does not donate
            for s, req in enumerate(self._slot_req):
                if req is not None and not self._row_spilled[s]:
                    self._register_prefix(s, req.tokens)

    def _match_prefix(self, tokens: np.ndarray):
        """Longest page-aligned prefix shared with a resident row: (donor
        slot, shared blocks), (0, 0) when nothing matches.  A hit counts
        only if the donor still holds its request (epoch) on the device
        (not spilled), its mirror progress shows the chunk written (and
        so, in a snapshot engine, its boundary captured), the chunk is
        all prompt, and the tokens are equal: the hash only routes."""
        if not self._share_eligible:
            return 0, 0
        best = (0, 0)
        s = self.page_size
        for i, h in self._prefix_chain(tokens):
            ent = self._prefix_index.get(h)
            if ent is None:
                continue
            src, ep = ent
            end = (i + 1) * s
            req = self._slot_req[src]
            if (ep != self._slot_epoch[src] or req is None
                    or self._row_spilled[src]
                    or req.prompt_len < end
                    or self._row_progress[src] < end
                    or not np.array_equal(tokens[:end], req.tokens[:end])):
                continue
            best = (src, i + 1)
        return best

    def _plan_admission(self, req: Request):
        """(donor, shared blocks, start, CoW pages, worst-case pages) of
        one request, from the mirror alone.  Recurrent families resume
        from a restored snapshot, so their shared depth stops at a
        boundary strictly inside the prompt; a fully shared attention
        prompt re-feeds its last token, whose write copies the last shared
        page (one spare page).  A spare that would overflow the pool
        serves the request unshared."""
        src, nblk = self._match_prefix(req.tokens)
        if self._recurrent:
            nblk = min(nblk, (req.prompt_len - 1) // self.page_size)
        shared = nblk * self.page_size
        start = min(shared, req.prompt_len - 1)
        cow = 1 if shared > start else 0
        need = 0
        if self._paged:
            need = pages_needed(req.total_len, self.page_size) + cow
            if need > self.n_pages:
                src = nblk = start = cow = 0
                need = pages_needed(req.total_len, self.page_size)
        return src, nblk, start, cow, need

    # -- the scheduler (host mirror only) ------------------------------------

    def _expire_queued(self, now: float) -> None:
        """Deadline sweep of the queue (resident rows expire at harvest)."""
        if not self._deadline:
            return
        for rid in self.queue.pending_ids():
            t = self._deadline.get(rid)
            if (t is not None and now >= t
                    and self.queue.cancel(rid) is not None):
                self.expired.add(rid)
                self._deadline.pop(rid, None)
                self._t_submit.pop(rid, None)

    def _doomed(self, rid: int, now: float) -> bool:
        """Cancelled, poisoned or past its deadline: drained at harvest."""
        t = self._deadline.get(rid)
        return (rid in self._cancel_req or rid in self._poison_req
                or (t is not None and now >= t))

    def _try_preempt(self, req: Request, need: int, protected) -> bool:
        """Spill rows of strictly lower priority until ``req``'s
        reservation fits, and only if it then fits (no spill that does not
        admit the head).  Victims: lowest priority, then least progress,
        then oldest; ``protected`` rows (this cycle's admissions and their
        prefix donors) and rows marked for a drain are never chosen."""
        if not self._spillable:
            return False
        victims = sorted(
            (b for b, r in enumerate(self._slot_req)
             if r is not None and not self._row_spilled[b]
             and r.priority < req.priority and b not in protected
             and r.req_id not in self._cancel_req
             and r.req_id not in self._poison_req),
            key=lambda b: (self._slot_req[b].priority,
                           self._row_progress[b], self._slot_req[b].req_id))
        chosen, freed = [], 0
        for b in victims:
            if self._pages_reserved - freed + need <= self._effective_pages():
                break
            chosen.append(b)
            freed += self._row_pages[b]
        if (not chosen or self._pages_reserved - freed + need
                > self._effective_pages()):
            return False
        mask = np.zeros((self.batch,), bool)
        for b in chosen:
            mask[b] = True
            self._spill_need[b] = self._row_pages[b]
            self._pages_reserved -= self._row_pages[b]
            self._row_pages[b] = 0
            self._row_spilled[b] = True
            self.preemptions += 1
            # its pages leave the device: no new sharer may map them
            self._evict_prefix(b)
        m = self._h2d(mask)
        self._mstate = self.model.spill_rows(self._mstate, m)
        self._slots = self._slots._replace(active=self._slots.active & ~m)
        return True

    def _try_restore(self, now: float) -> int:
        """Bring spilled rows back (highest priority, then oldest) while
        their worst-case reservation fits, which is what keeps the
        restore's device pops from running dry.  A row defers to a
        strictly-higher-priority queue head that could itself fit; doomed
        rows stay spilled and drain from the host tier at harvest."""
        spilled = [b for b in range(self.batch) if self._row_spilled[b]]
        if not spilled:
            return 0
        head = self.queue.peek()
        head_fits = (head is not None
                     and pages_needed(head.total_len, self.page_size)
                     <= self._effective_pages())
        spilled.sort(key=lambda b: (-self._slot_req[b].priority,
                                    self._slot_req[b].req_id))
        mask = np.zeros((self.batch,), bool)
        for b in spilled:
            req = self._slot_req[b]
            need = self._spill_need[b]
            if (self._doomed(req.req_id, now)
                    or (head_fits and head.priority > req.priority)
                    or self._pages_reserved + need > self._effective_pages()):
                continue
            mask[b] = True
            self._row_spilled[b] = False
            self._row_pages[b] = need
            self._spill_need[b] = 0
            self._pages_reserved += need
            self.restores += 1
        if not mask.any():
            return 0
        m = self._h2d(mask)
        self._mstate = self.model.restore_rows(self._mstate, m)
        self._slots = self._slots._replace(active=self._slots.active | m)
        if self._share_eligible:
            # back on the device: the rows may donate their prefixes again
            for b in np.flatnonzero(mask):
                self._register_prefix(int(b), self._slot_req[b].tokens)
        return int(mask.sum())

    # -- the phases of a cycle -------------------------------------------------

    @_timed
    def admit(self) -> int:
        """The first phase of a cycle: fire the fault plan's events, drop
        queued requests past their deadline, restore spilled rows that
        fit, then admit queued requests into free rows: one host->device
        copy, a reset of those rows' caches with their clocks at their
        first unshared token, and (sharing) the donors' pages and
        snapshots mapped.  Paged, the queue head is admitted only while
        its worst-case pages fit the pool's unreserved remainder,
        preempting lower-priority rows where that makes it fit; admission
        stops at the first head that does not fit.  Rows are registered
        as donors only after the copy, so rows admitted together never
        pick each other.  No sync with the device."""
        self._apply_faults()
        self._cycle += 1
        now = time.perf_counter()
        self._expire_queued(now)
        self._try_restore(now)
        free = [b for b, r in enumerate(self._slot_req) if r is None]
        if not free or not self.queue:
            return 0
        bsz, max_len = self.batch, self.max_len
        # one int64 block: tokens, then per row prompt_len, total_len,
        # start, donor, shared blocks, the key's two words and the mask
        host = np.zeros((bsz, max_len + 8), np.int64)
        registrations = []
        pending: Set[int] = set()     # rows admitted in this call
        donors: Set[int] = set()      # and their prefix donors
        for b in free:
            req = self.queue.peek()
            if req is None:
                break
            src, nblk, start, cow, need = self._plan_admission(req)
            if (self._paged and self._pages_reserved + need
                    > self._effective_pages()):
                if not self._try_preempt(req, need, pending | donors):
                    break
                # the victims left the donor set: plan again (the match
                # can only shrink, so the preemption still admits it)
                src, nblk, start, cow, need = self._plan_admission(req)
            self.queue.pop()
            self._slot_req[b] = req
            self._row_progress[b] = start
            self._row_pages[b] = need
            self._pages_reserved += need
            host[b, : req.prompt_len] = req.tokens
            host[b, max_len:] = (req.prompt_len, req.total_len, start, src,
                                 nblk, *prng.req_key(self._seed, req.req_id),
                                 1)
            self.shared_prompt_tokens += start
            self.cow_pages += cow
            if self._share_eligible:
                registrations.append((b, req.tokens))
            pending.add(b)
            if nblk > 0:
                donors.add(src)
        if not pending:
            return 0
        got = self._h2d(host)
        new_tokens = got[:, :max_len]
        plen, total, start, src, nblk, key0, key1, m = got[:, max_len:].T
        m = m.bool()
        self._mstate = self.model.reset_decode_rows(self._mstate, m,
                                                    start=start.int())
        if self._paged:
            ms = self._mstate
            pstate, bt = share_prefix(
                PagerState(ms["page_free"], ms["page_top"], ms["page_rc"]),
                ms["block_table"], src, nblk, m)
            self._mstate = {**ms, "block_table": bt,
                            "page_free": pstate.free,
                            "page_top": pstate.top, "page_rc": pstate.rc}
        if self._snap:
            self._mstate = self.model.restore_snapshots(self._mstate, m, src,
                                                        nblk)
        s = self._slots
        self._slots = SlotState(
            tokens=torch.where(m[:, None], new_tokens, s.tokens),
            prompt_len=torch.where(m, plen, s.prompt_len),
            total_len=torch.where(m, total, s.total_len),
            progress=torch.where(m, start, s.progress),
            active=s.active | m,
            rng=torch.where(m[:, None], torch.stack([key0, key1], 1), s.rng),
        )
        for b, toks in registrations:
            self._register_prefix(b, toks)
        return len(pending)

    def _step_kw(self):
        return dict(temperature=self.temperature, top_k=self.top_k,
                    cow=self._cow, snap_every=self._snap_every)

    @_timed
    def prefill(self) -> int:
        """Chunked-prefill steps while some row has >= 2 prompt tokens
        left, at most ``prefill_budget`` of them when it is set — no host
        sync; the mirror knows every row's chunk width.  Decode-phase rows
        ride along one token per step.  Returns the number of steps (0
        when ``prefill_chunk == 1``)."""
        if self.prefill_chunk == 1:
            return 0
        n = 0
        while self._prompt_phase_rows() and (
                not self.prefill_budget or n < self.prefill_budget):
            widths = [
                max(1, min(self._chunk_limit(self._row_progress[b]),
                           req.prompt_len - self._row_progress[b]))
                if req is not None else 1
                for b, req in enumerate(self._slot_req)
            ]
            self._mstate, self._slots = engine_step(
                self.model, self.params, self._mstate, self._slots,
                chunk=self.prefill_chunk, **self._step_kw(),
            )
            if self._drafter is not None and self._drafter.stateful:
                # keep the drafter's clock within a chunk of its rows:
                # decode-phase rows ride prefill steps at width 1
                self._mstate = self._drafter.ingest(
                    self.params, self._mstate, self._slots.tokens,
                    self._slots.progress, self.prefill_chunk)
            self.prefill_steps += 1
            self._advance_mirror(widths)
            n += 1
        return n

    @_timed
    def decode(self) -> None:
        """``steps_per_sync`` engine steps back to back — no host sync;
        under ``spec``, as many draft-and-verify steps (``_spec_step``),
        whose strides depend on the data, so the host mirror is refreshed
        at the harvest instead of replayed here.  A row a budget stop left
        mid-prompt is frozen for the call: fed token by token it would
        leave the chunk schedule of an unpressured run, whose chunk
        boundaries its logits depend on; it resumes chunked prefill next
        cycle."""
        run = np.ones((self.batch,), bool)
        if self.prefill_chunk > 1:
            for b, req in enumerate(self._slot_req):
                if (req is not None and not self._row_spilled[b]
                        and req.prompt_len - self._row_progress[b] >= 2):
                    run[b] = False
        frozen = None
        if not run.all():
            r = self._h2d(run)
            frozen = self._slots.active & ~r
            self._slots = self._slots._replace(active=self._slots.active & r)
        for _ in range(self.steps_per_sync):
            if self.spec is not None:
                self._spec_step()
            else:
                self._mstate, self._slots = engine_step(
                    self.model, self.params, self._mstate, self._slots,
                    **self._step_kw(),
                )
        if frozen is not None:
            self._slots = self._slots._replace(
                active=self._slots.active | frozen)
        self.steps += self.steps_per_sync
        if self.spec is None:
            self._advance_mirror([self.steps_per_sync if run[b] else 0
                                  for b in range(self.batch)])

    def _spec_step(self) -> None:
        """One draft-and-verify step for every row (JAX's ``_spec_step``),
        no host sync.  The verify chunk is the row's current token and its
        K drafts, of width ``w`` (never past the row's last token, never
        across a snapshot boundary without ending on it).  Acceptance
        keeps the leading run of drafts equal to the verifier's argmax
        (in-chunk causality makes slot j's logits exact while slots 0..j
        are true tokens), so the tokens are plain greedy decode's; the
        row advances by ``stride``, the accepted drafts plus the
        verifier's own next token.  Attention families score in place and
        roll back: ``pos`` rewinds (KV past the frontier is never
        attended) and, paged, ``release_tail`` returns the tail blocks.
        The recurrent families cannot roll back, so they score on a
        discarded pass (``score_chunk``: the state left byte-identical)
        and commit with a second pass of exact width."""
        model, params, s = self.model, self.params, self._slots
        k = self.spec.k
        bsz, buf_len = s.tokens.shape
        act, prog = s.active, s.progress
        drafts, self._mstate = self._drafter.propose(
            params, self._mstate, s.tokens, prog, act)
        cur = s.tokens.gather(1, prog.clamp(0, buf_len - 1)[:, None])
        chunk = torch.cat([cur, drafts], dim=1)              # (B, K + 1)
        limit = torch.full_like(prog, k + 1)
        if self._snap_every:
            limit = torch.minimum(
                limit, self._snap_every - prog % self._snap_every)
        w = torch.minimum((s.total_len - 1 - prog).clamp(min=1), limit)
        if self._recurrent:
            logits = model.score_chunk(params, self._mstate, chunk, w,
                                       active=act, scratch=self._scratch)
        else:
            logits, ms2 = model.prefill_chunk(
                params, self._mstate, chunk, w, active=act, cow=self._cow,
                snap_every=self._snap_every, logits_all=True)
        g = torch.argmax(logits, dim=-1)                     # (B, K + 1)
        ok = (g[:, :k] == chunk[:, 1:]) & (
            torch.arange(k, device=g.device)[None, :] < (w - 1)[:, None])
        acc_n = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        stride = torch.where(act, acc_n + 1, 0)
        if self._recurrent:
            _, self._mstate = model.prefill_chunk(
                params, self._mstate, chunk, stride.clamp(min=1),
                active=act, cow=self._cow, snap_every=self._snap_every)
        else:
            ms = {**ms2, "pos": (prog + stride).to(ms2["pos"].dtype)}
            if self._paged:
                pstate, bt = release_tail(
                    PagerState(ms["page_free"], ms["page_top"],
                               ms["page_rc"]),
                    ms["block_table"], prog + stride, act,
                    page_size=self.page_size)
                ms = {**ms, "block_table": bt, "page_free": pstate.free,
                      "page_top": pstate.top, "page_rc": pstate.rc}
            self._mstate = ms
        # the accepted tokens g[:, 0 .. acc_n] land at prog + 1 ..
        # prog + 1 + acc_n (generated positions: a spec row has
        # prog >= prompt_len - 1)
        col = torch.arange(buf_len, device=g.device)[None, :]
        rel = col - (prog + 1)[:, None]
        sel = (act[:, None] & (rel >= 0) & (rel <= acc_n[:, None])
               & (col >= s.prompt_len[:, None]))
        tokens = torch.where(sel, g.gather(1, rel.clamp(0, k)), s.tokens)
        progress = prog + stride
        self._slots = SlotState(tokens, s.prompt_len, s.total_len, progress,
                                act & (progress < s.total_len - 1), s.rng)
        self._acc += torch.stack([torch.where(act, acc_n, 0).sum(),
                                  torch.where(act, w - 1, 0).sum(),
                                  stride.sum()])

    @_timed
    def harvest(self) -> int:
        """The one device->host readback of the cycle: collect finished
        rows' tokens, stamp first-token latencies, read the page and
        snapshot pools' free counts (their peaks in use), drain the
        cancelled, poisoned and expired rows (active, mid-prefill or
        spilled) with no output, and release the pages and snapshot slots
        of the rows that left, in every tier, deactivating their lanes.
        Returns the number of requests completed."""
        s = self._slots
        parts = [s.active.long(), s.tokens.reshape(-1)]
        if self.spec is not None:
            # under speculation the strides depend on the data: progress
            # and the counter ride the same readback
            parts += [s.progress, self._acc]
        for key in ("page_top", "snap_top"):
            if key in self._mstate:
                parts.append(self._mstate[key].long().reshape(1))
        got = torch.cat(parts).cpu().numpy()
        b_, n_tok = self.batch, self.batch * self.max_len
        active = got[:b_].astype(bool)
        tokens = got[b_: b_ + n_tok].reshape(b_, self.max_len).astype(
            np.int32)
        tops = got[b_ + n_tok:]
        if self.spec is not None:
            self._refresh_mirror(tops[:b_])
            self.spec_accepted, self.spec_proposed, self.spec_emitted = (
                int(x) for x in tops[b_: b_ + 3])
            tops = tops[b_ + 3:]
        if self._paged:
            self.peak_pages_in_use = max(self.peak_pages_in_use,
                                         self.n_pages - int(tops[0]))
        if self._snap:
            self.peak_snaps_in_use = max(self.peak_snaps_in_use,
                                         self.n_snap_slots - int(tops[-1]))
        now = time.perf_counter()
        for rid in self._crossed:
            t0 = self._t_submit.pop(rid, None)
            if t0 is not None:
                self.ttft.setdefault(rid, now - t0)
        self._crossed = []
        finished = 0
        release = np.zeros((self.batch,), bool)
        drained = False
        for b, req in enumerate(self._slot_req):
            if req is None:
                continue
            rid = req.req_id
            if rid in self._cancel_req:
                self.cancelled.add(rid)
            elif rid in self._poison_req:
                self.poisoned.add(rid)
            elif self._doomed(rid, now):
                self.expired.add(rid)
            elif self._row_spilled[b] or active[b]:
                continue      # still running, or parked on the host tier
            else:
                out = tokens[b, req.prompt_len: req.total_len].copy()
                self.outputs[rid] = out
                self.generated += out.size
                self._drop_row(b)
                release[b] = True
                finished += 1
                continue
            # cancelled, poisoned or expired: no output; the row (active,
            # mid-prefill or spilled) drains through the same release
            self._drop_row(b)
            release[b] = True
            drained = True
        # free on completion: pages and snapshot slots (device and host
        # tiers) go back to their pools now, not at the row's next refill
        if release.any() and (self._paged or self._snap or drained):
            m = self._h2d(release)
            self._mstate = self.model.reset_decode_rows(self._mstate, m)
            # a drained row may still be device-active
            self._slots = self._slots._replace(
                active=self._slots.active & ~m)
        return finished

    def _drop_row(self, b: int) -> None:
        """The host mirror of a row leaving the batch, finished or
        drained: its reservation, spill mirror, prefix entries and
        ledgers."""
        rid = self._slot_req[b].req_id
        self._slot_req[b] = None
        self._pages_reserved -= self._row_pages[b]
        self._row_pages[b] = 0
        self._spill_need[b] = 0
        self._row_spilled[b] = False
        # the prompt leaves the index; its pages live on while a sharer
        # still maps them (device refcounts)
        self._evict_prefix(b)
        self._cancel_req.discard(rid)
        self._poison_req.discard(rid)
        self._deadline.pop(rid, None)
        self._t_submit.pop(rid, None)

    def _advance_mirror(self, widths: List[int]) -> None:
        """Replay one step's progress update on the host: row b advanced
        by ``widths[b]`` (a chunk width, or ``steps_per_sync`` for a fused
        decode call — the ``total_len - 1`` clamp absorbs the overshoot
        as the device's ``active`` mask does; a spilled row's lane is
        inactive and does not move).  Counts prompt tokens fed and notes
        rows whose first generated token was produced (stamped at the
        next harvest, when it exists)."""
        for b, req in enumerate(self._slot_req):
            if req is None or self._row_spilled[b]:
                continue
            p = self._row_progress[b]
            if p >= req.total_len - 1:
                continue
            np_ = min(p + widths[b], req.total_len - 1)
            self.prompt_tokens += (
                min(np_, req.prompt_len) - min(p, req.prompt_len)
            )
            if p < req.prompt_len <= np_:
                self._crossed.append(req.req_id)
            self._row_progress[b] = np_

    def _refresh_mirror(self, progress: np.ndarray) -> None:
        """Under speculation the device's per-row progress is the truth:
        the mirror takes it, and the prompt tokens fed and the rows whose
        first generated token was produced are recovered from old against
        new, as the replay would have counted them."""
        for b, req in enumerate(self._slot_req):
            if req is None:
                continue
            old, new = self._row_progress[b], int(progress[b])
            plen = req.prompt_len
            self.prompt_tokens += min(new, plen) - min(old, plen)
            if old < plen <= new:
                self._crossed.append(req.req_id)
            self._row_progress[b] = new

    def _chunk_limit(self, progress: int) -> int:
        """Host mirror of ``engine_step``'s chunk-width cap (snapshot
        engines end chunks on page boundaries); the two must stay
        identical, as the mirror's schedule depends on it."""
        if self._snap_every:
            return min(self.prefill_chunk,
                       self._snap_every - progress % self._snap_every)
        return self.prefill_chunk

    def _prompt_phase_rows(self) -> bool:
        """True while some occupied, unspilled, unfinished row still has
        >= 2 prompt tokens to feed (a single remaining prompt token is a
        decode feed)."""
        return any(
            req is not None and not self._row_spilled[b]
            and self._row_progress[b] < req.total_len - 1
            and req.prompt_len - self._row_progress[b] >= 2
            for b, req in enumerate(self._slot_req)
        )

    # -- serving loop --------------------------------------------------------

    def step(self) -> int:
        """One cycle: admit, prefill, decode, harvest.  Returns the number
        of requests completed."""
        self.admit()
        if not any(r is not None for r in self._slot_req):
            return 0
        self.prefill()
        self.decode()
        return self.harvest()

    def run(self) -> Dict[int, np.ndarray]:
        """Serve until queue and slots drain; returns {req_id: generated}."""
        while self.busy():
            self.step()
        return self.outputs

    def stats(self) -> Dict[str, float]:
        ttft = list(self.ttft.values())
        out = {
            "decode_steps": float(self.steps),
            "prefill_steps": float(self.prefill_steps),
            "generated_tokens": float(self.generated),
            "prompt_tokens": float(self.prompt_tokens),
            "batch": float(self.batch),
            "seconds": self.seconds,
            "tok_per_s": self.generated / self.seconds if self.seconds else 0.0,
            # per engine step: a prefill step and a decode step alike
            "ms_per_step": (1e3 * self.seconds
                            / (self.steps + self.prefill_steps)
                            if self.steps else 0.0),
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
        }
        if self._paged:
            out["kv_pages"] = float(self.n_pages)
            out["kv_pages_peak"] = float(self.peak_pages_in_use)
            out["kv_resident_bytes_peak"] = float(
                self.peak_pages_in_use * self._kv_bytes_per_page)
        if self._snap:
            out["snap_slots"] = float(self.n_snap_slots)
            out["snap_slots_peak"] = float(self.peak_snaps_in_use)
        if self.prefix_sharing:
            out["shared_prompt_tokens"] = float(self.shared_prompt_tokens)
            out["cow_pages"] = float(self.cow_pages)
        if self._spillable:
            out["preemptions"] = float(self.preemptions)
            out["restores"] = float(self.restores)
        if self.spec is not None:
            out["spec_proposed"] = float(self.spec_proposed)
            out["spec_accepted"] = float(self.spec_accepted)
            out["spec_emitted"] = float(self.spec_emitted)
            out["spec_accept_rate"] = (self.spec_accepted
                                       / max(self.spec_proposed, 1))
        out["cancelled"] = float(len(self.cancelled))
        out["expired"] = float(len(self.expired))
        return out


def serve_all(model: "Model", params, requests, *, batch: int, max_len: int,
              steps_per_sync: int = 8, cache: Optional[CacheConfig] = None,
              config: Optional[EngineConfig] = None,
              **engine_kwargs) -> Dict[int, np.ndarray]:
    """Submit ``[(tokens, max_new_tokens), ...]`` and drain; the outputs
    keyed by submission order (0..n-1).  Takes the config objects (then
    ``steps_per_sync`` lives in ``config``) or the legacy kwarg pile,
    which goes through the engine's ``from_kwargs`` adapter, as the JAX
    package's ``serve_all``."""
    if cache is not None or config is not None:
        eng = ServingEngine(model, params, batch=batch, max_len=max_len,
                            cache=cache, config=config, **engine_kwargs)
    elif engine_kwargs:
        eng = ServingEngine(model, params, batch=batch, max_len=max_len,
                            steps_per_sync=steps_per_sync, **engine_kwargs)
    else:
        eng = ServingEngine(model, params, batch=batch, max_len=max_len,
                            config=EngineConfig(
                                steps_per_sync=steps_per_sync))
    for tokens, gen in requests:
        eng.submit(tokens, gen)
    return eng.run()
