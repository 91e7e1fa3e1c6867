"""Continuous-batching serving engine (the port's ``repro.serving.engine``:
the dense, moe, ssm and hybrid families, contiguous or paged KV layout,
the paged pool in the model's dtype, bf16 or int8, token-by-token or
chunked prefill, greedy).

The control state of every batch row lives on the device as fixed-shape
tensors (``SlotState``): the token buffer holds the prompt and then the
generated tokens, so feeding the model is one gather whether a row is in
its prompt or generating.  ``engine_step`` is one decode step (or, with
``chunk > 1``, one chunked-prefill step) for all rows with no host
interaction; a cycle (``step``) is

    admit    — queued requests enter free rows (one host->device copy);
               under the paged layout a request is admitted only if its
               worst-case pages fit the pool's unreserved remainder,
    prefill  — chunked-prefill steps while some row has >= 2 prompt
               tokens left (``prefill_chunk > 1`` only), no host sync,
    decode   — ``steps_per_sync`` engine steps back to back, no host sync,
    harvest  — one device->host readback (tokens, active rows and the
               pool's free count); finished rows return their tokens and,
               paged, release their pages.

The host keeps a mirror of per-row progress: a row's progress after a step
is a pure function of its prompt and total lengths and the chunk width, so
the prefill schedule and time-to-first-token are known without reading the
device.  ``prefill`` and ``decode`` must never synchronise with the device;
``chip_smoke.py`` runs both under ``torch.cuda.set_sync_debug_mode("error")``
(the port of the JAX engine's ``no_transfer_audit``).

Unlike JAX's jitted steps, the port runs eagerly; the caches, page pools
and the token buffer are updated in place.
"""
from __future__ import annotations

import functools
import time
from typing import TYPE_CHECKING, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.serving.config import PRESSURE, CacheConfig, EngineConfig
from repro_torch.serving.pager import pages_needed
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


def init_slots(batch: int, max_len: int, device: torch.device) -> SlotState:
    return SlotState(
        tokens=torch.zeros((batch, max_len), dtype=torch.int64, device=device),
        prompt_len=torch.ones((batch,), dtype=torch.int64, device=device),
        total_len=torch.ones((batch,), dtype=torch.int64, device=device),
        progress=torch.zeros((batch,), dtype=torch.int64, device=device),
        active=torch.zeros((batch,), dtype=torch.bool, device=device),
    )


def _sample(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next token; ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    return torch.argmax(logits, dim=-1)


def engine_step(model: "Model", params, mstate, slots: SlotState, *,
                chunk: int = 1):
    """One decode (``chunk == 1``) or chunked-prefill step for every row,
    no host interaction.

    Decode: row b feeds ``tokens[b, progress[b]]``.  Prefill: row b feeds
    ``tokens[b, progress[b] : progress[b] + width[b]]`` with ``width =
    clip(prompt_len - progress, 1, chunk)``, so a chunk never crosses into
    generated positions and the last one ends at ``prompt_len - 1``;
    decode-phase rows ride along at width 1.  The sampled token is written
    at ``progress + stride`` once that position is past the prompt.  A row
    is done after the step that produces its last token (``progress``
    reaches ``total_len - 1``).  Inactive rows keep their lane but never
    advance, never write their caches and never take pages (``active``
    flows into the model step).
    """
    b, max_len = slots.tokens.shape
    if chunk > 1:
        width = (slots.prompt_len - slots.progress).clamp(1, chunk)
        gidx = (slots.progress[:, None]
                + torch.arange(chunk, device=slots.tokens.device)[None, :]
                ).clamp(0, max_len - 1)
        toks = slots.tokens.gather(1, gidx)
        logits, mstate = model.prefill_chunk(params, mstate, toks, width,
                                             active=slots.active)
        stride = width
    else:
        feed_idx = slots.progress.clamp(0, max_len - 1)
        tok = slots.tokens.gather(1, feed_idx[:, None])[:, 0]
        logits, mstate = model.decode_step(params, mstate, tok,
                                           active=slots.active)
        stride = 1
    wpos = slots.progress + stride
    nxt = _sample(logits)
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
                             progress, active)


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


class ServingEngine:
    """Fixed-shape continuous-batching engine over a ``Model``.

    >>> eng = ServingEngine(model, params, batch=4, max_len=128,
    ...                     cache=CacheConfig(layout="paged"),
    ...                     config=EngineConfig(prefill_chunk=16))
    >>> rid = eng.submit([3, 17, 5], max_new_tokens=16)
    >>> outs = eng.run()          # {rid: np.ndarray of generated tokens}

    The engine runs on ``model.device``.  ``cache``/``config`` take the
    typed configuration; fields the port does not serve yet raise in
    their constructors.  The port has no host tier: a paged pool smaller
    than the worst case needs ``host_spill=False`` (requests then wait in
    the queue until pages are released, as the JAX engine's do without a
    host tier).
    """

    def __init__(self, model: "Model", params, *, batch: int, max_len: int,
                 cache: Optional[CacheConfig] = None,
                 config: Optional[EngineConfig] = None) -> None:
        self.cache = cache if cache is not None else CacheConfig()
        self.config = config if config is not None else EngineConfig()
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
        self.page_size = self.cache.page_size
        self.queue = RequestQueue(max_len=max_len)
        self._mstate = model.init_decode_state(batch, max_len,
                                               per_row_pos=True,
                                               cache=self.cache)
        # attention-free families have no pages whatever the layout
        self._paged = "block_table" in self._mstate
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
            worst = batch * -(-max_len // self.page_size)
            if self.cache.host_spill is None and self.n_pages < worst:
                # the JAX engine defaults to a host tier here and preempts
                # into it; the port must not serve a different schedule
                raise NotImplementedError(
                    f"a pool of {self.n_pages} pages < the worst case "
                    f"{worst} preempts into the host tier, which comes with "
                    f"{PRESSURE}; pass CacheConfig(host_spill=False) to "
                    "queue requests until pages are released instead"
                )
        self._slots = init_slots(batch, max_len, self.device)
        # host mirror: which request occupies each row (None = free), how
        # far it has been fed, and its worst-case page reservation
        self._slot_req: List[Optional[Request]] = [None] * batch
        self._row_progress: List[int] = [0] * batch
        self._row_pages: List[int] = [0] * batch
        self._pages_reserved = 0
        self._crossed: List[int] = []   # first token produced, not yet read
        self.outputs: Dict[int, np.ndarray] = {}
        self.steps = 0            # decode steps executed (all rows per step)
        self.prefill_steps = 0    # chunked-prefill steps executed
        self.generated = 0        # tokens returned to callers
        self.prompt_tokens = 0    # prompt tokens fed (host arithmetic)
        self.peak_pages_in_use = 0
        self.seconds = 0.0        # wall time inside the cycle's phases
        self.ttft: Dict[int, float] = {}        # req_id -> seconds
        self._t_submit: Dict[int, float] = {}

    # -- request intake ------------------------------------------------------

    def submit(self, tokens, max_new_tokens: int) -> int:
        """Queue a request; returns its id.  Under the paged layout a
        request that could never reserve its pages is rejected now."""
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
        rid = self.queue.submit(tokens, max_new_tokens)
        self._t_submit[rid] = time.perf_counter()
        return rid

    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self._slot_req)

    # -- the phases of a cycle -------------------------------------------------

    @_timed
    def admit(self) -> int:
        """Admit queued requests into free rows: one masked write of the
        slot state and a reset of those rows' caches.  Paged, the queue
        head is admitted only while its worst-case pages fit the pool's
        unreserved remainder; admission stops at the first head that does
        not fit (first in, first out)."""
        free = [b for b, r in enumerate(self._slot_req) if r is None]
        if not free or not self.queue:
            return 0
        new_tokens = np.zeros((self.batch, self.max_len), np.int64)
        new_plen = np.ones((self.batch,), np.int64)
        new_total = np.ones((self.batch,), np.int64)
        mask = np.zeros((self.batch,), bool)
        n = 0
        for b in free:
            req = self.queue.peek()
            if req is None:
                break
            need = (pages_needed(req.total_len, self.page_size)
                    if self._paged else 0)
            if self._paged and self._pages_reserved + need > self.n_pages:
                break
            self.queue.pop()
            self._slot_req[b] = req
            self._row_progress[b] = 0
            self._row_pages[b] = need
            self._pages_reserved += need
            new_tokens[b, : req.prompt_len] = req.tokens
            new_plen[b] = req.prompt_len
            new_total[b] = req.total_len
            mask[b] = True
            n += 1
        if n == 0:
            return 0
        dev = self.device
        m = torch.as_tensor(mask, device=dev)
        self._mstate = self.model.reset_decode_rows(self._mstate, m)
        s = self._slots
        self._slots = SlotState(
            tokens=torch.where(m[:, None], torch.as_tensor(new_tokens,
                                                           device=dev),
                               s.tokens),
            prompt_len=torch.where(m, torch.as_tensor(new_plen, device=dev),
                                   s.prompt_len),
            total_len=torch.where(m, torch.as_tensor(new_total, device=dev),
                                  s.total_len),
            progress=torch.where(m, 0, s.progress),
            active=s.active | m,
        )
        return n

    @_timed
    def prefill(self) -> int:
        """Chunked-prefill steps while some row has >= 2 prompt tokens
        left — no host sync; the mirror knows every row's chunk width.
        Decode-phase rows ride along one token per step.  Returns the
        number of steps (0 when ``prefill_chunk == 1``)."""
        if self.prefill_chunk == 1:
            return 0
        n = 0
        while self._prompt_phase_rows():
            widths = [
                max(1, min(self.prefill_chunk,
                           req.prompt_len - self._row_progress[b]))
                if req is not None else 1
                for b, req in enumerate(self._slot_req)
            ]
            self._mstate, self._slots = engine_step(
                self.model, self.params, self._mstate, self._slots,
                chunk=self.prefill_chunk,
            )
            self.prefill_steps += 1
            self._advance_mirror(widths)
            n += 1
        return n

    @_timed
    def decode(self) -> None:
        """``steps_per_sync`` engine steps back to back — no host sync."""
        for _ in range(self.steps_per_sync):
            self._mstate, self._slots = engine_step(
                self.model, self.params, self._mstate, self._slots
            )
        self.steps += self.steps_per_sync
        self._advance_mirror([self.steps_per_sync] * self.batch)

    @_timed
    def harvest(self) -> int:
        """The one device->host readback of the cycle: collect finished
        rows' tokens, stamp first-token latencies, read the pool's free
        count (peak pages in use) and, paged, release the finished rows'
        pages.  Returns the number of requests completed."""
        s = self._slots
        parts = [s.active.long(), s.tokens.reshape(-1)]
        if self._paged:
            parts.append(self._mstate["page_top"].long().reshape(1))
        got = torch.cat(parts).cpu().numpy()
        b_, n_tok = self.batch, self.batch * self.max_len
        active = got[:b_].astype(bool)
        tokens = got[b_: b_ + n_tok].reshape(b_, self.max_len).astype(
            np.int32)
        if self._paged:
            self.peak_pages_in_use = max(self.peak_pages_in_use,
                                         self.n_pages - int(got[-1]))
        now = time.perf_counter()
        for rid in self._crossed:
            t0 = self._t_submit.pop(rid, None)
            if t0 is not None:
                self.ttft.setdefault(rid, now - t0)
        self._crossed = []
        finished = 0
        release = np.zeros((self.batch,), bool)
        for b, req in enumerate(self._slot_req):
            if req is None or active[b]:
                continue
            out = tokens[b, req.prompt_len: req.total_len].copy()
            self.outputs[req.req_id] = out
            self.generated += out.size
            self._slot_req[b] = None
            self._pages_reserved -= self._row_pages[b]
            self._row_pages[b] = 0
            release[b] = True
            finished += 1
        if self._paged and release.any():
            # free on completion: the pages return to the pool now, not
            # when the row happens to be refilled
            self._mstate = self.model.reset_decode_rows(
                self._mstate, torch.as_tensor(release, device=self.device))
        return finished

    def _advance_mirror(self, widths: List[int]) -> None:
        """Replay one step's progress update on the host: row b advanced
        by ``widths[b]`` (a chunk width, or ``steps_per_sync`` for a fused
        decode call — the ``total_len - 1`` clamp absorbs the overshoot
        as the device's ``active`` mask does).  Counts prompt tokens fed
        and notes rows whose first generated token was produced (stamped
        at the next harvest, when it exists)."""
        for b, req in enumerate(self._slot_req):
            if req is None:
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

    def _prompt_phase_rows(self) -> bool:
        """True while some occupied, unfinished row still has >= 2 prompt
        tokens to feed (a single remaining prompt token is a decode
        feed)."""
        return any(
            req is not None
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
        return out
