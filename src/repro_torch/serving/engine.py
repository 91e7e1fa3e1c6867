"""Continuous-batching serving engine (the port's ``repro.serving.engine``,
contiguous KV layout, token-by-token, greedy).

The control state of every batch row lives on the device as fixed-shape
tensors (``SlotState``): the token buffer holds the prompt and then the
generated tokens, so feeding the model is one gather whether a row is in
its prompt or generating.  ``engine_step`` is one decode step for all rows
with no host interaction; a cycle (``step``) is

    admit    — queued requests enter free rows (one host->device copy),
    decode   — ``steps_per_sync`` engine steps back to back, no host sync,
    harvest  — one device->host readback; finished rows return their tokens.

The host keeps a mirror of per-row progress: a row's progress after n steps
is a pure function of its prompt and total lengths, so time-to-first-token
is known without reading the device.  ``decode`` must never synchronise
with the device; ``chip_smoke.py`` runs it under
``torch.cuda.set_sync_debug_mode("error")`` (the port of the JAX engine's
``no_transfer_audit``).

Unlike JAX's jitted steps, the port runs eagerly; the caches and the token
buffer are updated in place.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.serving.config import CacheConfig, EngineConfig
from repro_torch.serving.queue import Request, RequestQueue


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


def engine_step(model: Model, params, mstate, slots: SlotState):
    """One decode step for every row, no host interaction.

    Row b feeds ``tokens[b, progress[b]]``; the sampled token is written at
    ``progress + 1`` once that position is past the prompt.  A row is done
    after the step that produces its last token (``progress`` reaches
    ``total_len - 1``).  Inactive rows keep their lane but never advance
    and never write their caches (``active`` flows into ``decode_step``).
    """
    b, max_len = slots.tokens.shape
    feed_idx = slots.progress.clamp(0, max_len - 1)
    tok = slots.tokens.gather(1, feed_idx[:, None])[:, 0]
    logits, mstate = model.decode_step(params, mstate, tok,
                                       active=slots.active)
    wpos = slots.progress + 1
    nxt = _sample(logits)
    writes = slots.active & (wpos >= slots.prompt_len) & (wpos < max_len)
    col = wpos.clamp(max=max_len - 1)[:, None]
    tokens = slots.tokens
    tokens.scatter_(1, col, torch.where(writes[:, None], nxt[:, None],
                                        tokens.gather(1, col)))
    progress = slots.progress + slots.active.long()
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

    >>> eng = ServingEngine(model, params, batch=4, max_len=128)
    >>> rid = eng.submit([3, 17, 5], max_new_tokens=16)
    >>> outs = eng.run()          # {rid: np.ndarray of generated tokens}

    The engine runs on ``model.device``.  ``cache``/``config`` take the
    typed configuration; fields this slice does not serve raise in their
    constructors.
    """

    def __init__(self, model: Model, params, *, batch: int, max_len: int,
                 cache: Optional[CacheConfig] = None,
                 config: Optional[EngineConfig] = None) -> None:
        self.cache = cache if cache is not None else CacheConfig()
        self.config = config if config is not None else EngineConfig()
        self.model = model
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.device = model.device
        self.steps_per_sync = self.config.steps_per_sync
        self.queue = RequestQueue(max_len=max_len)
        self._mstate = model.init_decode_state(batch, max_len,
                                               per_row_pos=True)
        self._slots = init_slots(batch, max_len, self.device)
        # host mirror: which request occupies each row (None = free) and
        # how far it has been fed
        self._slot_req: List[Optional[Request]] = [None] * batch
        self._row_progress: List[int] = [0] * batch
        self._crossed: List[int] = []   # first token produced, not yet read
        self.outputs: Dict[int, np.ndarray] = {}
        self.steps = 0            # decode steps executed (all rows per step)
        self.generated = 0        # tokens returned to callers
        self.prompt_tokens = 0    # prompt tokens fed (host arithmetic)
        self.seconds = 0.0        # wall time inside admit/decode/harvest
        self.ttft: Dict[int, float] = {}        # req_id -> seconds
        self._t_submit: Dict[int, float] = {}

    # -- request intake ------------------------------------------------------

    def submit(self, tokens, max_new_tokens: int) -> int:
        """Queue a request; returns its id."""
        rid = self.queue.submit(tokens, max_new_tokens)
        self._t_submit[rid] = time.perf_counter()
        return rid

    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self._slot_req)

    # -- the three phases of a cycle ------------------------------------------

    @_timed
    def admit(self) -> int:
        """Admit queued requests into free rows: one masked write of the
        slot state and a reset of those rows' caches."""
        free = [b for b, r in enumerate(self._slot_req) if r is None]
        if not free or not self.queue:
            return 0
        new_tokens = np.zeros((self.batch, self.max_len), np.int64)
        new_plen = np.ones((self.batch,), np.int64)
        new_total = np.ones((self.batch,), np.int64)
        mask = np.zeros((self.batch,), bool)
        n = 0
        for b in free:
            if not self.queue:
                break
            req = self.queue.pop()
            self._slot_req[b] = req
            self._row_progress[b] = 0
            new_tokens[b, : req.prompt_len] = req.tokens
            new_plen[b] = req.prompt_len
            new_total[b] = req.total_len
            mask[b] = True
            n += 1
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
    def decode(self) -> None:
        """``steps_per_sync`` engine steps back to back — no host sync."""
        for _ in range(self.steps_per_sync):
            self._mstate, self._slots = engine_step(
                self.model, self.params, self._mstate, self._slots
            )
        self.steps += self.steps_per_sync
        self._advance_mirror(self.steps_per_sync)

    @_timed
    def harvest(self) -> int:
        """The one device->host readback of the cycle: collect finished
        rows' tokens and stamp first-token latencies.  Returns the number
        of requests completed."""
        s = self._slots
        got = torch.cat([s.active.long()[:, None], s.tokens], dim=1).cpu()
        active = got[:, 0].numpy().astype(bool)
        tokens = got[:, 1:].numpy().astype(np.int32)
        now = time.perf_counter()
        for rid in self._crossed:
            t0 = self._t_submit.pop(rid, None)
            if t0 is not None:
                self.ttft.setdefault(rid, now - t0)
        self._crossed = []
        finished = 0
        for b, req in enumerate(self._slot_req):
            if req is None or active[b]:
                continue
            out = tokens[b, req.prompt_len: req.total_len].copy()
            self.outputs[req.req_id] = out
            self.generated += out.size
            self._slot_req[b] = None
            finished += 1
        return finished

    def _advance_mirror(self, width: int) -> None:
        """Replay ``width`` steps of per-row progress on the host: count
        prompt tokens fed and note rows whose first generated token was
        produced (stamped at the next harvest, when it exists)."""
        for b, req in enumerate(self._slot_req):
            if req is None:
                continue
            p = self._row_progress[b]
            if p >= req.total_len - 1:
                continue
            np_ = min(p + width, req.total_len - 1)
            self.prompt_tokens += (
                min(np_, req.prompt_len) - min(p, req.prompt_len)
            )
            if p < req.prompt_len <= np_:
                self._crossed.append(req.req_id)
            self._row_progress[b] = np_

    # -- serving loop --------------------------------------------------------

    def step(self) -> int:
        """One cycle: admit, decode, harvest.  Returns the number of
        requests completed."""
        self.admit()
        if not any(r is not None for r in self._slot_req):
            return 0
        self.decode()
        return self.harvest()

    def run(self) -> Dict[int, np.ndarray]:
        """Serve until queue and slots drain; returns {req_id: generated}."""
        while self.busy():
            self.step()
        return self.outputs

    def stats(self) -> Dict[str, float]:
        ttft = list(self.ttft.values())
        return {
            "decode_steps": float(self.steps),
            "generated_tokens": float(self.generated),
            "prompt_tokens": float(self.prompt_tokens),
            "batch": float(self.batch),
            "seconds": self.seconds,
            "tok_per_s": self.generated / self.seconds if self.seconds else 0.0,
            "ms_per_step": (1e3 * self.seconds / self.steps
                            if self.steps else 0.0),
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
        }
