"""Host-side request queue for the serving engine (the port's copy of
``repro.serving.queue``).

Requests arrive from the outside world with ragged prompt lengths and wait
here until a batch row is free; once admitted they are fixed-shape device
state.  The queue is kept sorted by ``(priority desc, deadline budget asc,
arrival asc)``: a higher ``priority`` is always admitted first, within a
priority a tighter ``deadline_ms`` budget goes first, and ties fall back to
arrival order (``req_id`` is monotonic), so the default ``priority=0,
deadline_ms=None`` workload is exactly first in, first out.  The budget,
not an absolute instant, keys the sort, so the order is deterministic; the
engine keeps the absolute expiry (submit time + ``deadline_ms``) and
enforces it.

Every accessor takes the lock, so submits and cancels may race the engine
loop from another thread.  ``cancel(req_id)`` removes a still-queued
request; a request already admitted to a row cancels through the engine's
harvest drain instead.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np


class QueueEmpty(LookupError):
    """``pop()`` on an empty queue (typed so callers can distinguish a
    drained queue from a genuine indexing bug)."""


class QueueFullError(RuntimeError):
    """``submit()`` against a queue at ``max_pending`` capacity —
    backpressure, not a bug; callers should retry or shed load."""


@dataclasses.dataclass(frozen=True)
class Request:
    req_id: int
    tokens: np.ndarray        # (prompt_len,) int32
    max_new_tokens: int
    priority: int = 0         # larger = more important (default 0)
    deadline_ms: Optional[float] = None   # budget from submit; None: none

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens

    @classmethod
    def spec(cls, tokens: Sequence[int], max_new_tokens: int, *,
             priority: int = 0,
             deadline_ms: Optional[float] = None) -> "Request":
        """Build an unsubmitted request spec for ``ServingEngine.submit``
        (``req_id`` is a sentinel — the queue assigns the real id at
        submission; passing a spec to ``queue.submit`` is not supported,
        only the engine unpacks it)."""
        return cls(
            req_id=-1,
            tokens=np.asarray(tokens, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens),
            priority=int(priority),
            deadline_ms=deadline_ms,
        )


def _sort_key(req: Request) -> Tuple[int, float, int]:
    return (
        -req.priority,
        req.deadline_ms if req.deadline_ms is not None else math.inf,
        req.req_id,
    )


class RequestQueue:
    """Priority/deadline-ordered pending requests; thread-safe throughout
    (serving workers submit/cancel concurrently with the engine loop)."""

    def __init__(self, max_len: Optional[int] = None,
                 max_pending: Optional[int] = None) -> None:
        self._q: List[Request] = []
        self._keys: List[Tuple[int, float, int]] = []   # parallel sort keys
        self._next_id = 0
        self._lock = threading.Lock()
        self.max_len = max_len
        self.max_pending = max_pending

    def submit(
        self, tokens: Sequence[int], max_new_tokens: int, *,
        priority: int = 0, deadline_ms: Optional[float] = None,
    ) -> int:
        toks = np.asarray(tokens, np.int32).reshape(-1)
        with self._lock:
            # every rejection names the id the request *would* get, but the
            # counter only advances on success: a rejected submit has no
            # side effect and the live id space stays dense
            rid = self._next_id
            if toks.size == 0:
                raise ValueError(f"request {rid}: empty prompt")
            if max_new_tokens < 1:
                raise ValueError(
                    f"request {rid}: max_new_tokens must be >= 1"
                )
            if (self.max_len is not None
                    and toks.size + max_new_tokens > self.max_len):
                raise ValueError(
                    f"request {rid}: needs {toks.size + max_new_tokens} "
                    f"slots > engine max_len {self.max_len}"
                )
            if (self.max_pending is not None
                    and len(self._q) >= self.max_pending):
                raise QueueFullError(
                    f"request {rid}: queue full ({len(self._q)} pending >= "
                    f"max_pending {self.max_pending})"
                )
            self._next_id += 1
            req = Request(rid, toks, int(max_new_tokens), int(priority),
                          deadline_ms)
            key = _sort_key(req)
            i = bisect.bisect_right(self._keys, key)
            self._keys.insert(i, key)
            self._q.insert(i, req)
        return rid

    def peek(self) -> Optional[Request]:
        """Head of the queue without removing it (admission-control look:
        the engine checks page availability *before* committing a pop)."""
        with self._lock:
            return self._q[0] if self._q else None

    def pop(self) -> Request:
        with self._lock:
            if not self._q:
                raise QueueEmpty("pop() on an empty RequestQueue")
            self._keys.pop(0)
            return self._q.pop(0)

    def cancel(self, req_id: int) -> Optional[Request]:
        """Remove a still-queued request; returns it, or None if the id is
        not in the queue (already admitted, finished, or unknown)."""
        with self._lock:
            for i, req in enumerate(self._q):
                if req.req_id == req_id:
                    self._keys.pop(i)
                    return self._q.pop(i)
        return None

    def pending_ids(self) -> List[int]:
        """Snapshot of queued request ids (deadline sweeps)."""
        with self._lock:
            return [r.req_id for r in self._q]

    def peek_next_id(self) -> int:
        """The id the next ``submit`` will be assigned (error context for
        pre-queue validation in the engine)."""
        with self._lock:
            return self._next_id

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def __bool__(self) -> bool:
        with self._lock:
            return len(self._q) > 0
