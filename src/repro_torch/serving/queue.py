"""Host-side request queue for the serving engine (the port's copy of
``repro.serving.queue``).

Requests arrive from the outside world with ragged prompt lengths and wait
here until a batch row is free; once admitted they are fixed-shape device
state.  This slice serves them first in, first out: the JAX queue's
priority and deadline ordering, cancellation and ``max_pending``
back-pressure come with the pressure slice, together with the engine code
that acts on them.  Every accessor takes the lock, so
submits may race the engine loop from another thread.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Deque, Optional, Sequence

import numpy as np


class QueueEmpty(LookupError):
    """``pop()`` on an empty queue."""


@dataclasses.dataclass(frozen=True)
class Request:
    req_id: int
    tokens: np.ndarray        # (prompt_len,) int32
    max_new_tokens: int

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens


class RequestQueue:
    """FIFO of pending requests; thread-safe throughout."""

    def __init__(self, max_len: Optional[int] = None) -> None:
        self._q: Deque[Request] = collections.deque()
        self._next_id = 0
        self._lock = threading.Lock()
        self.max_len = max_len

    def submit(self, tokens: Sequence[int], max_new_tokens: int) -> int:
        toks = np.asarray(tokens, np.int32).reshape(-1)
        with self._lock:
            # rejections name the id the request would get; the counter
            # only advances on success
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
            self._next_id += 1
            self._q.append(Request(rid, toks, int(max_new_tokens)))
        return rid

    def peek(self) -> Optional[Request]:
        """The next request ``pop`` would return, or None."""
        with self._lock:
            return self._q[0] if self._q else None

    def peek_next_id(self) -> int:
        """The id the next successful ``submit`` will assign."""
        with self._lock:
            return self._next_id

    def pop(self) -> Request:
        with self._lock:
            if not self._q:
                raise QueueEmpty("pop() on an empty RequestQueue")
            return self._q.popleft()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def __bool__(self) -> bool:
        with self._lock:
            return len(self._q) > 0
