"""Serving-side fault injection (the port's copy of
``repro.serving.faults``).

A ``FaultPlan`` is a deterministic script of adverse events keyed by the
engine's *harvest-cycle* index (one ``ServingEngine.step()`` call = one
cycle — the only host-visible clock the engine has, so every injection
lands at a sanctioned host/device sync point and never adds a device
sync of its own).  The engine applies the cycle's events at the top of
``admit()``, the first phase of ``step()``, before admission, so an
event's consequences (a preemption under a shrunken pool, a drain at the
following harvest) flow through the *normal* scheduler paths — the
harness proves the production code survives, it does not grow a
parallel code path.

Event kinds:

  ``exhaust_pool``  hold ``pages`` device pages hostage (the engine's
                    reservation ledger sees a pool smaller by that much
                    — a deterministic stand-in for a burst of long
                    requests).  Admission stalls or preempts exactly as
                    it would under real pressure.
  ``release_pool``  release the hostage pages (ends the pressure
                    window).
  ``cancel``        ``engine.cancel(req_id)`` at the chosen cycle —
                    cancel-at-step-k without racing the engine loop.
  ``deadline``      force request ``req_id``'s absolute deadline to
                    ``deadline_ms`` after the event fires (0 = expire at
                    the very next harvest) — a deadline storm is several
                    of these on one cycle.
  ``poison``        mark the row serving ``req_id`` poisoned: its output
                    is declared garbage and the row is drained at the
                    next harvest through the release path, surrendering
                    pages/slots like any cancel (models a corrupted row
                    that must be evicted without wedging the batch).

Determinism contract: the same plan against the same engine config and
submission sequence injects at the same cycles, so failure scenarios are
replayable in CI — assertions about survivor token-identity and page
conservation are exact, not statistical.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

_KINDS = ("exhaust_pool", "release_pool", "cancel", "deadline", "poison")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted event at harvest cycle ``cycle`` (0-based)."""

    cycle: int
    kind: str                       # one of _KINDS
    req_id: Optional[int] = None    # cancel / deadline / poison target
    pages: int = 0                  # exhaust_pool: pages to hold hostage
    deadline_ms: float = 0.0        # deadline: expiry this long after firing

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"FaultEvent: unknown kind {self.kind!r} (one of {_KINDS})"
            )
        if (self.kind in ("cancel", "deadline", "poison")
                and self.req_id is None):
            raise ValueError(f"FaultEvent({self.kind}): req_id required")
        if self.kind == "exhaust_pool" and self.pages <= 0:
            raise ValueError("FaultEvent(exhaust_pool): pages must be > 0")
        if self.cycle < 0:
            raise ValueError("FaultEvent: cycle must be >= 0")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered script of :class:`FaultEvent`s for one engine run."""

    events: Sequence[FaultEvent] = ()

    def at(self, cycle: int) -> List[FaultEvent]:
        """Events firing at the given harvest cycle, in plan order."""
        return [e for e in self.events if e.cycle == cycle]

    @property
    def last_cycle(self) -> int:
        return max((e.cycle for e in self.events), default=-1)

    def describe(self) -> str:
        return "; ".join(
            f"@{e.cycle} {e.kind}"
            + (f" req={e.req_id}" if e.req_id is not None else "")
            + (f" pages={e.pages}" if e.kind == "exhaust_pool" else "")
            for e in sorted(self.events, key=lambda e: (e.cycle, e.kind))
        ) or "(empty plan)"
