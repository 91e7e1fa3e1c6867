"""Op registry — one canonical name, two lowerings (reference / hopper).

Mirrors ``repro.core.registry``: each op is registered once with its plain
PyTorch version and, once ported, its Hopper kernel wrapper (same
signature).  ``dispatch(name, t)`` returns the callable the policy selects
for tensor ``t``; ``coverage()`` reports, per op, which lowerings exist, so
the port's progress against the JAX op surface is computed, not remembered.

Kernels use fixed tile sizes for now; the JAX registry's tuning table has
no counterpart yet.  The first knob the port's tuning layer (ROADMAP
Queue 1 item 16) will take is ``conv2d_direct``'s filter tile (``kFT`` =
32 in ``kernels/csrc/conv_direct.cu``), which JAX reads from
``get_tuning("conv_direct", ..., ft=128)``; ``kernels/gemm.py:
SKINNY_MAX_M``, set from a measured crossover, is another.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core.policy import use_hopper


@dataclasses.dataclass
class OpEntry:
    name: str
    reference: Callable[..., Any]
    hopper: Optional[Callable[..., Any]] = None
    doc: str = ""

    def resolve(self, hopper: bool) -> Callable[..., Any]:
        if hopper:
            if self.hopper is None:
                raise NotImplementedError(
                    f"op {self.name!r} has no Hopper kernel yet"
                )
            return self.hopper
        return self.reference


_OPS: Dict[str, OpEntry] = {}


def register_op(name: str, *, reference: Callable[..., Any],
                hopper: Optional[Callable[..., Any]] = None,
                doc: str = "") -> OpEntry:
    if name in _OPS:
        raise ValueError(f"op {name!r} already registered")
    entry = OpEntry(name=name, reference=reference, hopper=hopper, doc=doc)
    _OPS[name] = entry
    return entry


def get_op(name: str) -> OpEntry:
    try:
        return _OPS[name]
    except KeyError as e:
        raise KeyError(
            f"op {name!r} not registered; known: {sorted(_OPS)}"
        ) from e


def dispatch(name: str, t: torch.Tensor) -> Callable[..., Any]:
    """Resolve op ``name`` for an op on tensor ``t`` under the policy."""
    return get_op(name).resolve(use_hopper(t))


def list_ops() -> Dict[str, OpEntry]:
    return dict(_OPS)


def coverage() -> Dict[str, Dict[str, bool]]:
    """name -> {"reference": True, "hopper": has a Hopper kernel}."""
    return {
        name: {"reference": True, "hopper": e.hopper is not None}
        for name, e in _OPS.items()
    }
