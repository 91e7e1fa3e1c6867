"""Typed serving configuration (the port's ``repro.serving.config``).

``CacheConfig`` shapes the decode state and ``EngineConfig`` drives the
loop, with the JAX package's field names, defaults and ``ValueError``s.
The port serves both KV layouts (the contiguous slab and the paged pool,
any page size and pool size), the paged pool's storage precisions
(``kv_dtype``), chunked prefill of any width, and greedy decoding.  Every
field it does not serve yet raises ``NotImplementedError`` naming the
slice that brings it; none is silently ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

# the slices of the port that serve each feature (ROADMAP.md, Queue 1)
SHARING = "the prefix-sharing slice (with recurrent-state snapshots)"
PRESSURE = "the pressure slice (host spill tier, prefill budgets)"
SPEC = "the speculative-decoding slice"
SAMPLING = "a later slice (sampling)"


def _unserved(obj: Any, field: str, served, slice_name: str) -> None:
    value = getattr(obj, field)
    if value not in served:
        raise NotImplementedError(
            f"{type(obj).__name__}.{field}={value!r} is not served by this "
            f"slice of the port; it comes with {slice_name}"
        )


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Decode-cache shape: what ``init_decode_state`` allocates.  The page
    fields belong to the paged layout; ``host_spill=None`` means "no host
    tier" here (the engine refuses a pool so small that the JAX engine
    would preempt into one).  ``kv_dtype`` is the paged pool's storage:
    ``"f32"`` the model's own dtype, ``"bf16"`` half-width pages read by
    the same kernels (which upcast K/V to f32), ``"int8"`` pages with f32
    per-(page, head) scales, dequantized inside the attention kernels."""

    layout: str = "contiguous"
    page_size: int = 16
    n_pages: Optional[int] = None
    snapshots: bool = False
    host_spill: Optional[bool] = None
    kv_dtype: str = "f32"

    def __post_init__(self) -> None:
        if self.layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown KV-cache layout {self.layout!r}")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.n_pages is not None and self.n_pages < 1:
            raise ValueError("n_pages must be >= 1 (None = worst case)")
        if self.snapshots and self.layout != "paged":
            raise ValueError(
                "recurrent-state snapshots use page-boundary granularity — "
                "layout='paged' required"
            )
        if self.kv_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(
                f"unknown kv_dtype {self.kv_dtype!r} "
                "(expected 'f32', 'bf16', or 'int8')"
            )
        if self.kv_dtype != "f32" and self.layout != "paged":
            raise ValueError(
                "sub-f32 KV storage is a paged-pool feature (quantized "
                "scales are per page) — layout='paged' required for "
                f"kv_dtype={self.kv_dtype!r}"
            )
        _unserved(self, "snapshots", (False,), SHARING)
        _unserved(self, "host_spill", (None, False), PRESSURE)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-loop behaviour: ``steps_per_sync`` fused decode steps per
    harvest sync, ``prefill_chunk`` prompt tokens per row per prefill
    step.  Prefix sharing, prefill budgets, sampling and speculation come
    with later slices."""

    steps_per_sync: int = 8
    prefill_chunk: int = 1
    prefix_sharing: bool = False
    prefill_budget: int = 0
    temperature: float = 0.0
    top_k: int = 0
    spec: Optional[Any] = None

    def __post_init__(self) -> None:
        if self.steps_per_sync < 1:
            raise ValueError("steps_per_sync must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.prefill_budget < 0:
            raise ValueError("prefill_budget must be >= 0 (0 = unbounded)")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 = full vocab)")
        _unserved(self, "prefill_budget", (0,), PRESSURE)
        _unserved(self, "prefix_sharing", (False,), SHARING)
        _unserved(self, "temperature", (0.0,), SAMPLING)
        _unserved(self, "top_k", (0,), SAMPLING)
        _unserved(self, "spec", (None,), SPEC)
