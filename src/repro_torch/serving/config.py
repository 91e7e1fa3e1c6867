"""Typed serving configuration (the port's ``repro.serving.config``).

``CacheConfig`` shapes the decode state and ``EngineConfig`` drives the
loop, with the JAX package's field names, defaults and ``ValueError``s.
The port serves both KV layouts (the contiguous slab and the paged pool,
any page size and pool size), the paged pool's storage precisions
(``kv_dtype``), chunked prefill of any width, greedy and sampled decoding
(``seed``, ``temperature``, ``top_k``), prefix sharing with its
recurrent-state snapshots, and serving under pressure: the host tier
behind preemption (``host_spill``) and prefill budgets
(``prefill_budget``).  Speculative decoding (``spec``) is the one field
it does not serve yet: it raises ``NotImplementedError`` naming the slice
that brings it, and is never silently ignored.  ``validate_configs``
holds the checks that span both objects and ``configs_from_flags`` builds
both from a CLI's flags, as the JAX package's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

# the slice of the port that serves speculation (ROADMAP.md, Queue 1)
SPEC = "the speculative-decoding slice"


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
    fields belong to the paged layout; ``host_spill`` adds the host tier
    behind preemption (``None`` lets the engine default it to "paged
    layout only", ``False`` queues requests and never preempts).
    ``kv_dtype`` is the paged pool's storage:
    ``"f32"`` the model's own dtype, ``"bf16"`` half-width pages read by
    the same kernels (which upcast K/V to f32), ``"int8"`` pages with f32
    per-(page, head) scales, dequantized inside the attention kernels.
    ``snapshots`` adds the recurrent families' page-boundary state
    snapshots (paged layout; prefix sharing implies it)."""

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


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-loop behaviour: ``steps_per_sync`` fused decode steps per
    harvest sync, ``prefill_chunk`` prompt tokens per row per prefill
    step, ``prefix_sharing`` page-level prompt sharing (paged layout only,
    checked in ``validate_configs``), ``seed`` / ``temperature`` /
    ``top_k`` per-request sampling (0.0 = greedy), ``prefill_budget``
    the chunked-prefill steps a cycle may run (0 = unbounded).
    Speculation comes with a later slice."""

    steps_per_sync: int = 8
    prefill_chunk: int = 1
    prefix_sharing: bool = False
    prefill_budget: int = 0
    seed: int = 0
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
        _unserved(self, "spec", (None,), SPEC)


def validate_configs(cache: CacheConfig, config: EngineConfig) -> None:
    """Checks that span both objects, with the JAX package's messages
    (its speculation checks come with the speculative-decoding slice,
    which ``EngineConfig`` refuses until then)."""
    if config.prefix_sharing and cache.layout != "paged":
        raise ValueError(
            "prefix sharing needs layout='paged' — pages are the "
            "sharing unit (the contiguous slab has per-row storage)"
        )


def configs_from_flags(args):
    """``(CacheConfig, EngineConfig)`` from an argparse namespace, as the
    JAX package's ``configs_from_flags``: a flag the driver does not
    declare takes the config's default, so ``host_spill`` stays None and
    a pool below the worst case (``--n-pages``) preempts into the host
    tier, as in JAX."""
    cache = CacheConfig(
        layout=getattr(args, "layout", "contiguous"),
        page_size=int(getattr(args, "page_size", 16)),
        n_pages=getattr(args, "n_pages", None),
        snapshots=bool(getattr(args, "snapshots", False)),
        host_spill=getattr(args, "host_spill", None),
        kv_dtype=getattr(args, "kv_dtype", "f32"),
    )
    config = EngineConfig(
        steps_per_sync=int(getattr(args, "steps_per_sync", 8)),
        prefill_chunk=int(getattr(args, "prefill_chunk", 1)),
        prefix_sharing=bool(getattr(args, "prefix_sharing", False)),
        prefill_budget=int(getattr(args, "prefill_budget", 0)),
        seed=int(getattr(args, "seed", 0)),
        temperature=float(getattr(args, "temperature", 0.0)),
        top_k=int(getattr(args, "top_k", 0)),
    )
    validate_configs(cache, config)
    return cache, config
