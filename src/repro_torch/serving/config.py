"""Typed serving configuration (the port's ``repro.serving.config``).

``CacheConfig`` shapes the decode state and ``EngineConfig`` drives the
loop, with the JAX package's field names, defaults and ``ValueError``s.
The port serves every field: both KV layouts (the contiguous slab and the
paged pool, any page size and pool size), the paged pool's storage
precisions (``kv_dtype``), chunked prefill of any width, greedy and
sampled decoding (``seed``, ``temperature``, ``top_k``), prefix sharing
with its recurrent-state snapshots, serving under pressure (the host tier
behind preemption, ``host_spill``, and prefill budgets,
``prefill_budget``) and speculative decoding (``spec``, a
:class:`SpecConfig`).  ``validate_configs`` holds the checks that span
both objects, ``configs_from_flags`` builds both from a CLI's flags and
``from_kwargs`` adapts the legacy keyword pile, as the JAX package's do.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding: draft ``k`` tokens a row, verify them in one
    chunked-prefill step of width ``k + 1``, and advance each row by its
    accepted length.  ``drafter`` picks the proposals
    (``serving/drafter.py``): ``"prompt_lookup"`` matches the last
    ``ngram`` tokens against the row's own earlier tokens (any family);
    ``"hybrid_ssm"`` runs the hybrid family's Mamba layers as a draft
    model with private recurrent state.  Greedy only: every emitted token
    is the verifier's own argmax, so the streams are plain greedy
    decode's."""

    k: int = 4                       # drafted tokens per verify step
    drafter: str = "prompt_lookup"   # "prompt_lookup" | "hybrid_ssm"
    ngram: int = 2                   # prompt-lookup match length

    def __post_init__(self) -> None:
        if self.k < 1:
            raise ValueError("spec.k must be >= 1")
        if self.drafter not in ("prompt_lookup", "hybrid_ssm"):
            raise ValueError(
                f"unknown drafter {self.drafter!r} "
                "(expected 'prompt_lookup' or 'hybrid_ssm')"
            )
        if self.ngram < 1:
            raise ValueError("spec.ngram must be >= 1")


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
    the chunked-prefill steps a cycle may run (0 = unbounded), ``spec``
    draft-and-verify decoding (checked in ``validate_configs``)."""

    steps_per_sync: int = 8
    prefill_chunk: int = 1
    prefix_sharing: bool = False
    prefill_budget: int = 0
    seed: int = 0
    temperature: float = 0.0
    top_k: int = 0
    spec: Optional[SpecConfig] = None

    def __post_init__(self) -> None:
        if self.steps_per_sync < 1:
            raise ValueError("steps_per_sync must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if self.prefill_budget < 0:
            raise ValueError("prefill_budget must be >= 0 (0 = unbounded)")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 = full vocab)")


def validate_configs(cache: CacheConfig, config: EngineConfig) -> None:
    """Checks that span both objects, with the JAX package's messages."""
    if config.prefix_sharing and cache.layout != "paged":
        raise ValueError(
            "prefix sharing needs layout='paged' — pages are the "
            "sharing unit (the contiguous slab has per-row storage)"
        )
    spec = config.spec
    if spec is None:
        return
    if config.prefill_chunk < 2:
        raise ValueError(
            "speculative decoding verifies drafts through the chunked "
            "prefill path — prefill_chunk must be >= 2"
        )
    if config.temperature > 0.0:
        raise ValueError(
            "speculative decoding is greedy-only for now — temperature "
            "must be 0 (spec-sampling is a ROADMAP follow-on)"
        )
    if spec.drafter == "hybrid_ssm" and config.prefix_sharing:
        raise ValueError(
            "drafter='hybrid_ssm' is incompatible with prefix_sharing — "
            "snapshot restore rebuilds the model's recurrence, not the "
            "drafter's private state"
        )


# the legacy kwarg pile's keys, by the object they build
_CACHE_KEYS = frozenset(f.name for f in dataclasses.fields(CacheConfig))
_ENGINE_KEYS = frozenset(f.name for f in dataclasses.fields(EngineConfig))


def from_kwargs(_stacklevel: int = 2, **kwargs):
    """The legacy kwarg pile (``layout=``, ``page_size=``,
    ``prefill_chunk=``, ...) as ``(CacheConfig, EngineConfig)``, as the
    JAX package's adapter: a ``DeprecationWarning`` pointing at the
    caller (once per call site under the default filters), ``TypeError``
    on an unknown key, and no warning for an empty call.
    ``_stacklevel`` lets the engine attribute the warning to the user's
    construction site."""
    unknown = set(kwargs) - _CACHE_KEYS - _ENGINE_KEYS
    if unknown:
        raise TypeError(
            f"unknown engine kwargs {sorted(unknown)} — see "
            "repro_torch.serving.config.CacheConfig / EngineConfig"
        )
    if not kwargs:
        return CacheConfig(), EngineConfig()
    warnings.warn(
        "raw layout/engine kwargs are deprecated — pass "
        "cache=CacheConfig(...) and config=EngineConfig(...) "
        "(repro_torch.serving.config; from_kwargs adapts legacy call "
        "sites)",
        DeprecationWarning, stacklevel=_stacklevel,
    )
    return (CacheConfig(**{k: v for k, v in kwargs.items()
                           if k in _CACHE_KEYS}),
            EngineConfig(**{k: v for k, v in kwargs.items()
                            if k in _ENGINE_KEYS}))


def configs_from_flags(args):
    """``(CacheConfig, EngineConfig)`` from an argparse namespace, as the
    JAX package's ``configs_from_flags``: a flag the driver does not
    declare takes the config's default, so ``host_spill`` stays None and
    a pool below the worst case (``--n-pages``) preempts into the host
    tier, as in JAX; ``--spec-k 0`` (or absent) means no speculation."""
    spec = None
    k = int(getattr(args, "spec_k", 0) or 0)
    if k > 0:
        spec = SpecConfig(
            k=k,
            drafter=getattr(args, "spec_drafter", "prompt_lookup"),
            ngram=int(getattr(args, "spec_ngram", 2)),
        )
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
        spec=spec,
    )
    validate_configs(cache, config)
    return cache, config
