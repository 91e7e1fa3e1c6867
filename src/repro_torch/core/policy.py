"""Backend policy: which lowering a registered op runs.

Backends:

* ``Backend.REFERENCE`` — the plain PyTorch version; runs on any device and
  is what the kernels are held to on the card.
* ``Backend.HOPPER``    — the hand-written CUDA kernel; CUDA tensors only.
  Asking for it with a CPU tensor raises.
* ``Backend.AUTO``      — the tensor's device decides: a CUDA tensor launches
  the kernel, a CPU tensor takes the plain version.  There is no toolchain
  probe and no fallback: a CUDA tensor whose kernel cannot be built or
  launched raises.

Selection sources, in priority order:
    1. an active ``use_backend(...)`` context manager (thread-local stack),
    2. ``set_default_backend(...)`` (process-wide, shared by all threads),
    3. the ``REPRO_TORCH_BACKEND`` environment variable,
    4. AUTO.

``resolve_device`` is the device half of the policy: entry points default to
``"cuda"`` and raise when no card is present rather than run on the CPU.
"""
from __future__ import annotations

import contextlib
import enum
import os
import threading
from typing import Iterator, Optional

import torch


class Backend(enum.Enum):
    """Which lowering an op should use."""

    REFERENCE = "reference"
    HOPPER = "hopper"
    AUTO = "auto"

    @staticmethod
    def parse(name: str) -> "Backend":
        try:
            return Backend(name.strip().lower())
        except ValueError as e:
            raise ValueError(
                f"unknown backend {name!r}; expected one of "
                f"{[b.value for b in Backend]}"
            ) from e


class _PolicyState(threading.local):
    """Thread-local ``use_backend`` stack (the process default is shared)."""

    def __init__(self) -> None:
        self.stack: list[Backend] = []


_STATE = _PolicyState()
_DEFAULT: Optional[Backend] = None


def set_default_backend(backend: Backend | str | None) -> None:
    """Process-default backend (overrides env, overridden by use_backend).
    Pass ``None`` to clear."""
    global _DEFAULT
    if isinstance(backend, str):
        backend = Backend.parse(backend)
    _DEFAULT = backend


def current_backend() -> Backend:
    """The requested backend; AUTO is resolved per tensor by ``use_hopper``."""
    if _STATE.stack:
        return _STATE.stack[-1]
    if _DEFAULT is not None:
        return _DEFAULT
    return Backend.parse(os.environ.get("REPRO_TORCH_BACKEND", "auto"))


@contextlib.contextmanager
def use_backend(backend: Backend | str) -> Iterator[None]:
    """Scoped backend override."""
    if isinstance(backend, str):
        backend = Backend.parse(backend)
    _STATE.stack.append(backend)
    try:
        yield
    finally:
        _STATE.stack.pop()


def use_hopper(t: torch.Tensor) -> bool:
    """Whether an op on tensor ``t`` launches its Hopper kernel."""
    b = current_backend()
    if b is Backend.REFERENCE:
        return False
    if b is Backend.HOPPER and not t.is_cuda:
        raise RuntimeError(
            f"backend 'hopper' needs CUDA tensors; got a tensor on {t.device} "
            "(use 'reference' or 'auto' for the plain PyTorch version)"
        )
    return t.is_cuda


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Entry-point device: ``"cuda"`` unless the caller asks for the CPU.

    Raises when a CUDA device is asked for and none is present — the port
    never continues on the CPU behind the caller's back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev
