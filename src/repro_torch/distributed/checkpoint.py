"""Checkpointing — atomic, versioned, restart-safe
(``repro.distributed.checkpoint``, in its on-disk format).

A checkpoint directory is interchangeable with the JAX package's both
ways:

  * Layout: ``step_<N>/`` holds one ``.npy`` per leaf of JAX's stacked
    layout (``convert.stacked_view``: a per-layer list is a leading axis,
    ``groups`` two), named by the leaf's keys joined with ``~``
    (``opt~m~layers~attn~wq``); bf16 is stored as its ``uint16`` bits.
  * Manifest: ``manifest.json`` with ``step``, ``leaves`` (in
    ``jax.tree.leaves`` order), ``dtypes`` (``"bfloat16"`` for the bit
    views), ``mesh``, ``data_position`` (where the token stream resumes)
    and ``format: 1``.
  * Atomicity: written into ``step_<N>.tmp/`` and ``os.replace``d to
    ``step_<N>/``; a ``.tmp`` directory is never listed.
  * Retention: the ``keep`` newest checkpoints stay, older are deleted.
  * Async: ``save(..., blocking=False)`` copies every leaf to host memory
    before it returns (the train step updates its state in place right
    after), then writes on a background thread; ``wait`` joins it and
    raises what the writer raised.  A stacked leaf is written layer by
    layer into the open file, so the host holds one copy of the state.
  * Restore: into the caller's tensors in place, every leaf in its own
    dtype and on its own device (a param stays the same autograd leaf),
    with no second copy of the state on the device.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.convert import stacked_leaves
from repro_torch.optim.optimizers import tree_leaves


def leaf_name(path) -> str:
    """JAX's file name of a leaf: its keys joined with ``~``."""
    return "~".join(str(k) for k in path)


def _flat_parts(parts) -> List[torch.Tensor]:
    if isinstance(parts, list):
        return [t for p in parts for t in _flat_parts(p)]
    return [parts]


def _stack_shape(parts) -> tuple:
    """The leading (list) axes of a stacked leaf, then its tensors' shape."""
    if isinstance(parts, list):
        return (len(parts),) + _stack_shape(parts[0])
    return tuple(parts.shape)


def _host_copy(parts):
    if isinstance(parts, list):
        return [_host_copy(p) for p in parts]
    return parts.detach().to("cpu", copy=True)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, bf16: bool) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")
    if bf16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _placements(shardings, target) -> List[Optional[torch.device]]:
    """The device of each leaf of ``target`` (``tree_leaves`` order), or
    None where it stays: ``shardings`` is None, a ``DeviceMesh`` (every
    leaf replicated on the mesh's device of this rank) or a tree of
    devices in ``target``'s structure."""
    n = len(tree_leaves(target))
    if shardings is None:
        return [None] * n
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(shardings, DeviceMesh):
        dev = torch.device(shardings.device_type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return [dev] * n
    devs = [torch.device(d) for d in tree_leaves(shardings)]
    if len(devs) != n:
        raise ValueError(f"shardings has {len(devs)} leaves, the target {n}")
    return devs


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # the last save's host-snapshot and write seconds and bytes written
        self.last_save: Dict[str, float] = {}

    # -- save ----------------------------------------------------------------
    def save(
        self,
        step: int,
        state: Any,
        *,
        extra: Optional[Dict[str, Any]] = None,
        blocking: bool = True,
    ) -> None:
        """Snapshot to host, then write; non-blocking writes on a thread."""
        self.wait()
        t0 = time.perf_counter()
        # every tensor copied to host memory (one on the CPU too): the
        # train step updates the state in place right after
        host = [(leaf_name(path), _host_copy(parts))
                for path, parts in stacked_leaves(state)]
        self.last_save = {"snapshot_s": time.perf_counter() - t0}
        if blocking:
            self._write(step, host, extra)
        else:
            self._thread = threading.Thread(
                target=self._write_catching, args=(step, host, extra),
                daemon=True)
            self._thread.start()

    def _write_catching(self, step, host, extra) -> None:
        try:
            self._write(step, host, extra)
        except Exception as e:  # re-raised by wait()
            self._error = e

    def _write(self, step: int, host: List[tuple], extra) -> None:
        t0 = time.perf_counter()
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        names, dtypes = [], {}
        for name, parts in host:
            flat = _flat_parts(parts)
            bf16 = flat[0].dtype == torch.bfloat16
            if isinstance(parts, list):
                first = _to_numpy(flat[0])
                out = np.lib.format.open_memmap(
                    tmp / f"{name}.npy", mode="w+", dtype=first.dtype,
                    shape=_stack_shape(parts))
                rows = out.reshape(len(flat), *first.shape)
                for i, t in enumerate(flat):
                    rows[i] = _to_numpy(t)
                out.flush()
                del out, rows
                dtype = first.dtype
            else:
                arr = _to_numpy(parts)
                np.save(tmp / f"{name}.npy", arr)
                dtype = arr.dtype
            dtypes[name] = "bfloat16" if bf16 else str(dtype)
            names.append(name)
        manifest = {
            "step": step,
            "leaves": names,
            "dtypes": dtypes,
            "mesh": extra.get("mesh") if extra else None,
            "data_position": extra.get("data_position") if extra else None,
            "format": 1,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()
        self.last_save["write_s"] = time.perf_counter() - t0
        self.last_save["bytes"] = sum(p.stat().st_size
                                      for p in final.iterdir())

    def pending(self) -> bool:
        """Whether a background write is still running."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Join the background write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict[str, Any]:
        return json.loads(
            (self.dir / f"step_{step}" / "manifest.json").read_text()
        )

    @torch.no_grad()
    def restore(self, step: int, target: Any, *, shardings: Any = None
                ) -> Any:
        """Write checkpoint ``step`` into ``target``'s tensors in place and
        return ``target``.  Every leaf is overwritten, cast to its own
        dtype, on its own device; each tensor keeps its identity (a param
        stays the same autograd leaf).  ``shardings`` (a ``DeviceMesh`` or
        a tree of devices in ``target``'s structure) first moves each leaf
        that sits elsewhere onto its device, still the same tensor object:
        the restart onto whatever devices survive."""
        for leaf, dev in zip(tree_leaves(target),
                             _placements(shardings, target)):
            if dev is not None and leaf.device != dev:
                leaf.data = torch.empty_like(leaf, device=dev)
        d = self.dir / f"step_{step}"
        dtypes = self.manifest(step).get("dtypes", {})
        for path, parts in stacked_leaves(target):
            name = leaf_name(path)
            arr = np.load(d / f"{name}.npy", mmap_mode="r")
            flat = _flat_parts(parts)
            want = _stack_shape(parts)
            if tuple(arr.shape) != want:
                raise ValueError(f"checkpoint step {step}: {name} has shape "
                                 f"{tuple(arr.shape)}, the target {want}")
            rows = arr.reshape(len(flat), *flat[0].shape)
            bf16 = dtypes.get(name) == "bfloat16"
            for i, t in enumerate(flat):
                t.copy_(_from_numpy(rows[i], bf16))
        return target
