"""Device meshes over ``torch.distributed`` (``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and starts no process group.  A mesh needs a process group; when
none exists, ``make_mesh_for`` starts the single-rank one itself, over an
in-process store (no rendezvous, no network): NCCL on the card (the
default), gloo with ``device="cpu"``.  A multi-rank run starts its group
before it builds a mesh, and a mesh then spans all of its ranks.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.policy import resolve_device


def ensure_process_group(device: str | torch.device = "cuda") -> int:
    """The world size, after starting the single-rank group (NCCL on
    ``cuda``, gloo on ``cpu``) when no group exists."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
          device: str | torch.device) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    world = ensure_process_group(device)
    if world != n:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs {n} ranks; the "
            f"process group has {world}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> DeviceMesh:
    """16x16 single pod (256 ranks) or 2x16x16 (2 pods, 512 ranks); raises
    unless the process group has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(
            f"the production mesh {'x'.join(map(str, shape))} needs {n} "
            f"ranks; this process group has {world}")
    return _mesh(shape, axes, device)


def make_mesh_for(n_devices: int, model_parallel: int = 1, *,
                  device: str | torch.device = "cuda") -> DeviceMesh:
    """Elastic ("data", "model") mesh for whatever devices survive
    (fault-tolerant restart); ``n_devices`` must be the group's size."""
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices do not split into model "
                         f"parallel groups of {model_parallel}")
    return _mesh((n_devices // model_parallel, model_parallel),
                 ("data", "model"), device)


def data_axes_of(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axes_of(mesh: DeviceMesh) -> Tuple[str, ...]:
    return ("model",) if "model" in mesh.mesh_dim_names else ()
