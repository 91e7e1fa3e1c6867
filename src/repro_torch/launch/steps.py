"""Train-step constructors (``repro.launch.steps``): ``make_train_step``,
``init_train_state`` and ``make_manual_dp_train_step``, the
data-parallel step whose gradient all-reduce is explicit and optionally
compressed (``optim.compress``) over a ``torch.distributed`` mesh.

JAX's sharding hints have nothing to do on one device; the manual-DP
step's collectives run at any world size, a single rank included.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, lm
from repro_torch.models.model import build_model, check_family
from repro_torch.optim import compress as GC
from repro_torch.optim.optimizers import (
    OptConfig,
    apply_updates,
    init_opt_state,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def loss_and_grads(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor]):
    """(loss, grads) of the family's ``train_loss`` —
    ``jax.value_and_grad`` of it: the grads are a new tree of the params'
    structure, in the params' dtypes (a param the loss does not reach gets
    zeros)."""
    loss = (encdec if cfg.family == "encdec" else lm).train_loss(
        cfg, params, batch)
    grads = torch.autograd.grad(loss, tree_leaves(params),
                                materialize_grads=True)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(cfg: ArchConfig, opt: OptConfig, *,
                    microbatches: int = 1) -> Callable:
    """``train_step(state, batch) -> (state, loss)``; ``state`` is
    ``{"params", "opt"}`` (``init_train_state``) and is updated in place.
    ``microbatches > 1`` accumulates the loss and the grads in f32 over
    batch slices, as the ``lax.scan`` of ``repro.launch.steps`` does,
    which divides the activations held at once by the microbatch count.
    A vlm batch carries ``vision``, an encdec batch ``frames``, split
    with the tokens."""
    check_family(cfg)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        if microbatches == 1:
            loss, grads = loss_and_grads(cfg, params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"{microbatches} microbatches")
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for mb in range(microbatches):
                part = {k: v.reshape(microbatches, b // microbatches,
                                     *v.shape[1:])[mb]
                        for k, v in batch.items()}
                loss_i, g_i = loss_and_grads(cfg, params, part)
                loss = loss + loss_i
                for acc, g in zip(tree_leaves(grads), tree_leaves(g_i)):
                    acc.add_(g)
                del g_i
            loss = loss / microbatches
            for acc in tree_leaves(grads):
                acc.div_(microbatches)
        apply_updates(opt, grads, state["opt"], params)
        return state, loss

    return train_step


def init_train_state(cfg: ArchConfig, opt: OptConfig, seed: int = 0, *,
                     device: str | torch.device = "cuda") -> Dict[str, Any]:
    """Random params from ``seed`` (``Model.init_params``), made autograd
    leaves, and the optimizer state: ``{"params", "opt"}``."""
    model = build_model(cfg, device)
    params = model.init_params(seed)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(opt, params)}


def make_manual_dp_train_step(cfg: ArchConfig, opt: OptConfig, mesh,
                              codec: str = "bf16") -> Callable:
    """Pure data-parallel ``train_step(state, batch) -> (state, loss)``
    over ``mesh`` (a ``DeviceMesh``, ``launch.mesh``), in place like
    ``make_train_step``; each rank passes its own slice of the batch.
    Params replicated; the f32 grads are all-reduced over the mesh's first
    axis with wire compression and error feedback (``state["opt"]["ef"]``,
    ``optim.compress.init_error_feedback``), averaged over any further
    axis, then the optimizer updates every leaf but ``ef``, which takes
    the new residuals; the loss is averaged over every axis."""
    check_family(cfg)
    axes = mesh.mesh_dim_names

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params, opt_state = state["params"], state["opt"]
        loss, grads = loss_and_grads(cfg, params, batch)
        grads = tree_map(lambda g: g.float(), grads)
        red, new_ef = GC.psum_compressed(
            grads, opt_state["ef"], mesh.get_group(axes[0]), codec)
        del grads
        for i, a in enumerate(axes[1:], 1):
            for g in tree_leaves(red):
                GC.all_reduce_(g, mesh.get_group(a)).div_(mesh.size(i))
        apply_updates(opt, red, {k: v for k, v in opt_state.items()
                                 if k != "ef"}, params)
        opt_state["ef"] = new_ef
        for i, a in enumerate(axes):
            loss = GC.all_reduce_(loss, mesh.get_group(a)) / mesh.size(i)
        return state, loss

    return step
