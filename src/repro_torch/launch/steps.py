"""Train-step constructors: the train step (``repro.launch.steps``'s
``make_train_step`` and ``init_train_state``).

One device: JAX's sharding hints have nothing to do here.  The
manual-data-parallel step with compressed gradients
(``make_manual_dp_train_step``, ``repro.optim.compress``) is multi-device
and comes with the distributed slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, lm
from repro_torch.models.model import build_model, check_family
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
