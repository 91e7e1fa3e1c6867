"""Optimizers — AdamW and SGD with momentum over the port's param trees
(``repro.optim.optimizers``).

The mixed-precision convention is JAX's: params (and their grads) in the
model's dtype, f32 master weights and moments in the optimizer, the grads
cast to f32 and clipped by their global norm, the new master cast back.
JAX returns new trees; here the update is in place under
``torch.no_grad``: master, moments and then the param tensors themselves
are written, so every leaf keeps its identity (autograd's leaves, the
caller's references).  The f32 cast of the grads is taken leaf by leaf, so
no f32 copy of the whole grad tree is ever held.  The schedule, the norm
and the clip scale stay f32 tensors on the device: the update reads
nothing back to the host.

Trees are the port's params: dicts (walked in sorted key order, as
``jax.tree.leaves`` walks them) of tensors and lists of trees.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree: dicts in sorted key order, lists in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the trees ``rest`` of
    the same structure), rebuilt in that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *subs) for subs in zip(tree, *rest)]
    return fn(tree, *rest)


def tree_unflatten(tree, leaves: List[Any]):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``tree``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(sub) for sub in t]
        return next(it)

    return build(tree)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in f32 on the
    step's device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (each leaf cast on
    its own)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_scale(grads, max_norm: float):
    """(the factor ``min(1, max_norm / (norm + 1e-6))``, the norm), both
    f32 tensors on the device (``clip_by_global_norm`` without the scaled
    tree: the update scales each leaf as it casts it)."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0), norm


def init_opt_state(cfg: OptConfig, params) -> Dict[str, Any]:
    """``step`` (int32, on the params' device), the f32 ``master`` copy
    and zero f32 moments: ``m`` and ``v`` (adamw) or ``mom`` (sgd)."""
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "master": tree_map(lambda p: p.detach().float().clone(),
                                params)}
    if cfg.name == "adamw":
        state["m"] = tree_map(zeros, params)
        state["v"] = tree_map(zeros, params)
    elif cfg.name == "sgd":
        state["mom"] = tree_map(zeros, params)
    else:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    return state


@torch.no_grad()
def apply_updates(cfg: OptConfig, grads, opt_state, params):
    """One optimizer step, in place: ``opt_state`` and ``params`` are
    updated and returned (``repro.optim.optimizers.apply_updates``, the
    same operations in the same order per leaf).  ``grads`` has the params'
    structure, in any dtype; it is cast to f32 one leaf at a time."""
    step = opt_state["step"].add_(1)
    lr = schedule(cfg, step)
    scale, _ = clip_scale(grads, cfg.grad_clip)
    sf = step.to(torch.float32)
    p_l, g_l = tree_leaves(params), tree_leaves(grads)
    w_l = tree_leaves(opt_state["master"])
    if cfg.name == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        c1 = 1 - torch.pow(b1, sf)
        c2 = 1 - torch.pow(b2, sf)
        for p, g, w, m, v in zip(p_l, g_l, w_l, tree_leaves(opt_state["m"]),
                                 tree_leaves(opt_state["v"])):
            g = g.float() * scale
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * (1 - b2) * g)
            u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            w.sub_(lr * (u + cfg.weight_decay * w))
            p.copy_(w)
    else:
        for p, g, w, mom in zip(p_l, g_l, w_l,
                                tree_leaves(opt_state["mom"])):
            g = g.float() * scale
            mom.mul_(cfg.momentum).add_(g).add_(cfg.weight_decay * w)
            w.sub_(lr * mom)
            p.copy_(w)
    return params, opt_state
