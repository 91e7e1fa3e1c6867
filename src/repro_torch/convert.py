"""Parameters from the JAX package into the port.

``params_from_jax`` takes a ``repro.models.lm.init_params`` tree whose
leaves are numpy arrays (``jax.device_get`` of the params) and returns the
port's params: the stacked leading layer axis of ``params["layers"]``
(dense, moe, ssm) is split into a list of per-layer dicts (a moe layer's
``router`` stays f32 and its ``wg``/``wi``/``wo`` keep their leading
expert axis), and the two stacked
axes of the hybrid ``params["groups"]`` (group, layer in the group) into
lists of lists; ``shared_attn`` and ``shared_mlp`` are not stacked.
numpy's bf16 is the ``ml_dtypes`` type, which torch cannot take directly,
so bf16 leaves cross as 16-bit integers and are reinterpreted as
``torch.bfloat16`` bit for bit.

``caffe_params_from_jax`` takes a ``repro.caffe`` net's params tree,
``{layer: {"w", "b"}}`` with numpy leaves, in the same layouts
(convolution ``(F, C, K, K)``, inner product ``(K, out)``), and
``caffe_state_from_jax`` a ``repro.caffe.Solver`` state (``init``'s or a
train step's: params, velocity and the int32 iteration counter).

``train_state_from_jax`` carries ``repro.launch.steps.init_train_state``'s
tree across (params, which become autograd leaves, and the optimizer's
``step`` and param-shaped f32 ``master``/``m``/``v`` or ``mom``), and
``to_jax_layout`` goes the other way for comparisons: a port tree (params,
grads, optimizer trees) as numpy in JAX's stacked layout.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.policy import resolve_device
from repro_torch.optim.optimizers import tree_leaves


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    """One numpy leaf as a torch tensor on ``device``, bits unchanged."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree, fn):
    """A tree stacked on its leading axis -> a list of ``fn(subtree)``."""
    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [fn(_map(tree, lambda a, i=i: np.asarray(a)[i]))
            for i in range(np.shape(first)[0])]


def params_from_jax(tree: Dict[str, Any], *,
                    device: str | torch.device = "cuda") -> Dict[str, Any]:
    """Dense, moe, ssm or hybrid params tree (numpy leaves) -> the port's
    params."""
    dev = resolve_device(device)
    unknown = set(tree) - {"embed", "ln_f", "lm_head", "layers", "groups",
                           "shared_attn", "shared_mlp"}
    if unknown:
        raise NotImplementedError(
            f"params_from_jax: keys {sorted(unknown)} belong to families "
            "the port does not serve yet"
        )

    def leaf(a):
        return _to_tensor(a, dev)

    out = {k: _map(v, leaf) for k, v in tree.items()
           if k not in ("layers", "groups")}
    if "layers" in tree:
        out["layers"] = _unstack(tree["layers"], lambda t: _map(t, leaf))
    if "groups" in tree:
        out["groups"] = _unstack(tree["groups"], lambda g: _unstack(
            g, lambda t: _map(t, leaf)))
    return out


def train_state_from_jax(tree: Dict[str, Any], *,
                         device: str | torch.device = "cuda"
                         ) -> Dict[str, Any]:
    """``{"params", "opt"}`` of ``repro.launch.steps.init_train_state``
    (numpy leaves) -> the port's train state (``launch.steps``): the
    params as autograd leaves, ``opt["step"]`` an int32 scalar, the
    param-shaped optimizer trees split per layer like the params."""
    params = params_from_jax(tree["params"], device=device)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = {k: (params_from_jax(v, device=device) if isinstance(v, dict)
               else _to_tensor(np.asarray(v, np.int32),
                               resolve_device(device)))
           for k, v in tree["opt"].items()}
    return {"params": params, "opt": opt}


def to_jax_layout(tree) -> Any:
    """A port tree of tensors -> numpy leaves in JAX's layout: the
    per-layer lists under ``layers`` stacked on a leading axis, the groups
    of ``groups`` on two.  bf16 leaves come out as float32 (exact)."""
    def leaf(t):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return stack([conv(v) for v in t])
        return leaf(t)

    return conv(tree)


def caffe_params_from_jax(tree: Dict[str, Dict[str, Any]], *,
                          device: str | torch.device = "cuda"
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A ``repro.caffe.Net.init`` tree (numpy leaves) -> the port's Caffe
    params on ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return {layer: {k: _to_tensor(v, dev) for k, v in p.items()}
            for layer, p in tree.items()}


def caffe_state_from_jax(state: Dict[str, Any], *,
                         device: str | torch.device = "cuda"
                         ) -> Dict[str, Any]:
    """A ``repro.caffe.Solver`` state ``{"params", "velocity", "iter"}``
    (numpy leaves) -> the port's ``Solver`` state on ``device`` (the card
    unless the caller asks for the CPU)."""
    return {"params": caffe_params_from_jax(state["params"], device=device),
            "velocity": caffe_params_from_jax(state["velocity"],
                                              device=device),
            "iter": _to_tensor(np.asarray(state["iter"], np.int32),
                               resolve_device(device)).reshape(())}
