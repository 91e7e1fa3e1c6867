"""Parameters from the JAX package into the port.

``params_from_jax`` takes a ``repro.models.lm.init_params`` or
``repro.models.encdec.init_params`` tree whose leaves are numpy arrays
(``jax.device_get`` of the params) and returns the port's params: the
stacked leading layer axis of ``params["layers"]`` (dense, moe, ssm),
``params["enc_layers"]``/``params["dec_layers"]`` (encdec) and vlm's
``params["cross"]`` is split into a list of per-layer dicts (a moe
layer's ``router`` stays f32 and its ``wg``/``wi``/``wo`` keep their
leading expert axis), and the two stacked axes of ``params["groups"]``
(group, layer in the group: hybrid's Mamba layers, vlm's dense ones)
into lists of lists; ``shared_attn``, ``shared_mlp`` and ``ln_enc`` are
not stacked.
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
grads, optimizer trees) as numpy in JAX's stacked layout.  Its rule, a
per-layer list is a leading axis (``groups``' lists of lists two), is
``stacked_view``'s, which ``distributed.checkpoint`` also reads and
writes by (``stacked_leaves``: each JAX leaf's path and per-layer parts).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.policy import resolve_device
from repro_torch.optim.optimizers import tree_leaves


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    """One numpy leaf as a torch tensor on ``device``, bits and shape
    unchanged (a 0-d leaf, such as vlm's cross ``gate``, stays 0-d)."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


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
    """A params tree of any family (numpy leaves) -> the port's params."""
    dev = resolve_device(device)
    stacked = ("layers", "enc_layers", "dec_layers", "cross")
    unknown = set(tree) - {"embed", "ln_f", "lm_head", "groups",
                           "shared_attn", "shared_mlp", "ln_enc", *stacked}
    if unknown:
        raise NotImplementedError(
            f"params_from_jax: keys {sorted(unknown)} belong to none of the "
            "families the port serves"
        )

    def leaf(a):
        return _to_tensor(a, dev)

    out = {k: _map(v, leaf) for k, v in tree.items()
           if k not in stacked + ("groups",)}
    for key in stacked:
        if key in tree:
            out[key] = _unstack(tree[key], lambda t: _map(t, leaf))
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


def stacked_view(tree) -> Any:
    """A port tree in JAX's stacked structure, the tensors untouched: a
    list of per-layer trees becomes one tree whose leaves are lists (one
    list level a stacked axis: ``layers`` one, ``groups`` two), dicts keep
    their keys.  The inverse of ``params_from_jax``'s split; the layout
    rule of ``to_jax_layout`` and of the checkpoint format."""
    def zip_(subs):
        if subs and isinstance(subs[0], dict):
            return {k: zip_([s[k] for s in subs]) for k in subs[0]}
        return subs

    if isinstance(tree, dict):
        return {k: stacked_view(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return zip_([stacked_view(t) for t in tree])
    return tree


def stacked_leaves(tree):
    """``(path, parts)`` for each leaf of ``stacked_view(tree)`` in
    ``jax.tree.leaves`` order (dict keys sorted): ``path`` the tuple of
    keys, ``parts`` a tensor or a nested list of the per-layer tensors
    that JAX stacks into that leaf."""
    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from walk(t[k], path + (k,))
        else:
            yield path, t

    return walk(stacked_view(tree), ())


def to_jax_layout(tree) -> Any:
    """A port tree of tensors -> numpy leaves in JAX's layout
    (``stacked_view``'s lists stacked on leading axes).  bf16 leaves come
    out as float32 (exact)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, list):
            return np.stack([conv(v) for v in t])
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    return conv(stacked_view(tree))


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
