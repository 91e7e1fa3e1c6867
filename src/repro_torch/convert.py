"""Parameters from the JAX package into the port.

``params_from_jax`` takes a ``repro.models.lm.init_params`` tree whose
leaves are numpy arrays (``jax.device_get`` of the params) and returns the
port's params: the stacked leading layer axis of ``params["layers"]`` is
split into a list of per-layer dicts.  numpy's bf16 is the ``ml_dtypes``
type, which torch cannot take directly, so bf16 leaves cross as 16-bit
integers and are reinterpreted as ``torch.bfloat16`` bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.policy import resolve_device


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


def params_from_jax(tree: Dict[str, Any], *,
                    device: str | torch.device = "cuda") -> Dict[str, Any]:
    """Dense-family params tree (numpy leaves) -> the port's params."""
    dev = resolve_device(device)
    unknown = set(tree) - {"embed", "ln_f", "lm_head", "layers"}
    if unknown:
        raise NotImplementedError(
            f"params_from_jax: keys {sorted(unknown)} belong to families "
            "this slice of the port does not serve"
        )
    out = {k: _to_tensor(v, dev) for k, v in tree.items() if k != "layers"}
    first = tree["layers"]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    n_layers = np.shape(first)[0]
    out["layers"] = [
        _map(tree["layers"], lambda a, i=i: _to_tensor(np.asarray(a)[i], dev))
        for i in range(n_layers)
    ]
    return out
