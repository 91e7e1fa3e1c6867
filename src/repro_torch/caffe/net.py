"""Net — Caffe's network graph executor over named blobs
(``repro.caffe.net``).

``forward`` walks the layer list feeding named blobs (containers) through
executors, skipping a layer whose bottom is missing (the loss layers of a
net run without labels); ``forward_loss`` sums the loss tops (what the
solver differentiates with autograd); ``metrics`` reads the loss and the
accuracy; ``backward_manual`` is Caffe's explicit reverse pass over each
layer's ``backward`` (the gradient oracle of the tests, and the backward
the paper's partial-port modes time).

The ``boundary`` hook reproduces the paper's §4.3 pathology: when set,
every blob crossing into a layer pays (a) a real host round trip (``.cpu()``
then back to the blob's device, which synchronizes with the card) and,
with ``"transfer+transpose"``, (b) a row -> column major relayout first
(``core.container.as_layout``), whose column-major result the kernels
read by its strides — the "unnecessary transfers + transpose per
crossing" the paper identifies as the dominant overhead of a partial
port.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.caffe.layers import Layer, build_layer
from repro_torch.caffe.spec import NetSpec
from repro_torch.core.container import MajorOrder, as_layout
from repro_torch.core.policy import resolve_device

BOUNDARIES = (None, "transfer", "transfer+transpose")


class Net:
    def __init__(self, spec: NetSpec, boundary: Optional[str] = None):
        """boundary: None | 'transfer' | 'transfer+transpose' (paper §4.3)."""
        if boundary not in BOUNDARIES:
            raise ValueError(f"boundary {boundary!r}; expected one of "
                             f"{BOUNDARIES}")
        self.spec = spec
        self.layers: List[Layer] = [build_layer(ls) for ls in spec.layers]
        self.boundary = boundary

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator, batch_size: int,
             device: str | torch.device = "cuda"):
        """Params ``{layer: {"w", "b"}}`` on ``device`` (the card unless
        the caller asks for the CPU), drawn from ``generator`` layer by
        layer; records ``blob_shapes``."""
        dev = resolve_device(device)
        shapes: Dict[str, Tuple[int, ...]] = {
            "data": (batch_size, *self.spec.input_shape),
            "label": (batch_size,),
        }
        params: Dict[str, dict] = {}
        for layer in self.layers:
            bshapes = [shapes[b] for b in layer.spec.bottoms]
            p, tshapes = layer.init(generator, bshapes, dev)
            if p:
                params[layer.name] = p
            for t, ts in zip(layer.spec.tops, tshapes):
                shapes[t] = ts
        self.blob_shapes = shapes
        return params

    # -- the paper's partial-port boundary crossing ---------------------------
    def _cross(self, x: torch.Tensor) -> torch.Tensor:
        if self.boundary is None or x is None or x.dim() == 0:
            return x
        if "transpose" in self.boundary and x.dim() >= 2:
            # row-major PHAST domain -> column-major OpenBLAS domain
            x = as_layout(x, MajorOrder.ROW, MajorOrder.COLUMN)
        # host round trip (device -> orchestrating CPU -> device)
        return x.cpu().to(x.device)

    # -- forward ------------------------------------------------------------
    def forward(self, params, data, label=None, train: bool = True):
        """Returns (blobs dict, caches dict)."""
        blobs: Dict[str, torch.Tensor] = {"data": data}
        if label is not None:
            blobs["label"] = label
        caches = {}
        for layer in self.layers:
            if any(b not in blobs for b in layer.spec.bottoms):
                continue  # e.g. loss layers at inference without labels
            bottoms = [self._cross(blobs[b]) for b in layer.spec.bottoms]
            tops, cache = layer.forward(params.get(layer.name, {}), bottoms,
                                        train)
            caches[layer.name] = cache
            for t, v in zip(layer.spec.tops, tops):
                blobs[t] = v
        return blobs, caches

    def forward_loss(self, params, data, label) -> torch.Tensor:
        """Scalar total loss (what the solver differentiates)."""
        blobs, _ = self.forward(params, data, label, train=True)
        loss = torch.zeros((), dtype=torch.float32, device=data.device)
        for layer in self.layers:
            if layer.spec.type == "SoftmaxWithLoss":
                loss = loss + blobs[layer.spec.tops[0]]
        return loss

    def metrics(self, params, data, label) -> Dict[str, torch.Tensor]:
        blobs, _ = self.forward(params, data, label, train=False)
        out = {}
        for layer in self.layers:
            if layer.spec.type == "SoftmaxWithLoss":
                out["loss"] = blobs[layer.spec.tops[0]]
            if layer.spec.type == "Accuracy":
                out["accuracy"] = blobs[layer.spec.tops[0]]
        return out

    # -- Caffe-style explicit backward (gradient oracle for tests) -----------
    @torch.no_grad()
    def backward_manual(self, params, data, label):
        """``{layer: {"w", "b"}}`` gradients of ``forward_loss`` by the
        layers' own ``backward``, in reverse layer order
        (``repro/caffe/net.py:101-129``): a loss layer seeds 1, a blob read
        by several layers sums their diffs, and no diff flows into
        ``data`` or ``label``.  Runs without autograd."""
        blobs, caches = self.forward(params, data, label, train=True)
        diffs: Dict[str, torch.Tensor] = {}
        grads: Dict[str, dict] = {}
        for layer in reversed(self.layers):
            if layer.name not in caches or layer.spec.type == "Accuracy":
                continue
            if layer.spec.type == "SoftmaxWithLoss":
                top_diffs = [torch.ones((), dtype=torch.float32,
                                        device=data.device)]
            else:
                top_diffs = [diffs.get(t) for t in layer.spec.tops]
                if all(d is None for d in top_diffs):
                    continue
                top_diffs = [torch.zeros_like(blobs[t]) if d is None else d
                             for d, t in zip(top_diffs, layer.spec.tops)]
            bdiffs, pgrads = layer.backward(params.get(layer.name, {}),
                                            caches[layer.name], top_diffs)
            if pgrads:
                grads[layer.name] = pgrads
            for b, d in zip(layer.spec.bottoms, bdiffs):
                if d is None or b in ("data", "label"):
                    continue
                diffs[b] = diffs[b] + d if b in diffs else d
        return grads
