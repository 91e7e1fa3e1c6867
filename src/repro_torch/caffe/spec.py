"""Prototxt-like network and solver specs (``repro.caffe.spec``): Caffe's
``.prototxt`` as dataclasses, field for field.

A ``NetSpec`` is an ordered list of ``LayerSpec``s wired by named blobs —
the containers/executors split the paper describes (Fig. 1): blobs are
containers, layers are executors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    name: str
    type: str                      # Convolution | InnerProduct | Pooling | ...
    bottoms: Tuple[str, ...]
    tops: Tuple[str, ...]
    # Convolution / Pooling
    num_output: int = 0
    kernel_size: int = 0
    stride: int = 1
    pad: int = 0
    pool: str = "max"              # max | ave
    # ReLU
    negative_slope: float = 0.0
    # InnerProduct
    transpose: bool = False
    bias_term: bool = True
    # Loss
    loss_weight: float = 1.0
    # Accuracy
    top_k: int = 1
    # init
    weight_filler: str = "xavier"  # xavier | gaussian
    filler_std: float = 0.01

    def replace(self, **kw) -> "LayerSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class NetSpec:
    name: str
    input_shape: Tuple[int, ...]   # per-example shape (C, H, W) or (D,)
    num_classes: int
    layers: Tuple[LayerSpec, ...]

    def layer(self, name: str) -> LayerSpec:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Caffe's solver.prototxt: SGD with momentum + inv LR policy."""

    base_lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lr_policy: str = "inv"         # inv | fixed | step
    gamma: float = 1e-4
    power: float = 0.75
    step_size: int = 1000
    max_iter: int = 1000
    batch_size: int = 64
    test_interval: int = 100
    test_batches: int = 4
    seed: int = 0

    def learning_rate(self, it):
        """The rate at iteration ``it`` (a number or a tensor); for a tensor
        ``it``, an f32 tensor on its device, computed there."""
        if self.lr_policy == "fixed":
            dev = it.device if isinstance(it, torch.Tensor) else None
            return torch.full((), self.base_lr, dtype=torch.float32,
                              device=dev)
        if self.lr_policy == "inv":
            return self.base_lr * (1.0 + self.gamma * it) ** (-self.power)
        if self.lr_policy == "step":
            return self.base_lr * self.gamma ** (it // self.step_size)
        raise ValueError(self.lr_policy)
