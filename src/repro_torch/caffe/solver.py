"""Solver — Caffe's SGD(+momentum) training loop (``repro.caffe.solver``).

This slice ports its state and its TEST phase: ``init`` (params, a zero
velocity per param and the iteration counter) and ``make_eval_step``
(``Net.metrics`` under ``torch.no_grad()``).  The train step (Caffe's
``v = momentum*v + lr*(grad + weight_decay*w); w -= v`` with the solver's
learning-rate policy) and ``solve`` come with the Caffe training slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.caffe.net import Net
from repro_torch.caffe.spec import SolverSpec
from repro_torch.core.policy import resolve_device

_TRAINING = ("comes with the Caffe training slice (slice 7), with the "
             "backward kernels")


class Solver:
    def __init__(self, net: Net, spec: SolverSpec):
        self.net = net
        self.spec = spec

    def init(self, generator: torch.Generator,
             device: str | torch.device = "cuda"):
        """``{"params", "velocity", "iter"}`` on ``device`` (the card
        unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        params = self.net.init(generator, self.spec.batch_size, dev)
        velocity = {name: {k: torch.zeros_like(v) for k, v in p.items()}
                    for name, p in params.items()}
        return {"params": params, "velocity": velocity,
                "iter": torch.zeros((), dtype=torch.int32, device=dev)}

    def make_train_step(self) -> Callable:
        raise NotImplementedError(f"Solver.make_train_step {_TRAINING}")

    def make_eval_step(self) -> Callable:
        """``eval_step(params, data, label) -> {"loss", "accuracy"}``: the
        TEST phase's forward, without autograd."""
        net = self.net

        def eval_step(params, data, label):
            with torch.no_grad():
                return net.metrics(params, data, label)

        return eval_step

    def solve(self, *args, **kwargs):
        raise NotImplementedError(f"Solver.solve {_TRAINING}")
