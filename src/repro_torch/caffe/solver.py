"""Solver — Caffe's SGD(+momentum) training loop (``repro.caffe.solver``).

Caffe semantics: ``v = momentum*v + lr*(grad + weight_decay*w); w -= v``
with the solver's learning-rate policy (``inv`` for LeNet-MNIST, ``fixed``
for CIFAR-10 quick).  The train step takes the loss and its gradients by
autograd of ``Net.forward_loss`` through the ops' Functions (the Hopper
kernels and their backward kernels on the card), then updates the state
in place: the velocity and the params are written where they are, and
the learning rate is computed on the device from the device's iteration
counter, so a step reads nothing back to the host.  JAX jits its step in
the fused mode; the port runs eagerly in every boundary mode, as JAX's
un-jitted partial-port path does.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import torch

from repro_torch.caffe.net import Net
from repro_torch.caffe.spec import SolverSpec
from repro_torch.core.policy import resolve_device


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
        """``train_step(state, data, label) -> (state, loss)``
        (``repro/caffe/solver.py:30-59``): the loss and its gradients by
        autograd, then, per param, ``v = momentum*v + lr*(g +
        weight_decay*w)`` and ``w -= v`` in that order, in place on the
        state's tensors, and ``iter += 1``.  The state is returned (the
        same dict) with the loss of the params it was given."""
        net, spec = self.net, self.spec

        def train_step(state, data, label):
            params, velocity = state["params"], state["velocity"]
            keys = [(name, k) for name, p in params.items() for k in p]
            # autograd leaves sharing the params' storage
            leaves = [params[name][k].detach().requires_grad_(True)
                      for name, k in keys]
            tree = {name: {} for name in params}
            for (name, k), leaf in zip(keys, leaves):
                tree[name][k] = leaf
            with torch.enable_grad():
                loss = net.forward_loss(tree, data, label)
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                lr = spec.learning_rate(state["iter"].float())
                for (name, k), g in zip(keys, grads):
                    w, v = params[name][k], velocity[name][k]
                    v.mul_(spec.momentum).add_(
                        lr * (g + spec.weight_decay * w))
                    w.sub_(v)
                state["iter"].add_(1)
            return state, loss.detach()

        return train_step

    def make_eval_step(self) -> Callable:
        """``eval_step(params, data, label) -> {"loss", "accuracy"}``: the
        TEST phase's forward, without autograd."""
        net = self.net

        def eval_step(params, data, label):
            with torch.no_grad():
                return net.metrics(params, data, label)

        return eval_step

    def solve(
        self,
        generator: torch.Generator,
        train_iter: Iterator[Tuple[torch.Tensor, torch.Tensor]],
        test_iter: Optional[Callable[[], Iterator]] = None,
        log: Optional[Callable[[str], None]] = None,
        *,
        device: str | torch.device = "cuda",
    ):
        """``max_iter`` train steps from ``init(generator, device)``; every
        ``test_interval`` steps the mean accuracy over ``test_batches``
        batches of ``test_iter()`` (``repro/caffe/solver.py:69-99``).
        Returns ``(state, {"loss": [...], "test_acc": [(iter, acc)]})``;
        each step's loss is read back to the host, as JAX's loop does."""
        state = self.init(generator, device)
        train_step = self.make_train_step()
        eval_step = self.make_eval_step()
        history = {"loss": [], "test_acc": []}
        for it in range(self.spec.max_iter):
            data, label = next(train_iter)
            state, loss = train_step(state, data, label)
            history["loss"].append(float(loss))
            if test_iter and (it + 1) % self.spec.test_interval == 0:
                accs = []
                for bi, (d, lab) in enumerate(test_iter()):
                    if bi >= self.spec.test_batches:
                        break
                    accs.append(float(eval_step(state["params"], d,
                                                lab)["accuracy"]))
                acc = sum(accs) / max(len(accs), 1)
                history["test_acc"].append((it + 1, acc))
                if log:
                    log(f"iter {it + 1}: loss={float(loss):.4f} "
                        f"test_acc={acc:.4f}")
        return state, history
