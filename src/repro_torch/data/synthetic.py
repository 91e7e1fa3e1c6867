"""Deterministic synthetic data streams (``repro.data.synthetic``): the
class-conditional image streams of the LeNet nets (``ImageStreamSpec``,
``ImageStream``, ``mnist_like``, ``cifar10_like``) and the LM token
stream (``TokenStreamSpec``, ``TokenStream``).

The class prototype images and the successor table come from
``np.random.default_rng(seed)`` exactly as in JAX, so they are
bit-identical.  ``jax.random`` cannot be reproduced in torch, so a batch
draws its random numbers from a ``torch.Generator`` seeded from (seed,
step): the batches differ from JAX's but are pure in (seed, step) and keep
the same structure (an image is its class prototype plus Gaussian noise;
a token row is a successor chain over a reduced alphabet with 10% noise
tokens).  Tests that hold the port to JAX feed both sides JAX's batches.
An image stream lives on the device it is made for (the card unless the
caller asks for the CPU) and draws its batches there, so a batch costs
no host-to-device copy; the token stream draws on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policy import resolve_device

NOISE_RATE = 0.1


def _step_seed(seed: int, step: int) -> int:
    """A 64-bit generator seed keyed by (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


@dataclasses.dataclass(frozen=True)
class ImageStreamSpec:
    shape: Tuple[int, int, int]    # (C, H, W)
    num_classes: int
    batch_size: int
    seed: int = 0
    noise: float = 0.35


def _class_prototypes(spec: ImageStreamSpec) -> np.ndarray:
    """Smooth per-class prototype images (deterministic in seed), the
    numpy draws of ``repro/data/synthetic.py:29-44`` in their order."""
    rng = np.random.default_rng(spec.seed)
    c, h, w = spec.shape
    protos = np.zeros((spec.num_classes, c, h, w), np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for cls in range(spec.num_classes):
        for ch in range(c):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            px, py = rng.uniform(0, 2 * np.pi, 2)
            amp = rng.uniform(0.7, 1.3)
            protos[cls, ch] = amp * (
                np.sin(2 * np.pi * fx * xx / w + px)
                * np.cos(2 * np.pi * fy * yy / h + py)
            )
    return protos


class ImageStream:
    """Infinite class-conditional stream: batch(step) is pure in (seed,
    step) on its device."""

    def __init__(self, spec: ImageStreamSpec,
                 device: str | torch.device = "cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.protos = torch.from_numpy(_class_prototypes(spec)).to(
            self.device)

    def batch(self, step: int, batch_size: Optional[int] = None):
        """(data (B, C, H, W) f32, labels (B,) int64) on the device."""
        bs = batch_size or self.spec.batch_size
        gen = torch.Generator(device=self.device).manual_seed(
            _step_seed(self.spec.seed, step))
        labels = torch.randint(0, self.spec.num_classes, (bs,),
                               generator=gen, device=self.device)
        noise = self.spec.noise * torch.randn(
            (bs, *self.spec.shape), generator=gen, device=self.device)
        return self.protos[labels] + noise, labels

    def __iter__(self) -> Iterator:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    def eval_iter(self, offset: int = 10_000) -> Iterator:
        step = offset
        while True:
            yield self.batch(step)
            step += 1


def mnist_like(batch_size: int, seed: int = 0,
               device: str | torch.device = "cuda") -> ImageStream:
    return ImageStream(ImageStreamSpec((1, 28, 28), 10, batch_size, seed),
                       device)


def cifar10_like(batch_size: int, seed: int = 0,
                 device: str | torch.device = "cuda") -> ImageStream:
    return ImageStream(ImageStreamSpec((3, 32, 32), 10, batch_size, seed),
                       device)


@dataclasses.dataclass(frozen=True)
class TokenStreamSpec:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0


class TokenStream:
    """Deterministic LM token stream with learnable bigram structure."""

    def __init__(self, spec: TokenStreamSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        v = min(spec.vocab_size, 512)
        # sparse deterministic successor table over a reduced alphabet
        self.succ = torch.from_numpy(
            rng.integers(0, v, size=(v,)).astype(np.int64))
        self.v = v

    def generator(self, step: int) -> torch.Generator:
        """The CPU generator of one batch, keyed by (seed, step)."""
        return torch.Generator().manual_seed(_step_seed(self.spec.seed,
                                                         step))

    def batch(self, step: int):
        """(inputs, targets), each (batch_size, seq_len - 1) int64 on the
        CPU."""
        spec = self.spec
        gen = self.generator(step)
        tok = torch.randint(0, self.v, (spec.batch_size,), generator=gen)
        cols = []
        for _ in range(spec.seq_len):
            tok = self.succ[tok]
            cols.append(tok)
        toks = torch.stack(cols, dim=1)                  # (batch, seq)
        # noise tokens so the task is not trivially deterministic
        noise = torch.rand(toks.shape, generator=gen) < NOISE_RATE
        rand_tok = torch.randint(0, self.v, toks.shape, generator=gen)
        toks = torch.where(noise, rand_tok, toks)
        return toks[:, :-1], toks[:, 1:]
