"""Deterministic synthetic LM token stream (``repro.data.synthetic``'s
``TokenStreamSpec`` and ``TokenStream``).

The successor table comes from ``np.random.default_rng(seed)`` exactly as
in JAX, so it is bit-identical.  ``jax.random`` cannot be reproduced in
torch, so a batch draws its start tokens, its noise mask and its noise
tokens from a CPU ``torch.Generator`` seeded from (seed, step): the
batches differ from JAX's but are pure in (seed, step) and keep the same
structure (a successor chain over a reduced alphabet with 10% noise
tokens).  Tests that hold the port to JAX feed both sides JAX's batches.
``ImageStream`` comes with the Caffe slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

NOISE_RATE = 0.1


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
        key = np.random.SeedSequence(
            [self.spec.seed, step]).generate_state(1, np.uint64)[0]
        return torch.Generator().manual_seed(int(key))

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
