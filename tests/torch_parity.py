"""Shared inputs for the PyTorch-port parity tests (``test_torch_*.py``).

Both sides get the same numbers: parameters come from the JAX package's
``init_params`` and cross to the port through numpy (``params_from_jax``),
because ``jax.random`` cannot be reproduced in torch.  The JAX init sets the
qkv biases to zero and the norm weights to one, which would leave the bias
add and the norm's weight multiply untested, so both are perturbed with
seeded numpy noise before either side sees them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import lm as jax_lm

ARCH = "qwen2.5-3b-smoke"


def jax_params(seed: int = 0, noise_seed: int = 1):
    """(JAX cfg, numpy params tree, JAX params) for the smoke arch."""
    cfg = jax_get_arch(ARCH)
    tree = jax.device_get(jax_lm.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(noise_seed)

    def noise(a, base, scale):
        return (base + scale * rng.standard_normal(a.shape)).astype(a.dtype)

    attn, mlp = tree["layers"]["attn"], tree["layers"]["mlp"]
    for key in ("bq", "bk", "bv"):
        attn[key] = noise(attn[key], 0.0, 0.1)
    attn["ln"] = noise(attn["ln"], 1.0, 0.1)
    mlp["ln"] = noise(mlp["ln"], 1.0, 0.1)
    tree["ln_f"] = noise(tree["ln_f"], 1.0, 0.1)
    return cfg, tree, jax.tree.map(jnp.asarray, tree)


def requests(n: int, lo: int, hi: int, gen_lo: int, gen_hi: int,
             vocab: int, seed: int):
    """``n`` (prompt tokens, max_new_tokens) pairs of mixed lengths."""
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).tolist(),
         int(rng.integers(gen_lo, gen_hi + 1)))
        for _ in range(n)
    ]
