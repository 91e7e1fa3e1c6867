"""Shared inputs for the PyTorch-port parity tests (``test_torch_*.py``).

Both sides get the same numbers: parameters come from the JAX package's
``init_params`` and cross to the port through numpy (``params_from_jax``),
because ``jax.random`` cannot be reproduced in torch.  The JAX init sets the
qkv biases to zero, the norm weights (the moe block's too) to one and, in
the Mamba blocks, ``a_log`` and ``dt_bias`` to zero and ``d_skip`` to
one, which would leave the bias add, the norms' weight multiply, the
per-head decay, the step bias and the skip scale untested, so all of them
are perturbed with seeded numpy noise before either side sees them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_arch as jax_get_arch
from repro.models import lm as jax_lm

ARCH = "qwen2.5-3b-smoke"


def jax_params(seed: int = 0, noise_seed: int = 1, arch: str = ARCH,
               cfg=None):
    """(JAX cfg, numpy params tree, JAX params) for ``arch`` (or ``cfg``),
    perturbed as the module docstring says."""
    cfg = cfg if cfg is not None else jax_get_arch(arch)
    tree = jax.device_get(jax_lm.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(noise_seed)

    def noise(a, base, scale):
        return (base + scale * rng.standard_normal(a.shape)).astype(a.dtype)

    def attn_mlp(attn, mlp):
        for key in ("bq", "bk", "bv"):
            if key in attn:
                attn[key] = noise(attn[key], 0.0, 0.1)
        attn["ln"] = noise(attn["ln"], 1.0, 0.1)
        mlp["ln"] = noise(mlp["ln"], 1.0, 0.1)

    def mamba(p):
        p["a_log"] = noise(p["a_log"], 0.0, 0.5)
        p["dt_bias"] = noise(p["dt_bias"], 0.0, 0.5)
        p["d_skip"] = noise(p["d_skip"], 1.0, 0.1)
        p["ln"] = noise(p["ln"], 1.0, 0.1)
        p["ln_inner"] = noise(p["ln_inner"], 1.0, 0.1)

    layers = tree.get("layers", {})
    if "attn" in layers:
        # a moe layer's norm before the router is perturbed like the MLP's
        attn_mlp(layers["attn"], layers["mlp"] if "mlp" in layers
                 else layers["moe"])
    if "mamba" in layers:
        mamba(layers["mamba"])
    if "groups" in tree:
        mamba(tree["groups"]["mamba"])
        attn_mlp(tree["shared_attn"], tree["shared_mlp"])
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
