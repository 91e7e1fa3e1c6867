"""The port's copy of what ``jax.random`` does for the serving engine's
sampler (``repro.serving.engine._sample``), bit for bit, on any device.

JAX's default PRNG is Threefry-2x32 (Salmon et al., SC'11, 20 rounds);
the engine keeps each row's raw key, two uint32 words, and samples a
token at position ``p`` with ``categorical(fold_in(key, p), logits)``.
Everything here works on torch ``int64`` tensors holding uint32 values
(every sum and shift is masked back to 32 bits), so it runs on the card
as a few hundred elementwise launches, with no host sync:

  * ``threefry2x32(k0, k1, x0, x1)``: JAX's ``threefry2x32_p``;
  * ``fold_in(key, data)``: Threefry of the key over the counter pair
    ``(0, data)`` (``jax.random.fold_in`` of a 32-bit datum);
  * ``random_bits(key, n)``: ``jax.random.bits(key, (n,))`` in the
    partitionable layout (``jax_threefry_partitionable``, JAX's default
    since 0.5): element ``i``'s counters are the high and low words of
    ``i``, and its bits the xor of the two outputs;
  * ``uniform(key, n)``: ``jax.random.uniform(key, (n,), minval=tiny)``:
    the top 23 bits as an f32 mantissa in [1, 2), minus 1, lifted to
    ``tiny``;
  * ``gumbel`` ``-log(-log(u))`` and ``categorical``, the first maximum of
    ``gumbel + logits`` (JAX's ``mode="low"`` Gumbel).

The integers (keys, bits, uniforms) equal JAX's exactly.  The Gumbel
noise goes through ``log``, whose last bit may differ between XLA's and
torch's implementations, so a sampled token can differ from JAX's only
where the two best perturbed scores lie within an ulp or so.

``req_key`` is the engine's per-request key: a numpy Philox draw from
``SeedSequence((seed, req_id))``, made on the host at admission.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
# rotation constants of Threefry-2x32's two alternating groups of 4 rounds
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 of the counter pairs ``(x0, x1)`` under the key
    ``(k0, k1)``; all uint32 values in int64 tensors that broadcast
    together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` for ``(..., 2)`` int64 keys and data that
    broadcast against ``key[..., 0]``, taken as uint32 as JAX takes them:
    the new key is Threefry of the key over ``(0, data)``."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (32 bits, partitionable layout) for
    each of the ``(..., 2)`` int64 keys: ``(..., n)`` uint32 values in
    int64."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None], i >> 32,
                          i & M32)
    return y0 ^ y1


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``:
    f32 in [tiny, 1), ``(..., n)``."""
    bits = (random_bits(key, n) >> 9) | _ONE_F32_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # (maxval - minval) rounds to 1 in f32, so the scale is the identity
    return torch.clamp(floats + _TINY, min=_TINY)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (``mode="low"``)."""
    return -torch.log(-torch.log(uniform(key, n)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, one key
    a row: the first maximum of Gumbel noise plus the f32 logits."""
    noise = gumbel(key, logits.shape[-1])
    return torch.argmax(noise + logits, dim=-1)


def req_key(seed: int, req_id: int) -> np.ndarray:
    """The engine's sampling key of request ``req_id``: a pure function of
    (engine seed, request id), drawn on the host (no device round trip at
    admission), as ``repro.serving.engine.ServingEngine._req_key``."""
    gen = np.random.Generator(
        np.random.Philox(np.random.SeedSequence((seed, req_id))))
    return gen.integers(0, 2 ** 32, size=2, dtype=np.uint32)
