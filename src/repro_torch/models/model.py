"""The ``Model`` facade — one config and one device, the family's functions
bound to them (the port's ``repro.models.model``).

``build_model(cfg)`` places the model on ``"cuda"`` unless the caller asks
for the CPU, and raises when no card is present.  The encdec family binds
``models/encdec.py``; every other family ``models/lm.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import resolve_device
from repro_torch.models import encdec, lm

def check_family(cfg: ArchConfig) -> None:
    if cfg.family != "encdec":
        lm.check_family(cfg)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device

    @property
    def _encdec(self) -> bool:
        return self.cfg.family == "encdec"

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return (encdec if self._encdec else lm).init_params(self.cfg, gen)

    def init_decode_state(self, batch: int, max_len: int, **kw):
        """Contiguous slab or (``layout="paged"`` / ``cache=``) page pool;
        ``lm.init_decode_state`` has the keywords.  encdec's cross K/V are
        sized for ``max(max_len // 4, 8)`` memory positions, as in JAX,
        until ``prefill_cross_cache`` replaces them."""
        if self._encdec:
            return encdec.init_decode_state(
                self.cfg, batch, max_len, enc_len=max(max_len // 4, 8),
                device=self.device, **kw)
        return lm.init_decode_state(self.cfg, batch, max_len,
                                    device=self.device, **kw)

    def forward(self, params, tokens, *, vision=None, frames=None):
        """Final-normed hidden states (B, S, d) of the teacher-forced
        forward (vlm beside ``vision``, encdec's decoder over the memory
        of ``frames``); ``lm_logits`` maps them to logits."""
        if self._encdec:
            memory = encdec.encode(self.cfg, params, frames)
            return encdec.decode_train(self.cfg, params, tokens, memory)
        return lm.forward(self.cfg, params, tokens, vision=vision)

    def train_loss(self, params, batch):
        """Mean next-token NLL of ``batch["tokens"]`` (B, S+1), f32
        (``batch["vision"]`` or ``batch["frames"]`` beside it)."""
        return (encdec if self._encdec else lm).train_loss(self.cfg, params,
                                                           batch)

    def prefill(self, params, batch):
        """Last-position logits (B, V) of the teacher-forced pass over
        ``batch["tokens"]`` (and ``"vision"`` or ``"frames"``), JAX's
        ``Model.prefill``."""
        if self._encdec:
            return encdec.prefill(self.cfg, params, batch["tokens"],
                                  batch["frames"])
        return lm.prefill(self.cfg, params, batch["tokens"],
                          vision=batch.get("vision"))

    def prefill_cross_cache(self, params, memory, state):
        """The cross K/V from ``memory``: encdec's encoder output, or vlm's
        vision embeddings."""
        if self._encdec:
            return encdec.prefill_cross_cache(self.cfg, params, memory, state)
        return lm.prefill_vlm_cross_cache(self.cfg, params, memory, state)

    def decode_step(self, params, state, token, **kw):
        return (encdec if self._encdec else lm).decode_step(
            self.cfg, params, state, token, **kw)

    def prefill_chunk(self, params, state, toks, width, **kw):
        """``lm.prefill_chunk``'s keywords (``logits_all`` included)."""
        return (encdec if self._encdec else lm).prefill_chunk(
            self.cfg, params, state, toks, width, **kw)

    def init_scratch(self, state, chunk: int):
        """``score_chunk``'s buffers, allocated once."""
        return lm.init_scratch(self.cfg, state, chunk)

    def score_chunk(self, params, state, toks, width, **kw):
        """All-position logits of a discarded chunk pass: ``state`` is left
        byte-identical (``lm.score_chunk``)."""
        return lm.score_chunk(self.cfg, params, state, toks, width, **kw)

    def reset_decode_rows(self, state, mask, **kw):
        return (encdec if self._encdec else lm).reset_decode_rows(
            self.cfg, state, mask, **kw)

    def restore_snapshots(self, state, mask, src, nblk):
        """Map the donor rows' first ``nblk`` snapshot slots into the
        masked rows and load their boundary states (prefix sharing)."""
        return lm.restore_snapshots(state, mask, src, nblk)

    def spill_rows(self, state, mask):
        """Move the masked rows' pages (and snapshot slots) to the host
        tier (preemption)."""
        return lm.spill_rows(state, mask)

    def restore_rows(self, state, mask):
        """Bring spilled rows' pages (and snapshot slots) back."""
        return lm.restore_rows(state, mask)

    def lm_logits(self, params, h):
        return lm.lm_logits(self.cfg, params, h)


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda") -> Model:
    check_family(cfg)
    return Model(cfg=cfg, device=resolve_device(device))
