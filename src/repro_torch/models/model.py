"""The ``Model`` facade — one config and one device, the LM functions bound
to them (the port's ``repro.models.model``).

``build_model(cfg)`` places the model on ``"cuda"`` unless the caller asks
for the CPU, and raises when no card is present.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import resolve_device
from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return lm.init_params(self.cfg, gen)

    def init_decode_state(self, batch: int, max_len: int, **kw):
        """Contiguous slab or (``layout="paged"`` / ``cache=``) page pool;
        ``lm.init_decode_state`` has the keywords."""
        return lm.init_decode_state(self.cfg, batch, max_len,
                                    device=self.device, **kw)

    def forward(self, params, tokens):
        """Final-normed hidden states (B, S, d) of the teacher-forced
        forward; ``lm_logits`` maps them to logits."""
        return lm.forward(self.cfg, params, tokens)

    def train_loss(self, params, batch):
        """Mean next-token NLL of ``batch["tokens"]`` (B, S+1), f32."""
        return lm.train_loss(self.cfg, params, batch)

    def decode_step(self, params, state, token, **kw):
        return lm.decode_step(self.cfg, params, state, token, **kw)

    def prefill_chunk(self, params, state, toks, width, **kw):
        return lm.prefill_chunk(self.cfg, params, state, toks, width, **kw)

    def reset_decode_rows(self, state, mask, **kw):
        return lm.reset_decode_rows(self.cfg, state, mask, **kw)

    def lm_logits(self, params, h):
        return lm.lm_logits(self.cfg, params, h)


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda") -> Model:
    lm.check_family(cfg)
    return Model(cfg=cfg, device=resolve_device(device))
