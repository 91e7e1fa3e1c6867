"""Serving regression check: incremental decode through the cache must
reproduce the teacher-forced forward at the last prompt position (the
port's ``repro.serving.checks``, behind ``launch/serve.py --check``)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import Model


def teacher_forced_logits(model: Model, params,
                          prompt: torch.Tensor) -> torch.Tensor:
    """Last-position logits of the full (non-cached) forward."""
    h = model.forward(params, prompt)
    return model.lm_logits(params, h[:, -1])


def decode_logits(model: Model, params, prompt: torch.Tensor,
                  max_len: int) -> torch.Tensor:
    """Last-position logits of token-by-token decode through the cache."""
    state = model.init_decode_state(prompt.shape[0], max_len)
    got = None
    for i in range(prompt.shape[1]):
        got, state = model.decode_step(params, state, prompt[:, i])
    return got


def assert_decode_matches_teacher_forced(
    model: Model, params, prompt: torch.Tensor, max_len: int,
    rtol: float = 2e-2, atol: float = 2e-2,
    scale_tol: Optional[float] = None,
) -> Tuple[float, float]:
    """Raise unless decode matches the forward within ``rtol``/``atol``
    (JAX's 2e-2), or, with ``scale_tol``, within ``scale_tol`` of the
    forward's largest |logit| (for bf16 at full width, where the two
    paths round at different places).  Returns (max |difference|, max
    |logit|)."""
    want = teacher_forced_logits(model, params, prompt).float().cpu()
    got = decode_logits(model, params, prompt, max_len).float().cpu()
    scale = want.abs().max().item()
    if scale_tol is not None:
        rtol, atol = 0.0, scale_tol * scale
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=atol)
    return (got - want).abs().max().item(), scale
