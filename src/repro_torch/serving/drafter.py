"""Draft proposers for speculative decoding (the port's
``repro.serving.drafter``).

The engine scores the current token and K drafts in one chunked-prefill
step (``prefill_chunk(logits_all=True)`` is the verifier) and keeps the
leading run of drafts equal to the verifier's own argmax, so a drafter
never changes the tokens: a bad draft only lowers the accept rate.

* :class:`PromptLookupDrafter` (``drafter="prompt_lookup"``) matches the
  last ``ngram`` tokens ending at the row's position against the row's
  own earlier tokens and proposes the continuation after the most recent
  match.  Stateless, any family: gathers over the token buffer.
* :class:`HybridSSMDrafter` (``drafter="hybrid_ssm"``) runs the hybrid
  family's own Mamba layers (``params["groups"]`` flattened, weights
  shared) as a K-step draft model, skipping the shared attention and MLP
  block.  It keeps private recurrent state in the decode-state dict
  (``drf_ssm``/``drf_conv``/``drf_pos``), advanced only on committed
  tokens by ``ingest``; the K proposal steps run on scratch copies
  allocated once, because ``mamba_decode_block`` writes its states in
  place and an SSM cannot roll back a rejected suffix.

Both are tensor work with fixed shapes and no host synchronisation, as the
engine's decode loop requires.  The proposals are JAX's ``jnp`` ops: no
kernel of its own, the Mamba blocks and the head run through the port's
kernels like any other step.
"""
from __future__ import annotations

import torch

from repro_torch.models import components as C
from repro_torch.models import lm


class PromptLookupDrafter:
    """N-gram prompt lookup: propose the continuation after the most
    recent earlier occurrence of the last ``ngram`` tokens."""

    stateful = False       # no state: the engine neither keeps nor feeds one

    def __init__(self, spec) -> None:
        self.k = int(spec.k)
        self.ngram = int(spec.ngram)

    def propose(self, params, state, tokens, progress, active):
        """(B, K) drafts for every row: positions ``<= progress`` are real
        (prompt, then committed tokens); a draft read past the frontier is
        garbage the verifier rejects.  The committed suffix after the most
        recent match is read modulo its length, so a short cycle (a
        converged constant) keeps proposing the cycle; no match proposes
        the current token."""
        b, max_len = tokens.shape
        n, k = self.ngram, self.k
        dev = tokens.device
        prog = progress.clamp(0, max_len - 1)
        col = torch.arange(max_len, device=dev)[None, :].expand(b, max_len)
        koff = torch.arange(n, device=dev) - (n - 1)
        key = tokens.gather(1, (prog[:, None] + koff[None, :]).clamp(
            0, max_len - 1))                                  # (B, n)
        eq = torch.ones((b, max_len), dtype=torch.bool, device=dev)
        for j in range(n):
            widx = (col + (j - (n - 1))).clamp(0, max_len - 1)
            eq &= tokens.gather(1, widx) == key[:, j, None]
        match = eq & (col >= n - 1) & (col < progress[:, None])
        i_best = torch.where(match, col, -1).amax(dim=1)      # (B,)
        period = (prog - i_best).clamp(min=1)
        offs = torch.arange(k, device=dev)[None, :]
        didx = (i_best[:, None] + 1 + offs % period[:, None]).clamp(
            0, max_len - 1)
        drafts = tokens.gather(1, didx)                       # (B, K)
        cur = tokens.gather(1, prog[:, None])
        return torch.where((i_best >= 0)[:, None], drafts, cur), state


class HybridSSMDrafter:
    """The hybrid family's Mamba layers as a weight-shared draft model:
    the ``n_layers`` Mamba blocks of ``params["groups"]`` in order, then
    the shared final norm and head; attention and its KV traffic are
    what it skips."""

    stateful = True

    def __init__(self, spec, cfg) -> None:
        if cfg.family != "hybrid":
            raise ValueError(
                "drafter='hybrid_ssm' drafts with the hybrid family's "
                f"Mamba layers — family 'hybrid' required, got "
                f"{cfg.family!r}"
            )
        self.k = int(spec.k)
        self.cfg = cfg
        self._scratch = None

    def init_state(self, batch: int, device: torch.device):
        """The private recurrence (``lm.reset_decode_rows`` resets it with
        the row's other state; spill and restore leave it in the lane, as
        the live ``ssm``/``conv``), and the proposal steps' scratch
        copies, allocated here once."""
        cfg = self.cfg
        state = {
            "drf_ssm": torch.zeros(
                (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                 cfg.ssm_state), dtype=torch.float32, device=device),
            "drf_conv": torch.zeros(
                (cfg.n_layers, batch, cfg.ssm_conv - 1, cfg.d_inner),
                dtype=cfg.dtype_(), device=device),
            "drf_pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device),
        }
        self._scratch = (torch.empty_like(state["drf_ssm"]),
                         torch.empty_like(state["drf_conv"]))
        return state

    @staticmethod
    def _layers(params):
        # (g, attn_every) groups -> the n_layers Mamba blocks in order
        return [p["mamba"] for group in params["groups"] for p in group]

    def ingest(self, params, state, tokens, upto, chunk: int):
        """Advance the recurrence over the committed tokens ``drf_pos ..
        upto - 1``, at most ``chunk`` of them: one masked prefill of width
        ``chunk`` a layer, in place (rows already caught up, or frozen or
        spilled rows whose ``upto`` has not moved, take width 0 and keep
        their states bit for bit)."""
        cfg = self.cfg
        b, max_len = tokens.shape
        dev = tokens.device
        dpos = state["drf_pos"]
        w = (upto - dpos).clamp(0, chunk)
        offs = torch.arange(chunk, device=dev)
        gidx = (dpos[:, None] + offs[None, :]).clamp(0, max_len - 1)
        toks = tokens.gather(1, gidx.long())
        x = params["embed"].index_select(0, toks.reshape(-1)).reshape(
            b, chunk, -1).to(cfg.dtype_())
        valid = offs[None, :] < w[:, None]
        ssm, conv = state["drf_ssm"], state["drf_conv"]
        for layer, p in enumerate(self._layers(params)):
            x, _, s_conv = C.mamba_prefill_block(
                cfg, p, x, ssm[layer], conv[layer], valid,
                ssm_out=ssm[layer])
            conv[layer].copy_(s_conv)
        return {**state, "drf_pos": (dpos + w).to(dpos.dtype)}

    def propose(self, params, state, tokens, progress, active):
        """Catch the recurrence up to ``progress`` (committed), then K
        greedy draft steps on the scratch copies."""
        state = self.ingest(params, state, tokens, progress, self.k + 1)
        cfg = self.cfg
        max_len = tokens.shape[1]
        ssm, conv = self._scratch
        ssm.copy_(state["drf_ssm"])
        conv.copy_(state["drf_conv"])
        layers = self._layers(params)
        tok = tokens.gather(1, progress.clamp(0, max_len - 1)[:, None])[:, 0]
        drafts = []
        for _ in range(self.k):
            x = params["embed"].index_select(0, tok).to(cfg.dtype_())
            for layer, p in enumerate(layers):
                x, _, s_conv = C.mamba_decode_block(
                    cfg, p, x, ssm[layer], conv[layer], ssm_out=ssm[layer])
                conv[layer].copy_(s_conv)
            h = C.norm(cfg, params["ln_f"], x)
            tok = torch.argmax(lm.lm_logits(cfg, params, h), dim=-1)
            drafts.append(tok)
        return torch.stack(drafts, dim=1), state               # (B, K)


def make_drafter(spec, cfg):
    """The drafter of ``SpecConfig.drafter`` (family-checked)."""
    if spec.drafter == "prompt_lookup":
        return PromptLookupDrafter(spec)
    if spec.drafter == "hybrid_ssm":
        return HybridSSMDrafter(spec, cfg)
    raise ValueError(
        f"unknown drafter {spec.drafter!r} "
        "(expected 'prompt_lookup' or 'hybrid_ssm')"
    )
