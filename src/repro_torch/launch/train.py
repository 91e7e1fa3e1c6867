"""Training command line — a thin layer over the port's train step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --steps 4 --batch 2 --seq 256 [--microbatches 2] [--log-every 1]

Random params from ``--seed``, AdamW with warmup and cosine decay, the
synthetic bigram token stream (``repro_torch.data.synthetic``); each step
is ``make_train_step``'s loss and grads through the Hopper kernels (every
layer rematerialized in the backward) and the in-place optimizer update.
A batch is (``--batch``, ``--seq``) tokens, so the forward runs at
``--seq`` - 1 tokens a row, as ``repro.launch.train`` does.  Prints the
loss, ms per step, tokens per second and the peak device memory.  Runs
on the card (``--device cuda``, the default) and raises when there is
none; ``--device cpu`` runs the plain PyTorch versions (use a ``-smoke``
arch).  Checkpointing (``--ckpt-dir``, ``--resume``, ``--fail-at``)
comes with the distributed slice (ROADMAP Queue 1 item 17) and raises
until then.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core.policy import resolve_device
from repro_torch.data.synthetic import TokenStream, TokenStreamSpec
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.optim.optimizers import OptConfig


def make_batch(stream: TokenStream, step: int, device: torch.device,
               cfg: Optional[ArchConfig] = None) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch as ``{"tokens": (B, S+1)}`` on ``device``,
    where the stream's sequences are S+1 long; with a vlm ``cfg`` also
    zero ``vision`` (B, n_vision_tokens, d), with an encdec one zero
    ``frames`` (B, max(seq_len // 4, 4), d), as ``repro.launch.train`` makes
    them."""
    inputs, targets = stream.batch(step)
    out = {"tokens": torch.cat([inputs, targets[:, -1:]], dim=1).to(device)}
    b, seq = out["tokens"].shape[0], stream.spec.seq_len
    if cfg is not None and cfg.family == "vlm":
        out["vision"] = torch.zeros((b, cfg.n_vision_tokens, cfg.d_model),
                                    dtype=cfg.dtype_(), device=device)
    if cfg is not None and cfg.family == "encdec":
        out["frames"] = torch.zeros((b, max(seq // 4, 4), cfg.d_model),
                                    dtype=cfg.dtype_(), device=device)
    return out


def train_loop(step_fn: Callable, state, stream: TokenStream, *, steps: int,
               device: torch.device,
               cfg: Optional[ArchConfig] = None) -> Iterator[dict]:
    """Run ``steps`` steps and yield one record per step: its loss, wall ms
    (batch on the device to loss read), tokens per second and, on the
    card, the peak allocated bytes so far."""
    cuda = device.type == "cuda"
    for s in range(steps):
        batch = make_batch(stream, s, device, cfg)
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch)
        loss = float(loss)
        dt = time.perf_counter() - t0
        yield {"step": s + 1, "loss": loss, "ms": 1e3 * dt,
               "tokens_per_s": batch["tokens"][:, 1:].numel() / dt,
               "peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if cuda else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    args = ap.parse_args(argv)
    if args.ckpt_dir or args.resume or args.fail_at is not None:
        raise NotImplementedError(
            "--ckpt-dir, --resume and --fail-at need checkpointing, which "
            "comes with the distributed slice (ROADMAP Queue 1 item 17)")

    cfg = get_arch(args.arch)
    dev = resolve_device(args.device)
    opt = OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    stream = TokenStream(TokenStreamSpec(cfg.vocab_size, args.seq,
                                         args.batch, args.seed))
    state = init_train_state(cfg, opt, args.seed, device=dev)
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)
    print(f"{cfg.name} on {dev}: {args.steps} steps x {args.batch}x"
          f"{args.seq - 1} tokens, {args.microbatches} microbatch(es)",
          flush=True)
    for rec in train_loop(step_fn, state, stream, steps=args.steps,
                          device=dev, cfg=cfg):
        if rec["step"] % args.log_every == 0 or rec["step"] == args.steps:
            peak = ("" if rec["peak_bytes"] is None else
                    f", peak {rec['peak_bytes'] / 2 ** 30:.2f} GiB")
            print(f"step {rec['step']}: loss={rec['loss']:.4f} "
                  f"({rec['ms']:.0f} ms/step, {rec['tokens_per_s']:.0f} "
                  f"tok/s{peak})", flush=True)
    print(f"done at step {args.steps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
