"""Training command line — a thin layer over the port's train step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --steps 4 --batch 2 --seq 256 [--microbatches 2] [--log-every 1] \\
        [--ckpt-dir DIR [--ckpt-every N] [--fail-at STEP] [--resume]]

Random params from ``--seed``, AdamW with warmup and cosine decay, the
synthetic bigram token stream (``repro_torch.data.synthetic``); each step
is ``make_train_step``'s loss and grads through the Hopper kernels (every
layer rematerialized in the backward) and the in-place optimizer update.
A batch is (``--batch``, ``--seq``) tokens, so the forward runs at
``--seq`` - 1 tokens a row, as ``repro.launch.train`` does.  Prints the
loss, ms per step, tokens per second and the peak device memory.  Runs
on the card (``--device cuda``, the default) and raises when there is
none; ``--device cpu`` runs the plain PyTorch versions (use a ``-smoke``
arch).

With ``--ckpt-dir`` the loop runs as ``repro.launch.train``'s
``train_range`` under ``run_with_restarts`` (2 restarts): a
non-blocking checkpoint every ``--ckpt-every`` steps, in the JAX
package's format, with the stream position; ``--fail-at S`` injects one
fault before step S (counted from 0), after which the run restores the
latest checkpoint and goes on.  ``--resume`` restores the latest
checkpoint of ``--ckpt-dir`` and continues from its step, where the JAX
CLI starts its loop at step 0 again on the restored state.
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
from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.distributed.fault_tolerance import (
    FaultInjector,
    run_with_restarts,
)
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
               device: torch.device, cfg: Optional[ArchConfig] = None,
               start: int = 0, ckpt: Optional[Checkpointer] = None,
               ckpt_every: int = 20,
               injector: Optional[FaultInjector] = None) -> Iterator[dict]:
    """Run steps ``start`` .. ``steps - 1`` and yield one record per step:
    its loss, wall ms (batch on the device to loss read), tokens per
    second, on the card the peak allocated bytes so far, and whether a
    checkpoint write was in flight as it ran.  ``injector`` may raise
    before a step; with ``ckpt``, the state after every ``ckpt_every``-th
    step is saved (non-blocking, the stream position in its manifest)
    before its record is yielded."""
    cuda = device.type == "cuda"
    for s in range(start, steps):
        if injector is not None:
            injector.maybe_fail(s)
        batch = make_batch(stream, s, device, cfg)
        if cuda:
            torch.cuda.synchronize(device)
        saving = ckpt is not None and ckpt.pending()
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch)
        loss = float(loss)
        dt = time.perf_counter() - t0
        rec = {"step": s + 1, "loss": loss, "ms": 1e3 * dt,
               "tokens_per_s": batch["tokens"][:, 1:].numel() / dt,
               "peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if cuda else None),
               "saving": saving}
        if ckpt is not None and (s + 1) % ckpt_every == 0:
            ckpt.save(s + 1, state, blocking=False,
                      extra={"data_position": s + 1})
        yield rec


def train_supervised(step_fn: Callable, init_state: Callable, stream,
                     *, steps: int, device: torch.device,
                     ckpt: Checkpointer, cfg: Optional[ArchConfig] = None,
                     ckpt_every: int = 20, fail_at: Optional[int] = None,
                     resume: bool = False,
                     on_record: Callable[[dict], None] = lambda rec: None,
                     log: Callable[[str], None] = print):
    """``train_loop`` under ``run_with_restarts`` (2 restarts), as
    ``repro.launch.train`` runs its ``train_range``: ``init_state()``
    builds the initial state (again on a restart before the first
    checkpoint); with ``resume`` the latest checkpoint of ``ckpt`` is
    restored into it and the run continues from its step.  Each record
    goes to ``on_record``; JAX's lines go to ``log``.  Returns (state,
    final step, restarts)."""
    injector = FaultInjector([fail_at] if fail_at else [])
    start, first = 0, init_state
    if resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        first = ckpt.restore(start, init_state())
        log(f"resumed from step {start}")

    def train_range(start_step, state):
        for rec in train_loop(step_fn, state, stream, steps=steps,
                              device=device, cfg=cfg, start=start_step,
                              ckpt=ckpt, ckpt_every=ckpt_every,
                              injector=injector):
            on_record(rec)
        ckpt.wait()
        return state, steps

    state, final, restarts = run_with_restarts(
        train_range, ckpt, first, max_restarts=2, start=start)
    if restarts:
        log(f"recovered from {restarts} failure(s) via checkpoint restart")
    return state, final, restarts


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
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a fault at this step (restart demo)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    dev = resolve_device(args.device)
    opt = OptConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    stream = TokenStream(TokenStreamSpec(cfg.vocab_size, args.seq,
                                         args.batch, args.seed))
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)
    print(f"{cfg.name} on {dev}: {args.steps} steps x {args.batch}x"
          f"{args.seq - 1} tokens, {args.microbatches} microbatch(es)",
          flush=True)

    def log(rec):
        if rec["step"] % args.log_every == 0 or rec["step"] == args.steps:
            peak = ("" if rec["peak_bytes"] is None else
                    f", peak {rec['peak_bytes'] / 2 ** 30:.2f} GiB")
            print(f"step {rec['step']}: loss={rec['loss']:.4f} "
                  f"({rec['ms']:.0f} ms/step, {rec['tokens_per_s']:.0f} "
                  f"tok/s{peak})", flush=True)

    def init_state():
        return init_train_state(cfg, opt, args.seed, device=dev)

    if args.ckpt_dir:
        _, final, _ = train_supervised(
            step_fn, init_state, stream, steps=args.steps, device=dev,
            ckpt=Checkpointer(args.ckpt_dir), cfg=cfg,
            ckpt_every=args.ckpt_every, fail_at=args.fail_at,
            resume=args.resume, on_record=log,
            log=lambda line: print(line, flush=True))
    else:
        injector = FaultInjector([args.fail_at] if args.fail_at else [])
        for rec in train_loop(step_fn, init_state(), stream,
                              steps=args.steps, device=dev, cfg=cfg,
                              injector=injector):
            log(rec)
        final = args.steps
    print(f"done at step {final}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
