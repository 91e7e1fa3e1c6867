"""End-to-end example on the PyTorch/H100 port: train a ~100M-parameter LM
for a few hundred steps (the port's twin of ``train_lm_100m.py``).

A qwen2.5-family config scaled to ~100M params, trained on the synthetic
bigram token stream with AdamW + warmup-cosine and gradient accumulation,
through the port's train step (the Hopper kernels on the card, every
layer rematerialized in the backward).  Checkpointing and restart come
with the port's distributed slice.

    PYTHONPATH=src python examples/train_lm_100m_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_100m_torch.py --device cpu \\
        --steps 20
"""
import argparse
import dataclasses
import sys
import time

sys.path.insert(0, "src")

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.policy import resolve_device  # noqa: E402
from repro_torch.data.synthetic import TokenStream, TokenStreamSpec  # noqa: E402
from repro_torch.launch.steps import init_train_state, make_train_step  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.optim.optimizers import OptConfig, tree_leaves  # noqa: E402


def config_100m():
    base = get_arch("qwen2.5-3b")
    return dataclasses.replace(
        base,
        name="qwen2.5-100m",
        n_layers=10,
        d_model=640,
        n_heads=10,
        n_kv_heads=2,
        d_ff=2560,
        head_dim=64,
        vocab_size=50_000,
        tie_embeddings=True,
        dtype="float32",
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = config_100m()
    dev = resolve_device(args.device)
    opt = OptConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps,
                    weight_decay=0.01)
    stream = TokenStream(TokenStreamSpec(cfg.vocab_size, args.seq,
                                         args.batch))
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)
    state = init_train_state(cfg, opt, 0, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"config: {cfg.name} ~{n_params/1e6:.0f}M params, "
          f"{args.steps} steps x {args.batch}x{args.seq} tokens on {dev}")

    losses = []
    t0 = time.time()
    for rec in train_loop(step_fn, state, stream, steps=args.steps,
                          device=dev):
        losses.append(rec["loss"])
        s = rec["step"]
        if s % 20 == 0:
            dt = (time.time() - t0) / s
            tput = args.batch * args.seq / dt
            print(f"step {s}: loss={losses[-1]:.4f} "
                  f"({dt*1e3:.0f} ms/step, {tput:.0f} tok/s)")
    n = min(10, len(losses))
    first = sum(losses[:n]) / n
    last = sum(losses[-n:]) / n
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if last < first * 0.8 else 'check hyperparams'})")


if __name__ == "__main__":
    main()
