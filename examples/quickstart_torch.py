"""Quickstart on the PyTorch/H100 port — the twin of ``quickstart.py``.

Train the Caffe LeNet on (synthetic) MNIST through the port's portability
core: the SAME network code runs on the reference backend (plain PyTorch)
or the hopper backend (the hand-written Hopper kernels and their backward
kernels), selected by one switch — PHAST's macro, in PyTorch.

    PYTHONPATH=src python examples/quickstart_torch.py [--backend hopper]
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \\
        --iters 20
"""
import argparse
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.caffe import Net, Solver, lenet_mnist, lenet_mnist_solver  # noqa: E402
from repro_torch.core import use_backend  # noqa: E402
from repro_torch.data.synthetic import mnist_like  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=["reference", "hopper"],
                    help="default: hopper on the card, reference on the "
                         "CPU")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--iters", type=int, default=60)
    args = ap.parse_args(argv)
    if args.backend is None:
        args.backend = "hopper" if args.device == "cuda" else "reference"

    net = Net(lenet_mnist())
    test_interval = min(20, args.iters)
    solver = Solver(net, lenet_mnist_solver(
        max_iter=args.iters, batch_size=32, test_interval=test_interval,
        test_batches=2))
    stream = mnist_like(32, device=args.device)

    # the one-line 'Makefile switch': same net, different lowering
    with use_backend(args.backend):
        state, hist = solver.solve(
            torch.Generator().manual_seed(0), iter(stream),
            test_iter=lambda: stream.eval_iter(), log=print,
            device=args.device,
        )
    print(f"[{args.backend}] final loss {hist['loss'][-1]:.4f}, "
          f"test acc {hist['test_acc'][-1][1]:.3f}")
    return hist


if __name__ == "__main__":
    main()
