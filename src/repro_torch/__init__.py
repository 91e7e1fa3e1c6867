"""PyTorch/Hopper port of the ``repro`` serving and training system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core``, ``configs``, ``kernels``, ``models``, ``serving``, ``optim``,
``data``, ``launch``) and runs the same paths on an NVIDIA H100: decoder
LMs served by the continuous-batching engine, greedy, and trained with
AdamW, through hand-written CUDA kernels (``kernels/csrc``).  Each op has two lowerings, the plain PyTorch version and
the Hopper kernel; ``repro_torch.core.policy`` picks one.

Importing the package builds nothing and imports neither ``jax`` nor
``repro``: kernels are compiled with ``nvcc`` at their first launch.
"""
