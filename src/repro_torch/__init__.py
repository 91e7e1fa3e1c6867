"""PyTorch/Hopper port of the ``repro`` serving system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core``, ``configs``, ``kernels``, ``models``, ``serving``, ``launch``) and
runs the same main path on an NVIDIA H100: a dense decoder LM served by the
continuous-batching engine, greedy, through hand-written CUDA kernels
(``kernels/csrc``).  Each op has two lowerings, the plain PyTorch version and
the Hopper kernel; ``repro_torch.core.policy`` picks one.

Importing the package builds nothing and imports neither ``jax`` nor
``repro``: kernels are compiled with ``nvcc`` at their first launch.
"""
