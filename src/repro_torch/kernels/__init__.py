"""Kernels: plain PyTorch versions (``ref``), the Hopper kernel wrappers
(``gemm``, ``rmsnorm``, ``eltwise``, ``flash_attention``; CUDA sources in
``csrc/``, built by ``_build``), and the backend-switched ``ops``."""
