"""PyTorch/CUDA port of the NUMA-aware attention serving stack.

Mirrors the layout of the JAX package ``repro`` (configs, core, kernels,
models, cache, serving, launch) so every module has a counterpart there,
and imports nothing of it: the JAX package stays the reference the tests
compare against. The attention kernels on the paged serving path are
hand-written CUDA for Hopper (``csrc/``), built with ``nvcc`` at first use.
"""

__all__ = ["configs", "core", "kernels", "models", "cache", "serving"]
