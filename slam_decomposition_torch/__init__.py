"""slam_decomposition_torch — PyTorch + CUDA (Hopper) port of slam_decomposition_tpu.

The JAX package beside this one is the reference; this package re-implements
its Haar-decomposition main path (``bench.py``'s flow) with native complex
dtypes, f64 on the device, and hand-written CUDA kernels for the three
chain solvers (``ops/chain_kernels.py``, sources in ``csrc/``).

This package imports torch, numpy and scipy only — never jax, and never
``slam_decomposition_tpu`` (whose ``__init__`` imports jax). State produced by
the JAX package (the cached coverage sets, ansatz gate constants, solver
iterates) crosses over as files and numpy arrays (``convert.py``).
"""

__version__ = "0.1.0"
