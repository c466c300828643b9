"""Configuration: where the shared data estate lives.

The cached coverage sets are the JAX package's own files under
``slam_decomposition_tpu/data/``. They are read from disk in place (never
copied, never imported as a module: importing that package pulls in jax).
``SLAM_DATA_DIR`` overrides the location, as it does for the JAX package.
"""

from __future__ import annotations

import os
import pathlib

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


def data_dir() -> pathlib.Path:
    """Directory holding ``polytope_coverage_*.pkl`` and the other data files."""
    env = os.environ.get("SLAM_DATA_DIR")
    if env:
        return pathlib.Path(env)
    return REPO_ROOT / "slam_decomposition_tpu" / "data"


def build_dir() -> pathlib.Path:
    """Where the CUDA kernels are compiled to (listed in .gitignore)."""
    return REPO_ROOT / "build" / "slam_torch_kernels"
