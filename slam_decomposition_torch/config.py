"""Configuration: where the shared data estate lives, and which device the
entry points run on.

The cached coverage sets are the JAX package's own files under
``slam_decomposition_tpu/data/``. They are read from disk in place (never
copied, never imported as a module: importing that package pulls in jax).
``SLAM_DATA_DIR`` overrides the location, as it does for the JAX package.
"""

from __future__ import annotations

import os
import pathlib

import torch

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


DEFAULT_DEVICE = "cuda"  # the entry points' device unless the caller names another


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """torch.device(device); raises for CUDA when torch sees no CUDA device.
    The entry points run on the card unless the caller asks for the CPU,
    and never fall back to it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass device='cpu' for the plain versions"
        )
    return device


def device_of(data, device=None) -> torch.device:
    """The device for ``data`` when the caller gives none: a tensor's own
    device, the card for anything else (numpy input)."""
    if device is None:
        device = data.device if isinstance(data, torch.Tensor) else DEFAULT_DEVICE
    return resolve_device(device)
