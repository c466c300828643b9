"""Configuration: where the shared data estate lives, which device the
entry points run on, and the optimizer's defaults.

The cached coverage sets are the JAX package's own files under
``slam_decomposition_tpu/data/``. They are read from disk in place (never
copied, never imported as a module: importing that package pulls in jax,
and never written). ``SLAM_DATA_DIR`` overrides the location, as it does
for the JAX package. The sets the port builds itself go under ``build/``.
"""

from __future__ import annotations

import os
import pathlib

import torch

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


JAX_DATA_DIR = REPO_ROOT / "slam_decomposition_tpu" / "data"  # the JAX package's own data, read only


def data_dir() -> pathlib.Path:
    """Directory holding ``polytope_coverage_*.pkl`` and the other data files."""
    env = os.environ.get("SLAM_DATA_DIR")
    if env:
        return pathlib.Path(env)
    return JAX_DATA_DIR


def cache_dir(name: str) -> pathlib.Path:
    """A directory of what the port writes (``build/<name>``, listed in
    .gitignore); ``SLAM_CACHE_DIR`` moves their common root."""
    return pathlib.Path(os.environ.get("SLAM_CACHE_DIR", REPO_ROOT / "build")) / name


def build_dir() -> pathlib.Path:
    """Where the CUDA kernels are compiled to (listed in .gitignore)."""
    return REPO_ROOT / "build" / "slam_torch_kernels"


def polytope_build_dir() -> pathlib.Path:
    """Where the exact-rational polytope core (csrc/polytope_core.cpp) is
    compiled to (listed in .gitignore)."""
    return REPO_ROOT / "build" / "slam_polytope"


def coverage_cache_dir() -> pathlib.Path:
    """Where the port writes the coverage sets it builds, under the JAX
    package's file names (listed in .gitignore). ``data_dir()`` is only
    read."""
    return cache_dir("slam_coverage")


def preseed_dir() -> pathlib.Path:
    """Where the port saves its preseed stores (``data_dir()`` is only
    read)."""
    return cache_dir("slam_preseed")


def explore_dir() -> pathlib.Path:
    """Where the port's candidate database ``cg_gates.h5`` lives."""
    return cache_dir("slam_explore")


def transpile_dir() -> pathlib.Path:
    """Where the port's transpile tools write their results."""
    return cache_dir("slam_transpile")


def _env(name: str, default, cast):
    v = os.environ.get(name)
    return cast(v) if v is not None else default


# the optimizer's defaults, under the JAX package's environment names
success_threshold: float = _env("SLAM_SUCCESS_THRESHOLD", 1e-10, float)  # a target counts as solved at or under it
training_restarts: int = _env("SLAM_TRAINING_RESTARTS", 5, int)  # multi-start restarts per target
max_opt_iters: int = _env("SLAM_MAX_OPT_ITERS", 400, int)  # L-BFGS iterations per restart


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
