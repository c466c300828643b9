"""State that crosses from the JAX package: coverage sets and gate constants.

This system runs no model, so its "weights" are the cached coverage set of
a basis gate (a pickle of ``slam_decomposition_tpu.coverage`` classes), the
ansatz's ``chain_gates`` (k, 4, 4) complex array, and solver iterates,
which are plain numpy arrays in both packages (``torch.from_numpy`` /
``Tensor.numpy()``).
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from slam_decomposition_torch.coverage import coverage as _coverage
from slam_decomposition_torch.coverage import polytope as _polytope

# coverage class -> port class: the JAX package's (its cached sets) and the
# port's own (the sets it builds); nothing else of either package may load
_REMAP = {
    (f"{package}.coverage.{module}", cls.__name__): cls
    for package in ("slam_decomposition_tpu", "slam_decomposition_torch")
    for module, cls in (
        ("coverage", _coverage.CircuitPolytope),
        ("polytope", _polytope.Polytope),
        ("polytope", _polytope.ConvexPolytope),
    )
}
_ALLOWED_MODULES = {"fractions", "builtins", "copyreg"}


class _CoverageUnpickler(pickle.Unpickler):
    """Loads a JAX coverage cache into the port's classes. Importing the
    JAX package's modules (which import jax) is refused, as is any class
    outside the coverage data model."""

    def find_class(self, module, name):
        port_cls = _REMAP.get((module, name))
        if port_cls is not None:
            return port_cls
        if module in _ALLOWED_MODULES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load {module}.{name}")


def coverage_from_jax_pickle(path) -> list:
    """The coverage list (identity first, then layers by cost) from a
    ``polytope_coverage_*.pkl`` written by the JAX package or by the port."""
    with open(path, "rb") as f:
        return _CoverageUnpickler(f).load()


def chain_gates_from_numpy(gates: np.ndarray, device="cpu") -> torch.Tensor:
    """(k, 4, 4) complex numpy (``Ansatz.chain_gates`` of either package) ->
    complex128 tensor on ``device``."""
    g = np.asarray(gates)
    if g.ndim != 3 or g.shape[1:] != (4, 4) or not np.iscomplexobj(g):
        raise ValueError(f"chain_gates must be complex (k, 4, 4), got {g.dtype} {g.shape}")
    return torch.as_tensor(g.astype(np.complex128)).to(device)
