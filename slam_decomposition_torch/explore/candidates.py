"""Candidate basis gates and their scoring database (JAX
explore/candidates.py).

A 17 x 21 (strength, mix) grid of conversion-gain gates, deduplicated by
Weyl coordinate, scored with bare (gate-count) metrics [E-Haar, D-CNOT,
D-SWAP] into an HDF5 store with skip-if-present resume.

Two files hold rows. The port writes only its own, ``H5_PATH``
(``build/slam_explore/cg_gates.h5``). The JAX package's
``data/cg_gates.h5`` (group ``bare_cost``, 176 rows) is read in place and
never written. A reader takes the rows of both, by dataset key, the port's
row where both hold one, in key order (HDF5's own order within a file).
Reads go through ``utils.hdf5`` (numpy alone); writes need h5py.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, data_dir, explore_dir, resolve_device
from slam_decomposition_torch.models import gates as G
from slam_decomposition_torch.models.gates import Gate
from slam_decomposition_torch.utils import hdf5

logger = logging.getLogger(__name__)

H5_PATH = explore_dir() / "cg_gates.h5"  # the port's own database, the one it writes
JAX_H5_PATH = data_dir() / "cg_gates.h5"  # the JAX package's, read only

os.environ.setdefault("HDF5_USE_FILE_LOCKING", "FALSE")  # readers are never locked out by a sweep


def get_group_name(speed_method: str = "linear", duration_1q: float = 0) -> str:
    """The database group of a speed method and 1Q duration."""
    return f"{speed_method}_scaling_1q{duration_1q}"


def get_method_duration(group_name: str) -> Tuple[str, float]:
    speed_method = group_name.split("_")[0]
    duration_1q = float(group_name.split("_")[-1].replace("1q", ""))
    return speed_method, duration_1q


def _rows(path, group: str) -> Dict[str, np.ndarray]:
    try:
        return hdf5.read_group(path, group)
    except (OSError, KeyError):
        return {}


def read_group(group: str) -> Dict[str, np.ndarray]:
    """{dataset key: row} of ``group`` from the JAX file, then the port's
    file over it, in key order; {} where neither file holds the group.
    Read by ``utils.hdf5`` (numpy alone: no h5py needed)."""
    rows = _rows(JAX_H5_PATH, group)
    rows.update(_rows(H5_PATH, group))
    return {k: rows[k] for k in sorted(rows)}


def own_keys(group: str) -> set:
    """Dataset keys of ``group`` in the port's own file."""
    return set(_rows(H5_PATH, group))


def build_gates(
    n_strength: int = 17, n_mix: int = 21, elim_extra_weyl: bool = True, device=DEFAULT_DEVICE
) -> Tuple[List[Gate], np.ndarray]:
    """The design-space grid: strength k in [0, 0.5] (units of pi), mix p in
    [0, 1] splitting it between conversion and gain; deduplicated by Weyl
    coordinate rounded to 10 digits. The whole grid's unitaries and
    coordinates are one batched call on ``device`` (the card unless the
    caller names another). Returns (gates, coordinates (n, 3))."""
    from slam_decomposition_torch.models.hamiltonians import conversion_gain_u
    from slam_decomposition_torch.ops import weyl

    del elim_extra_weyl  # c1c2c3 already folds the left-side mirror
    device = resolve_device(device)
    ks = np.linspace(0, 0.5, n_strength)
    ps = np.linspace(0, 1, n_mix)
    kk, pp = np.meshgrid(ks, ps, indexing="ij")
    gc = (pp * kk * np.pi).reshape(-1)
    gg = ((1 - pp) * kk * np.pi).reshape(-1)

    def on(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    coords = weyl.c1c2c3(conversion_gain_u(on(gc), on(gg))).cpu().numpy()
    out: List[Gate] = []
    out_coords = []
    seen = set()
    for i in range(len(gc)):
        key = tuple(np.round(coords[i], 10))
        if key in seen:
            continue
        seen.add(key)
        out.append(G.conversion_gain_gate(0.0, 0.0, float(gc[i]), float(gg[i]), 1.0))
        out_coords.append(coords[i])
    return out, np.array(out_coords)


def collect_data(
    gate_list: Optional[List[Gate]] = None, overwrite: bool = False, max_layers: int = 8, device=DEFAULT_DEVICE
) -> int:
    """Score every candidate's bare costs into the port's ``bare_cost``
    group; a gate already there is skipped (resume), unless ``overwrite``
    clears the group first. Coverage sets come from the caches or are built
    (coordinates on ``device``). Returns the number of rows written."""
    import h5py

    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_range_from_target
    from slam_decomposition_torch.coverage.haar import expected_cost

    device = resolve_device(device)
    if gate_list is None:
        gate_list, _ = build_gates(device=device)
    H5_PATH.parent.mkdir(parents=True, exist_ok=True)
    if overwrite:
        with h5py.File(H5_PATH, "a", locking=False) as hf:
            if "bare_cost" in hf:
                del hf["bare_cost"]
    done = own_keys("bare_cost")
    written = 0
    for gate in gate_list:
        gc, gg = gate.params[2], gate.params[3]
        if gc == 0 and gg == 0:
            continue  # the identity builds no coverage
        if str(gate) in done:
            logger.debug("%s already in file", gate)
            continue
        start = time.time()
        try:
            cov = gate_set_to_coverage(gate, bare_cost=True, max_layers=max_layers, device=device)
            haar_score = expected_cost(cov)
            cnot_score, _ = monodromy_range_from_target(cov, G.CNOT.to_numpy(), device)
            swap_score, _ = monodromy_range_from_target(cov, G.SWAP.to_numpy(), device)
        except (ValueError, RuntimeError) as e:
            logger.warning("scoring failed for %s: %s", gate, e)
            continue
        logger.info("scored %s in %.1fs: haar %.4f cnot %d swap %d", gate, time.time() - start, haar_score,
                    cnot_score, swap_score)
        # open, append, close per gate: a concurrent reader is never locked
        # out for a whole sweep, and a killed sweep keeps what it finished
        with h5py.File(H5_PATH, "a", locking=False) as hf:
            g = hf.require_group("bare_cost")
            if str(gate) not in g:
                g.create_dataset(
                    str(gate), data=np.array([list(gate.params), [haar_score, cnot_score, swap_score, -1, -1]])
                )
                written += 1
    return written


def load_candidates() -> List[Tuple[np.ndarray, np.ndarray]]:
    """Every (params, scores) row of ``bare_cost``, the port's file over the
    JAX package's."""
    return [(row[0], row[1]) for row in read_group("bare_cost").values()]
