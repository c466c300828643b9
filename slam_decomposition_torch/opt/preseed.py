"""Preseeding store: solved decompositions keyed by Weyl coordinate (JAX
opt/preseed.py). Host numpy arrays pickled by a hash of the store's key
under ``config.preseed_dir()`` (``build/slam_preseed``); a store the JAX
package saved in its data directory is read there, never written. The
nearest stored neighbour of each target's coordinate, found with a KD-tree,
seeds restart 0 of a later solve.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from slam_decomposition_torch.config import data_dir, preseed_dir
from slam_decomposition_torch.utils.persist import filename_encode, pickle_load, pickle_save

_FIELDS = ("coords", "params", "cycles", "losses")


def store_path(key: str) -> Path:
    """The store's file: ``preseed_dir()``, by the sha1 of the key."""
    return filename_encode(key, preseed_dir())


@dataclasses.dataclass
class PreseedStore:
    key: str
    coords: np.ndarray  # (n, 3)
    params: np.ndarray  # (n, max_params) padded with nan
    cycles: np.ndarray  # (n,)
    losses: np.ndarray  # (n,)

    @classmethod
    def load(cls, key: str) -> "PreseedStore":
        """The saved store of ``key`` (the port's own, else one in the data
        directory), or an empty one."""
        data = pickle_load(store_path(key)) or pickle_load(filename_encode(key, data_dir()))
        if not data:
            return cls(key, np.zeros((0, 3)), np.zeros((0, 0)), np.zeros(0, int), np.zeros(0))
        return cls(key, **{k: data[k] for k in _FIELDS})

    def save(self) -> None:
        pickle_save(store_path(self.key), {k: getattr(self, k) for k in _FIELDS})

    def __len__(self):
        return len(self.coords)

    def add(self, coords, params, cycles, losses) -> None:
        coords = np.atleast_2d(coords)
        params = np.atleast_2d(params)
        width = max(self.params.shape[1], params.shape[1])

        def widen(p):
            return np.concatenate([p, np.full((len(p), width - p.shape[1]), np.nan)], axis=1)

        self.coords = np.concatenate([self.coords, coords])
        self.params = np.concatenate([widen(self.params), widen(params)])
        self.cycles = np.concatenate([self.cycles, np.atleast_1d(cycles)])
        self.losses = np.concatenate([self.losses, np.atleast_1d(losses)])

    def nearest(self, query_coords) -> Tuple[np.ndarray, np.ndarray]:
        """(indices, distances) of the nearest stored entry of each query
        coordinate; (-1, inf) from an empty store."""
        q = np.atleast_2d(query_coords)
        if len(self) == 0:
            return np.full(len(q), -1), np.full(len(q), np.inf)
        dist, idx = cKDTree(self.coords).query(q)
        return idx, dist

    def seeds_for(
        self,
        query_coords,
        n_params: int,
        cycles: int,
        temperature: float = 0.0,
        rng: Optional[np.random.Generator] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per query a seed vector (nan where there is none) and whether it
        is usable: the nearest neighbour's parameters, jittered by +-5% times
        ``temperature``, if that entry was solved at the same cycle count
        and has n_params parameters."""
        rng = rng or np.random.default_rng(0)
        q = np.atleast_2d(query_coords)
        out = np.full((len(q), n_params), np.nan)
        ok = np.zeros(len(q), dtype=bool)
        idx, _ = self.nearest(q)
        for i, j in enumerate(idx):
            if j < 0 or self.cycles[j] != cycles:
                continue
            p = self.params[j, :n_params]
            if np.isnan(p).any():
                continue
            out[i] = p * rng.uniform(1 - 0.05 * temperature, 1 + 0.05 * temperature, n_params)
            ok[i] = True
        return out, ok
