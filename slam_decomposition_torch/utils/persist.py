"""Content-hash-keyed persistence (JAX utils/persist.py): one file-name
encoder, tolerant pickle and json loads, a resumable HDF5 store, and ragged
rows to and from a padded array.

The JAX package roots its encoder at its own data directory, which it
writes. The port writes only under ``build/`` (``config.cache_dir``), so
the encoder takes the directory.
"""

from __future__ import annotations

import hashlib
import json
import pickle
from pathlib import Path
from typing import Dict

import numpy as np


def filename_encode(key: str, directory, suffix: str = ".pkl") -> Path:
    """Stable content-hash path for a string key: ``<directory>/<sha1 of
    key><suffix>``."""
    return Path(directory) / f"{hashlib.sha1(key.encode()).hexdigest()}{suffix}"


def pickle_load(path, default=None):
    """The pickled object, or ``default`` ({} when None) on a missing or
    unreadable file."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (OSError, EOFError, pickle.PickleError):
        return {} if default is None else default


def pickle_save(path, obj) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def json_load(path, default=None):
    try:
        return json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError):
        return {} if default is None else default


def json_save(path, obj) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(obj, indent=1))


def h5_save(path, group: str, key: str, data, overwrite: bool = False) -> None:
    """Store ``data`` as ``group/key``; an existing key is kept unless
    ``overwrite`` (skip-if-present resume)."""
    import h5py

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "a") as hf:
        g = hf.require_group(group)
        if key in g:
            if not overwrite:
                return
            del g[key]
        g.create_dataset(key, data=np.asarray(data))


def h5_load_group(path, group: str) -> Dict[str, np.ndarray]:
    """{key: array} of ``group``, read without h5py (``utils.hdf5``)."""
    from slam_decomposition_torch.utils.hdf5 import read_group

    return read_group(path, group)


def ragged_to_padded(rows, fill=np.nan) -> np.ndarray:
    """Ragged list of lists -> (len(rows), longest) float array."""
    n = max(len(r) for r in rows)
    out = np.full((len(rows), n), fill, dtype=float)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def padded_to_ragged(arr, fill=np.nan):
    """Inverse of ragged_to_padded."""
    out = []
    for row in np.asarray(arr):
        mask = ~np.isnan(row) if np.isnan(fill) else row != fill
        out.append(list(row[mask]))
    return out
