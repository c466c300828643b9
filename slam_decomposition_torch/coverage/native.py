"""The exact-rational polytope core in C++ (``csrc/polytope_core.cpp``),
loaded with ctypes (JAX native/__init__.py).

The first call in a process compiles the core with
``g++ -O2 -fPIC -shared -std=c++17`` into ``build/slam_polytope/`` at the
root of the checkout, under a name hashed from the source and the flags,
unless that library is there already. A failed build raises: the engine
does not quietly fall back to Python for good.

Each call returns None where the core cannot answer in int64 (an entry over
2^62, or the core's overflow code): the caller then takes the Fractions
path, which gives the same exact answer.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
from fractions import Fraction
from typing import Optional, Sequence, Tuple

import numpy as np

from slam_decomposition_torch.config import polytope_build_dir

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "polytope_core.cpp"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return polytope_build_dir() / f"libslam_polytope_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The core, compiled first if its library is missing. Raises
    RuntimeError when g++ is missing or fails."""
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                  capture_output=True, text=True, check=False)
        except OSError as e:
            raise RuntimeError(f"g++ not found: the coverage engine's polytope core needs it ({e})") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent processes each install a whole library
    lib = ctypes.CDLL(str(out))
    lib.slam_lp_max.restype = ctypes.c_int
    lib.slam_lp_max.argtypes = [_I64P, ctypes.c_int, _I64P, ctypes.c_int, _I64P, ctypes.c_int, _I64P, _I64P]
    lib.slam_reduce.restype = ctypes.c_int
    lib.slam_reduce.argtypes = [_I64P, ctypes.c_int, _I64P, ctypes.c_int, ctypes.c_int, _U8P, _U8P]
    return lib


def _pack(rows: Sequence[Sequence[Fraction]], width: int) -> np.ndarray:
    """Rows as (num, den) int64 pairs; OverflowError past 2^62."""
    out = np.empty((max(len(rows), 1), width, 2), dtype=np.int64)
    for i, r in enumerate(rows):
        for j, x in enumerate(r):
            f = Fraction(x)
            if abs(f.numerator) > 2**62 or f.denominator > 2**62:
                raise OverflowError
            out[i, j, 0] = f.numerator
            out[i, j, 1] = f.denominator
    return out


def _ptr(a: np.ndarray, kind=_I64P):
    return a.ctypes.data_as(kind)


def lp_max_native(objective, ineqs, eqs) -> Optional[Tuple[str, Optional[Fraction]]]:
    """polytope.lp_max in the core; None: take the Fractions path."""
    lib = load()
    n = len(objective)
    try:
        I = _pack(ineqs, n + 1)
        E = _pack(eqs, n + 1)
        O = _pack([list(objective)], n)
    except OverflowError:
        return None
    num, den = ctypes.c_int64(), ctypes.c_int64()
    st = lib.slam_lp_max(_ptr(I), len(ineqs), _ptr(E), len(eqs), _ptr(O), n, ctypes.byref(num), ctypes.byref(den))
    if st == 0:
        return "optimal", Fraction(num.value, den.value)
    if st == 1:
        return "unbounded", None
    if st == 2:
        return "infeasible", None
    return None  # overflow in the core


def reduce_native(ineqs, eqs, n_vars: int):
    """ConvexPolytope.reduce's two passes in the core: (keep mask, implied
    equality mask, empty) over ``ineqs``, or None: take the Fractions path."""
    lib = load()
    try:
        I = _pack(ineqs, n_vars + 1)
        E = _pack(eqs, n_vars + 1)
    except OverflowError:
        return None
    keep = np.zeros(max(len(ineqs), 1), dtype=np.uint8)
    eqf = np.zeros(max(len(ineqs), 1), dtype=np.uint8)
    st = lib.slam_reduce(_ptr(I), len(ineqs), _ptr(E), len(eqs), n_vars, _ptr(keep, _U8P), _ptr(eqf, _U8P))
    if st in (0, 1):
        return keep[: len(ineqs)].astype(bool), eqf[: len(ineqs)].astype(bool), st == 1
    return None  # overflow in the core
