"""The JAX package's random draws, in numpy: ``jax.random.uniform(
jax.random.PRNGKey(seed), shape, float64, minval, maxval)`` bit for bit,
without jax.

The explore pipelines draw their starts this way in the JAX package
(``explore/oct.py``, ``explore/smush_volume.py``), and what they find
depends on the draw: whether a targeted descent reaches the SWAP vertex
within the hull's tolerance, for one, decides a row of
``extended_results.json``. Drawing the same numbers lets the port reproduce
those rows instead of their statistics.

The generator is Threefry-2x32 (20 rounds, Salmon et al., SC 2011) as JAX
(>= 0.5, ``jax_threefry_partitionable`` on, 64-bit types) applies it: the
key of a seed is its two 32-bit halves, the counter of an element its
row-major index split the same way, and a float64 takes the top 52 of the
64 bits as its mantissa in [1, 2), minus 1, scaled to [minval, maxval)
by one fused multiply-add (XLA fuses it on the CPU, where the JAX package's
data files were drawn). ``tests/test_torch_smush_volume.py`` holds it to
jax.random bit for bit.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 of the counter words (x1, x2) under the key (k1, k2):
    two uint32 arrays."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ _PARITY)
    x = [x1.astype(np.uint32) + ks[0], x2.astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits64(seed: int, shape) -> np.ndarray:
    """jax.random.bits(PRNGKey(seed), shape, uint64)."""
    seed = int(seed)
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        hi, lo = threefry2x32(
            (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF,
            (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        )
    return ((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)).reshape(shape)


def _fma(a: np.ndarray, b: float, c: float) -> np.ndarray:
    """a * b + c rounded once, as XLA's fused multiply-add on the CPU gives
    it: exact integer arithmetic, then CPython's correctly rounded integer
    division."""
    bn, bd = float(b).as_integer_ratio()
    cn, cd = float(c).as_integer_ratio()
    out = [
        (xn * bn * cd + cn * xd * bd) / (xd * bd * cd)
        for xn, xd in (x.as_integer_ratio() for x in a.ravel().tolist())
    ]
    return np.asarray(out, dtype=np.float64).reshape(a.shape)


def uniform(seed: int, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform(PRNGKey(seed), shape, float64, minval, maxval) as
    a float64 numpy array, bit for bit the JAX package's draw on the CPU."""
    bits = random_bits64(seed, shape)
    one = np.array(1.0).view(np.uint64)
    floats = ((bits >> np.uint64(12)) | one).view(np.float64) - 1.0
    return np.maximum(float(minval), _fma(floats, float(maxval) - float(minval), float(minval)))
