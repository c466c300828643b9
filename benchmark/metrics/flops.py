"""FLOP and byte counts of the three chain kernels' launches, and their
bounds on an H100: a frozen copy, for the benchmark's rooflines, of
`slam_decomposition_torch/utils/mfu.py` (`chain_flops` .. `lm_rebuild_flops`,
`_bound`, `adam_launch`, `lm_launch`, `polish_launch` and the peaks), as the
port had it when the benchmark was defined.
`benchmark/tests/test_perfbench_copies.py` holds it equal to the port's.

Counts are per lane: a real multiply or add is 1 flop, a transcendental
(sin, cos, rsqrt) 8, a complex multiply 6. A launch's bound is the larger of
its flops over the peak rate of their type and the bytes it must move (each
input read once, each output written once) over the memory rate. The LM's
and the polish's J, A and b are charged only on the iterations that rebuild
them (``fresh``: the first, and each after an accepted step), which the
caller counts for its inputs.
"""

from __future__ import annotations

# H100 SXM, dense, at the 700 W power limit (NVIDIA's data sheet)
F32_PEAK = 67e12  # FLOP/s outside the tensor cores
F64_PEAK = 34e12  # FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

TRANS = 8  # flops charged per transcendental (sin/cos/rsqrt)


def chain_flops(k: int) -> float:
    """One f32 forward chain U = L_k G_{k-1} ... L_0."""
    layer = 2 * (8 * TRANS + 10) + 16 * 6
    return (k + 1) * layer + k * (112 + 480)


def adam_iter_flops(k: int) -> float:
    """One Adam step: value and reverse gradient, trace, update."""
    n = 6 * (k + 1)
    return 3.0 * chain_flops(k) + 16 * 4 + 8 * n


def _lm_parts(k: int):
    n = 6 * (k + 1)
    F = chain_flops(k)
    jac = (1 + 1.5 * n) * F
    normal = 64 * n * n + 64 * n
    cg = (n + 8) * (2 * n * n + 6 * n)
    return jac + normal, cg, F


# one column of J: the two factors of dL_i/dx_p (u3 and its derivative from
# sines and cosines, ~10 each); for each of P_i's 4 columns the layer's
# Kronecker factors applied to it (16 complex multiplies, 8 adds), S_i
# times the result (16, 12) and its part of tr(T^dag dU) (4, 4); the phase
# term (6 real, then 16 complex multiplies and 32 real subtractions)
JAC_COLUMN_FLOPS = 2 * 10 + 4 * ((16 * 6 + 8 * 2) + (16 * 6 + 12 * 2) + (4 * 6 + 4 * 2)) + 6 + 16 * 6 + 32


def suffix_flops(k: int) -> float:
    """The suffix products S_k..S_1 of one chain: per gate two u3 (~10
    each, no transcendentals), the layer applied to the 4 rows (16 complex
    multiplies and 8 adds each) and the sparse gate product (~112)."""
    return k * (2 * 10 + 4 * (16 * 6 + 8 * 2) + 112)


def lm_rebuild_flops(k: int) -> float:
    """J, A and b of one LM iteration as the function needs them: one suffix
    chain, n columns of J, A's upper triangle and b."""
    n = 6 * (k + 1)
    return suffix_flops(k) + n * JAC_COLUMN_FLOPS + 32 * n * (n + 1) + 64 * n


def _bound(f32: float, f64: float, nbytes: float) -> dict:
    t_ops = f32 / F32_PEAK + f64 / F64_PEAK
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {
        "flops": f32 + f64,
        "bytes": nbytes,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def adam_launch(k: int, lanes: int, iters: int, with_cost: bool = False) -> dict:
    """{"flops", "bytes", "bound_ms", "bound_by"} of one adam_chain launch:
    reads x0 (n f32) and T (16 complex64) per lane, the gates and the
    schedule, writes x; ``with_cost``: also one chain evaluation a lane at
    the final x and its cost written."""
    n = 6 * (k + 1)
    nbytes = lanes * (2 * n + 32 + with_cost) * 4 + k * 128 + iters * 12
    return _bound(lanes * (iters * adam_iter_flops(k) + with_cost * chain_flops(k)), 0.0, nbytes)


def lm_launch(k: int, lanes: int, iters: int, fresh: float | None = None) -> dict:
    """One lm_chain launch: the initial residual and ``iters`` iterations per
    lane, of which ``fresh`` per lane (on average; default all) rebuild J, A
    and b (``lm_rebuild_flops``). Reads x0 and T, writes x and ||r||^2."""
    _, cg, F = _lm_parts(k)
    rebuild = lm_rebuild_flops(k)
    fresh = iters if fresh is None else fresh
    n = 6 * (k + 1)
    nbytes = lanes * (2 * n + 32 + 1) * 4 + k * 128
    return _bound(lanes * (fresh * rebuild + iters * (cg + F) + F), 0.0, nbytes)


def polish_launch(k: int, lanes: int, iters: int, fresh: float | None = None) -> dict:
    """One polish_chain launch: as lm_launch, with the initial and trial
    residuals in f64 at the f64 rate and all data in f64. The count is by
    the function, not by the kernel: each f64 residual is charged a dense
    chain F although the kernel multiplies by the gates through their
    nonzeros, and the f32 chain at float(x) that J's prefix products come
    from is not charged (the f32 LM has it from its trial residual)."""
    _, cg, F = _lm_parts(k)
    rebuild = lm_rebuild_flops(k)
    fresh = iters if fresh is None else fresh
    n = 6 * (k + 1)
    nbytes = lanes * (2 * n + 32 + 1) * 8 + k * 256
    return _bound(lanes * (fresh * rebuild + iters * cg), lanes * (iters + 1) * F, nbytes)
