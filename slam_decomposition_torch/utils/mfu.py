"""FLOP model of the three chain kernels, and their bounds on an H100.

The per-step counts below are the JAX package's own (its utils/mfu.py),
copied so that both packages reckon the same work; only the peaks differ.
The LM's launch bounds take a smaller count of J and A (see below).
Counts are per lane. Conventions: a real multiply or add is 1 flop, a transcendental
(sin, cos, rsqrt) 8, a complex multiply 6.

* Forward chain F (``chain_flops``): per layer two u3 (8 transcendentals
  and ~10 multiplies each) and the 4x4 Kronecker product (16 complex
  multiplies); per gate the sparse sqiSwap product (~112) and one dense 4x4
  complex product (480).
* Adam step (``adam_iter_flops``): value and reverse gradient of the square
  cost (~3F), the trace (64) and the update (8n).
* LM iteration (``lm_iter_flops``): J by forward mode ((1 + 1.5n) F),
  normal equations (64n^2 + 64n), CG ((n + 8)(2n^2 + 6n)) and the trial
  residual (F).

The launch bounds charge the LM and the polish with less: the work their
function needs, not the JAX package's way of computing it. J comes from
the prefix products P_i (those of the forward chain, already charged in
F) and the suffix products S_i: one suffix chain (``suffix_flops``: per
gate, two u3 from the forward chain's sines and cosines, the layer applied
to 4 rows and the sparse gate product) and, per column,
dU/dx_p = S_i (dL_i/dx_p) P_i with the phase factor's derivative
(``JAC_COLUMN_FLOPS``). A = J^T J is symmetric: its upper triangle costs
32n(n + 1), b = -J^T r 64n (``lm_rebuild_flops``). CG and the residuals
are as above.

The bound of a launch is the least time the card could take for its work:
the larger of its flops over the peak rate of their type and the bytes it
must move (each input read once, each output written once) over the memory
rate. The chain kernels have no matrix product large enough for the tensor
cores, so their peak is the f32 rate outside them. The polish's trial and
initial residuals run in native f64 here (the TPU ran them in double-single
at ~10x the f32 work, which ``df64_residual`` keeps for the JAX count): the
port charges them F flops each at the f64 rate, and its J, normal equations
and CG at the f32 rate. The same schedulers issue both types, and f32 at
its peak rate takes every issue slot, so the two times add.

Where the work depends on the data, the caller passes what this run needs:
``fresh`` is the number of LM iterations per lane that rebuild J, A and b
(the first, and each after an accepted step; a rejected step leaves x and
so J unchanged).
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


def lm_iter_flops(k: int, df64_residual: bool = False) -> float:
    """One LM iteration: J, normal equations, CG and the trial residual
    (F in f32, ~10F in double-single)."""
    rebuild, cg, F = _lm_parts(k)
    return rebuild + cg + (10.0 if df64_residual else 1.0) * F


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


def solve_flops_per_target(
    k: int, restarts: int, adam_iters: int = 100, lm32_iters: int = 8,
    polish_iters: int = 6, cert: str = "df64",
) -> float:
    """Per-target flops of the three-phase solve as the JAX package counts
    it: Adam and f32 LM on every restart, the double-single polish on the
    winner and one double-single initial residual; "f64" certification adds
    a 20F chain evaluation."""
    per_lane = adam_iters * adam_iter_flops(k) + lm32_iters * lm_iter_flops(k)
    winner = polish_iters * lm_iter_flops(k, df64_residual=True) + 10 * chain_flops(k)
    certify = 20.0 * chain_flops(k) if cert == "f64" else 0.0
    return restarts * per_lane + winner + certify


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
