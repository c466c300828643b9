"""The three chain solvers of the main path, each as a CUDA kernel wrapper
beside its plain PyTorch version (JAX ops/pallas_chain.py).

All three work per lane on the chain U(x) = L_k G_{k-1} ... L_1 G_0 L_0
(models/templates.chain_unitary) against a per-lane target T:

* ``adam_chain`` (JAX ``make_adam_chain``): Adam on the square cost
  1 - (|tr(T^dag U)|^2 + 4)/20 in f32, one step per row of the schedule.
* ``lm_chain`` (JAX ``make_lm_chain``): f32 Levenberg-Marquardt on the
  phase-aligned residual r = vec(U - e^{i phi} T); returns x and ||r||^2.
* ``polish_chain`` (JAX ``make_polish_chain``): the same LM with the
  residual and trial step in f64 (J, normal equations and CG stay f32, as
  in the JAX package's ``lm_one``); returns x and the final accepted
  ||r||^2 in f64, from which the solver derives the certified cost.

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel (csrc/*.cu) or raises; there is no
fallback. Each wrapper counts its launches in ``<wrapper>.launches``;
``lane_counts()`` gives the lanes of each wrapper's calls, launched or plain.
While the program's tracing is on (``utils.profiling``), each call also
adds its launch and lanes to the program's table under (wrapper, k,
iterations), and the LM and the polish count the iterations that build J, A
and b, lane by lane, into that key's accumulator: the kernels on the card,
the plain versions on the CPU.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from slam_decomposition_torch.models.templates import chain_unitary
from slam_decomposition_torch.utils import profiling

# chain depths with a CUDA kernel (csrc/chain_common.cuh kMaxK): 1..12 as
# one template instance each (INSTANCE_KS, kInstMaxK), 13..79 (n = 84..480)
# through the depth-generic programs (csrc/*_generic.cu*, K a runtime
# argument; 79 is the deepest chain whose blocks fit in shared memory);
# depth 80 and deeper take the general solver
INSTANCE_KS = tuple(range(1, 13))
KERNEL_KS = tuple(range(1, 80))
# the main path's schedule (JAX bench.py:88-91, pallas_chain.py:688-699)
ADAM_ITERS, ADAM_LR, LM32_ITERS, LM_ITERS = 100, 0.1, 8, 6
CG_EXTRA_ITERS = 8  # CG runs n + 8 iterations (JAX gauss_newton._spd_solve)
LAM0, LAM_UP, LAM_DOWN, LAM_MIN, LAM_MAX = 1e-3, 8.0, 0.3, 1e-14, 1e3
FOUR_PI = 4.0 * math.pi


# ---------------------------------------------------------------- plain math


def adam_schedule(iters: int = ADAM_ITERS, device="cpu", lr: float = ADAM_LR) -> torch.Tensor:
    """(iters, 3) f32 rows [1/bias1, 1/bias2, lr] per Adam step, lr starting
    at ``lr`` and halving every iters/3 steps (JAX pallas_chain.py:688-699,
    gauss_newton.py:355-357)."""
    it = np.arange(iters, dtype=np.float64)
    sched = np.stack(
        [
            1.0 / (1.0 - 0.9 ** (it + 1.0)),
            1.0 / (1.0 - 0.999 ** (it + 1.0)),
            lr * 0.5 ** (it / (iters / 3.0)),
        ],
        axis=1,
    )
    return torch.as_tensor(sched, dtype=torch.float32, device=device)


def trace_overlap(U: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """tr(T^dag U) over the last two dims."""
    return (tgt.conj() * U).sum(dim=(-2, -1))


def square_cost(x: torch.Tensor, tgt: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """1 - (|tr(T^dag U(x))|^2 + 4) / 20 per lane, in x's precision."""
    t = trace_overlap(chain_unitary(x, gates), tgt)
    return 1.0 - (t.real**2 + t.imag**2 + 4.0) / 20.0


def phase_residual(x: torch.Tensor, tgt: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """r = vec(V - e^{i phi} T), phi = arg tr(T^dag V), as (..., 32) reals:
    16 real parts then 16 imaginary parts, row-major (JAX
    gauss_newton._phase_residual)."""
    V = chain_unitary(x, gates)
    t = trace_overlap(V, tgt)
    eps = 1e-30 if x.dtype == torch.float32 else 1e-300
    z = t / torch.sqrt(t.real**2 + t.imag**2 + eps)
    d = V - z[..., None, None] * tgt
    return torch.cat([d.real.flatten(-2), d.imag.flatten(-2)], dim=-1)


def jacobian(fn, x: torch.Tensor) -> torch.Tensor:
    """(L, m, n) Jacobian of a per-lane function fn: (L, n) -> (L, m) by
    forward mode.

    This is what ``torch.func.jacfwd`` does per lane (one JVP per one-hot
    tangent, vmapped over the tangents), applied to all lanes at once: the
    lanes are independent, so the tangent e_p on every lane gives column p
    of every lane's Jacobian. Batching the lanes instead of vmapping over
    them also keeps the primal tensors at least 1-d (this torch promotes
    the tangent of a 0-d tensor times a Python float to f64)."""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)[:, None, :].expand(n, *x.shape)

    def column(v):
        return torch.func.jvp(fn, (x,), (v,))[1]

    return torch.func.vmap(column)(basis).permute(1, 2, 0)


def _cg(A: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Batched CG on SPD (L, n, n) systems, fixed iteration count. The
    guards are the dtype's smallest normal number: a smaller one would
    underflow in f32 and give 0/0 the moment CG converges exactly."""
    tiny = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b)
    r = b
    p = b
    rs = (b * b).sum(-1)
    for _ in range(iters):
        Ap = (A @ p[..., None])[..., 0]
        alpha = rs / torch.clamp_min((p * Ap).sum(-1), tiny)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rs_new = (r * r).sum(-1)
        p = r + (rs_new / torch.clamp_min(rs, tiny))[:, None] * p
        rs = rs_new
    return x


def lm_loop(res_fn, res32_fn, x, iters: int, project=None, history: bool = False, rebuilds=None):
    """Mixed-precision Levenberg-Marquardt on per-lane residuals (JAX
    gauss_newton.lm_one): ``res_fn(x)`` (L, n) -> (L, m) gives the residual,
    the trial step and the accept test in x's dtype; ``res32_fn`` is the same
    function on the f32 cast of x (and of its data), whose Jacobian, normal
    equations and n + 8 CG iterations only steer (they run in the dtype that
    ``res32_fn`` returns: f32 unless the template evaluates in f64 itself).
    lam starts at 1e-3, x0.3 on an accepted step and x8 on a rejected one,
    clipped to [1e-14, 1e3]; a NaN trial step is "not improved". ``project``
    clamps a trial point into the bounds. Returns (x, final accepted
    ||r||^2), and with ``history`` also the accepted ||r||^2 after each
    iteration, (L, iters). ``rebuilds`` (an int64 tensor) gets the number of
    iterations, summed over the lanes, in which a kernel builds J, A and b:
    the first, and each after an accepted step (this loop builds them in
    every iteration; a kernel keeps them where x did not move)."""
    n = x.shape[-1]
    r = res_fn(x)
    f0 = (r * r).sum(-1)
    lam = torch.full_like(f0, LAM0)
    fresh = torch.ones_like(f0, dtype=torch.bool)  # x moved since J was last built
    hist = []
    for _ in range(iters):
        if rebuilds is not None:
            rebuilds += fresh.sum()
        J = jacobian(res32_fn, x.float())
        Jt = J.transpose(-2, -1)
        eye = torch.eye(n, dtype=J.dtype, device=x.device)
        A = Jt @ J + lam.float().to(J.dtype)[:, None, None] * eye
        g = (Jt @ r.float().to(J.dtype)[..., None])[..., 0]
        dx = _cg(A, -g, n + CG_EXTRA_ITERS)
        xn = x + dx.to(x.dtype)
        if project is not None:
            xn = project(xn)
        rn = res_fn(xn)
        fn = (rn * rn).sum(-1)
        imp = fn < f0  # NaN < f0 is False
        fresh = imp
        lam = torch.where(imp, lam * LAM_DOWN, lam * LAM_UP).clamp(LAM_MIN, LAM_MAX)
        x = torch.where(imp[:, None], xn, x)
        r = torch.where(imp[:, None], rn, r)
        f0 = torch.where(imp, fn, f0)
        if history:
            hist.append(f0)
    if history:
        return x, f0, torch.stack(hist, dim=1) if hist else f0.new_zeros((x.shape[0], 0))
    return x, f0


def lm_chain_ref(x, tgt, gates, iters: int = LM32_ITERS, rebuilds=None):
    """Plain mixed-precision LM on the chain's phase residual: the residual,
    trial step and accept test in x's dtype (f32 for the ranking pass, f64
    for the polish); J, normal equations and CG in f32. Returns (x, final
    accepted ||r||^2); ``rebuilds`` counts J's builds as the kernel does
    (``lm_loop``)."""
    tgt32 = tgt.to(torch.complex64)
    gates32 = gates.to(torch.complex64)
    return lm_loop(
        lambda x1: phase_residual(x1, tgt, gates), lambda x1: phase_residual(x1, tgt32, gates32), x, iters,
        rebuilds=rebuilds,
    )


def adam_loop(cost_fn, x0, sched, project=None, history: bool = False):
    """Plain Adam on a per-lane cost ``cost_fn(x)`` (L, n) -> (L,): one step
    per schedule row [1/bias1, 1/bias2, lr], gradients by reverse-mode
    autograd of the summed cost (the lanes are independent), cast to x's
    dtype; ``project`` clamps each new point into the bounds. With
    ``history`` also the cost before each step, (L, iters) in x's dtype."""
    x = x0.clone()
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    hist = []
    for i in range(sched.shape[0]):
        xg = x.detach().requires_grad_(True)
        f = cost_fn(xg)
        (g,) = torch.autograd.grad(f.sum(), xg)
        g = g.to(x.dtype)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * (g * g)
        mhat = m * sched[i, 0]
        vhat = v * sched[i, 1]
        x = x - sched[i, 2] * mhat / (torch.sqrt(vhat) + 1e-8)
        if project is not None:
            x = project(x)
        if history:
            hist.append(f.detach().to(x.dtype))
    if history:
        return x, torch.stack(hist, dim=1) if hist else x.new_zeros((x.shape[0], 0))
    return x


def adam_chain_ref(x0, tgt, gates, sched, with_cost: bool = False):
    """Plain Adam on the chain's square cost. With ``with_cost`` also the
    square cost at the final x."""
    x = adam_loop(lambda x1: square_cost(x1, tgt, gates), x0, sched)
    return (x, square_cost(x, tgt, gates)) if with_cost else x


def reduce_angles(x: torch.Tensor) -> torch.Tensor:
    """x mod 4 pi into [-2 pi, 2 pi]: u3 is exactly invariant under any
    angle += 4 pi (JAX pallas_chain.py:629-630)."""
    return x - FOUR_PI * torch.round(x / FOUR_PI)


def polish_chain_ref(x, tgt, gates, iters: int = LM_ITERS, rebuilds=None):
    """Plain f64 polish -> (x, final accepted ||r||^2 in f64)."""
    return lm_chain_ref(reduce_angles(x), tgt, gates, iters, rebuilds)


# ---------------------------------------------------------------- wrappers


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_lanes(x, tgt, gates, xdtype, cdtype):
    if x.ndim != 2 or gates.ndim != 3:
        raise ValueError(f"x must be (L, n) and gates (k, 4, 4), got {tuple(x.shape)}, {tuple(gates.shape)}")
    L, n = x.shape
    k = gates.shape[0]
    if n != 6 * (k + 1):
        raise ValueError(f"x has {n} params per lane, a depth-{k} chain has {6 * (k + 1)}")
    _check("x", x, xdtype, (L, n), x.device)
    _check("tgt", tgt, cdtype, (L, 4, 4), x.device)
    _check("gates", gates, cdtype, (k, 4, 4), x.device)
    return L, n, k


def _kernel_target(x, k):
    """True for a CUDA launch, False for the CPU's plain version; raises
    for any other device and for depths without a kernel (the solver routes
    those to its general path before it gets here)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if k not in KERNEL_KS:
        raise ValueError(f"the CUDA kernels are built for k in {KERNEL_KS}, got k={k}")
    return True


def _launch(fn_name, *args):
    from slam_decomposition_torch.ops import _build

    lib = _build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: {_build.error_string(err)} ({err})")


def _p(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _p_or_null(t):
    return None if t is None else _p(t)


def adam_chain(x0, tgt, gates, sched, with_cost: bool = False):
    """Adam warm start: x0 (L, n) f32, tgt (L, 4, 4) complex64, gates
    (k, 4, 4) complex64, sched (iters, 3) f32 -> x (L, n) f32, or with
    ``with_cost`` (x, square cost at x (L,) f32), from the kernel instance
    that ends with one more chain evaluation (JAX ``make_adam_chain``'s
    ``with_cost``)."""
    L, n, k = _check_lanes(x0, tgt, gates, torch.float32, torch.complex64)
    _check("sched", sched, torch.float32, (sched.shape[0], 3), x0.device)
    _lanes["adam_chain"].append(L)
    profiling.count_launch("adam_chain", k, sched.shape[0], L)
    if not _kernel_target(x0, k):
        return adam_chain_ref(x0, tgt, gates, sched, with_cost)
    out = torch.empty_like(x0)
    cost = torch.empty(L, dtype=torch.float32, device=x0.device) if with_cost else None
    _launch(
        "slam_adam_chain", _p(x0), _p(tgt), _p(gates), _p(sched),
        ctypes.c_int(sched.shape[0]), ctypes.c_int(k), ctypes.c_int(L), _p(out),
        _p(cost) if with_cost else None,
    )
    adam_chain.launches += 1
    return (out, cost) if with_cost else out


def lm_chain(x, tgt, gates, iters: int = LM32_ITERS):
    """f32 LM ranking pass: x (L, n) f32, tgt complex64, gates complex64
    -> (x (L, n) f32, ||r||^2 (L,) f32)."""
    L, n, k = _check_lanes(x, tgt, gates, torch.float32, torch.complex64)
    _lanes["lm_chain"].append(L)
    rebuilds = profiling.count_launch("lm_chain", k, iters, L, x.device)
    if not _kernel_target(x, k):
        return lm_chain_ref(x, tgt, gates, iters, rebuilds)
    xo = torch.empty_like(x)
    fo = torch.empty(L, dtype=torch.float32, device=x.device)
    _launch(
        "slam_lm_chain", _p(x), _p(tgt), _p(gates), ctypes.c_int(iters),
        ctypes.c_int(k), ctypes.c_int(L), _p(xo), _p(fo), _p_or_null(rebuilds),
    )
    lm_chain.launches += 1
    return xo, fo


def polish_chain(x, tgt, gates, iters: int = LM_ITERS):
    """f64 LM polish: x (L, n) f64, tgt complex128, gates complex128 ->
    (x (L, n) f64 with angles reduced mod 4 pi, ||r||^2 (L,) f64)."""
    L, n, k = _check_lanes(x, tgt, gates, torch.float64, torch.complex128)
    _lanes["polish_chain"].append(L)
    rebuilds = profiling.count_launch("polish_chain", k, iters, L, x.device)
    if not _kernel_target(x, k):
        return polish_chain_ref(x, tgt, gates, iters, rebuilds)
    xo = torch.empty_like(x)
    fo = torch.empty(L, dtype=torch.float64, device=x.device)
    _launch(
        "slam_polish_chain", _p(x), _p(tgt), _p(gates), ctypes.c_int(iters),
        ctypes.c_int(k), ctypes.c_int(L), _p(xo), _p(fo), _p_or_null(rebuilds),
    )
    polish_chain.launches += 1
    return xo, fo


WRAPPERS = (adam_chain, lm_chain, polish_chain)


_lanes: dict = {w.__name__: [] for w in WRAPPERS}  # the lanes of each call since the last reset


def reset_launch_counts() -> None:
    """Sets every wrapper's launch count to 0 and forgets its calls' lanes."""
    for w in WRAPPERS:
        w.launches = 0
        _lanes[w.__name__].clear()


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


def lane_counts() -> dict:
    """{wrapper: [the lanes of each call since the last reset]}."""
    return {name: list(v) for name, v in _lanes.items()}


reset_launch_counts()
