"""Cartan trajectories and pulse synthesis of parallel-driven gates (JAX
models/trajectory.py).

``smush_prefix_unitaries`` gives every prefix product of a pulse's Trotter
slices and ``smush_trajectory`` their Weyl coordinates. The solvers fit
piecewise-constant 1Q drives riding a conversion / gain coupling to a
target: ``drive_pulse_for_target`` with one driven application,
``drive_sequence_for_target`` with a sequence of them, each a Makhlin class
fit, exact outer locals by KAK sandwich, and a full-parameter polish
(``improved_cx``, ``improved_swap_two_pulse``, ``improved_swap``).

Every solve goes through ``opt.gauss_newton.make_solver`` with the JAX
call's counts. The driven templates take ``GeneralSolver`` (plain PyTorch);
``improved_swap(exact=True)`` is a 3-application chain over a fixed gate,
so it takes ``ChainSolver``: the three CUDA kernels on the card, their
plain versions on the CPU. Starts are drawn from ``np.random.default_rng``
in the JAX package's order, so both packages start from the same x. The
entry points run on the card unless ``device`` names another.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.models import hamiltonians as ham
from slam_decomposition_torch.models.templates import layer_1q
from slam_decomposition_torch.ops import weyl
from slam_decomposition_torch.ops.expm import expm_taylor


def _on(device, *params):
    """Numbers and arrays as f64 tensors on ``device``."""
    return [torch.as_tensor(p, dtype=torch.float64, device=device) for p in params]


def prefix_products(Us: torch.Tensor) -> torch.Tensor:
    """All prefix products U_k ... U_1, k = 1..n, of (..., n, d, d) slices
    (the later slice on the left) by log-depth doubling: after the step of
    stride s, entry k holds the product of slices max(0, k - 2s + 1)..k."""
    n = Us.shape[-3]
    P = Us
    s = 1
    while s < n:
        P = torch.cat([P[..., :s, :, :], P[..., s:, :, :] @ P[..., :-s, :, :]], dim=-3)
        s *= 2
    return P


def smush_prefix_unitaries(
    phi_c, phi_g, gc, gg, gx_vec, gy_vec, t=1.0, dts=None, device=DEFAULT_DEVICE
) -> torch.Tensor:
    """All prefix products U_1..k of the Trotter slices, k = 1..N, as (N, 4,
    4) complex on ``device``. ``dts`` optionally gives per-slice durations;
    the default is uniform t / N."""
    dev = resolve_device(device)
    phi_c, phi_g, gc, gg, gx, gy = _on(dev, phi_c, phi_g, gc, gg, gx_vec, gy_vec)
    n = gx.shape[-1]
    dts = torch.full((n,), float(t) / n, dtype=torch.float64, device=dev) if dts is None else _on(dev, dts)[0]
    H = ham.smush_h(phi_c, phi_g, gc, gg, gx, gy)
    return prefix_products(expm_taylor(-1j * (dts[:, None, None] * H)))


def smush_trajectory(phi_c, phi_g, gc, gg, gx_vec, gy_vec, t=1.0, device=DEFAULT_DEVICE) -> np.ndarray:
    """Weyl-coordinate trajectory (N, 3) of the pulse's partial evolutions."""
    Us = smush_prefix_unitaries(phi_c, phi_g, gc, gg, gx_vec, gy_vec, t, device=device)
    return weyl.c1c2c3(Us).cpu().numpy()


def _pulse_fn(gc, gg, t, n_slices):
    """x (..., 2 + 2 n) [phi_c, phi_g, gx[n], gy[n]] -> the driven pulse."""
    return lambda x: ham.smush_u(
        x[..., 0], x[..., 1], gc, gg, x[..., 2 : 2 + n_slices], x[..., 2 + n_slices : 2 + 2 * n_slices], t=t
    )


def _layer(x6, like: torch.Tensor) -> torch.Tensor:
    """The u3 layer of x6 in x6's precision, promoted to the driven core's
    complex dtype (the pulses evaluate in f64 whatever x's dtype, as the
    JAX package's do)."""
    return layer_1q(x6).to(like.dtype)


def _with_locals(core_fn, n_core):
    """x (..., n_core + 12) -> L2 core(x[:n_core]) L1, each L a u3 layer."""

    def full_fn(x):
        U = core_fn(x[..., :n_core])
        return _layer(x[..., n_core + 6 :], U) @ (U @ _layer(x[..., n_core : n_core + 6], U))

    return full_fn


def _u3(p) -> np.ndarray:
    from slam_decomposition_torch.ops import su2

    p = torch.as_tensor(np.asarray(p, dtype=np.float64))
    return su2.u3(p[0], p[1], p[2]).numpy()


def _sandwich(target_u, P):
    """Outer locals (A1, B1, A2, B2) with (A2 x B2) P (A1 x B1) in the
    target's local class made equal to it, from the two KAK forms."""
    from slam_decomposition_torch.transpile.kak import kak_form

    bf_t = kak_form(np.asarray(target_u))
    pf = kak_form(P)
    A2 = bf_t.l1 @ pf.l1.conj().T
    B2 = bf_t.r1 @ pf.r1.conj().T
    A1 = pf.l2.conj().T @ bf_t.l2
    B1 = pf.r2.conj().T @ bf_t.r2
    return A1, B1, A2, B2


def _locals_angles(A1, B1, A2, B2) -> np.ndarray:
    from slam_decomposition_torch.ops.su2 import u3_angles

    return np.array(u3_angles(A1) + u3_angles(B1) + u3_angles(A2) + u3_angles(B2))


def _exact_loss(target_u, U) -> float:
    tr = np.trace(np.asarray(target_u).conj().T @ U)
    return float(1.0 - (abs(tr) ** 2 + 4.0) / 20.0)


def _eval_np(fn, x, dev) -> np.ndarray:
    return fn(torch.as_tensor(np.asarray(x), dtype=torch.float64, device=dev)).cpu().numpy()


def drive_pulse_for_target(
    target_u: np.ndarray,
    gc: float,
    gg: float,
    t: float = 1.0,
    n_slices: int = 4,
    seed: int = 0,
    restarts: int = 32,
    threshold: float = 1e-10,
    mode: str = "class",
    device=DEFAULT_DEVICE,
):
    """Piecewise-constant 1Q drives realizing a target with ONE
    parallel-driven application (JAX trajectory.py:64-183).

    ``mode="class"``: fit the pulse to the target's local-equivalence class
    on the Makhlin residual (Adam 400, f32 LM 16, LM 16, ranked by the
    Makhlin functional), take the exact outer locals from the KAK sandwich,
    then polish pulse and locals together (10 LM iterations on the phase
    residual). Returns (params, certified loss, (A1, B1, A2, B2)) with
    (A2 x B2) @ U_pulse @ (A1 x B1) == target up to global phase.
    ``mode="exact"``: fit the pulse alone to the unitary (Adam 400, LM 12);
    returns (params, loss). ``threshold`` is unused, as in the JAX
    package."""
    from slam_decomposition_torch.opt import costs
    from slam_decomposition_torch.opt.gauss_newton import make_solver

    dev = resolve_device(device)
    n_params = 2 + 2 * n_slices
    eval_fn = _pulse_fn(gc, gg, t, n_slices)
    tgt = torch.as_tensor(np.asarray(target_u, dtype=np.complex128)[None], device=dev)
    rng = np.random.default_rng(seed)
    # physically scaled starts: phases over a period, drive amplitudes O(few)
    x0 = np.zeros((1, restarts, n_params))
    x0[..., :2] = rng.uniform(0, 2 * np.pi, (1, restarts, 2))
    x0[..., 2:] = rng.uniform(-4.0, 4.0, (1, restarts, 2 * n_slices))
    x0 = torch.as_tensor(x0, device=dev)

    if mode == "exact":
        solver = make_solver(eval_fn, n_params, adam_iters=400, lm_iters=12, device=dev)
        bx, bf = solver(x0, tgt)
        return bx[0].cpu().numpy(), float(bf[0])

    solver = make_solver(
        eval_fn, n_params, adam_iters=400, lm32_iters=16, lm_iters=16, residual="makhlin",
        final_cost_fn=costs.makhlin_functional_cost, device=dev,
    )
    bx, _ = solver(x0, tgt)
    params = bx[0].cpu().numpy()
    # the class fit leaves ~sqrt(loss) coordinate error in the sandwich:
    # polish pulse and the 12 local angles together to certification depth
    seed_full = np.concatenate([params, _locals_angles(*_sandwich(target_u, _eval_np(eval_fn, params, dev)))])
    full_fn = _with_locals(eval_fn, n_params)
    full = make_solver(full_fn, n_params + 12, device=dev)
    xf = full.polish(torch.as_tensor(seed_full, device=dev)[None], tgt, iters=10)[0].cpu().numpy()
    loss = _exact_loss(target_u, _eval_np(full_fn, xf, dev))
    loc = xf[n_params:]
    return xf[:n_params], loss, tuple(_u3(loc[3 * i : 3 * i + 3]) for i in range(4))


def sequence_core(plan, gc: float, gg: float, n_slices: int):
    """(core_fn, n_core) of a driven-pulse sequence: core_fn(x) evaluates
    pulse(t_1) [1q layer, pulse(t_j)]* as (..., 4, 4). Parameter layout:
    per pulse [phi_c, phi_g, gx[n_slices], gy[n_slices]], then the (m - 1)
    interior 1q layers of 6 u3 angles."""
    m = len(plan)
    per = 2 + 2 * n_slices
    n_core = m * per + max(m - 1, 0) * 6
    pulses = [_pulse_fn(gc, gg, plan[j], n_slices) for j in range(m)]

    def core_fn(x):
        U = pulses[0](x[..., :per])
        for j in range(1, m):
            lo = m * per + (j - 1) * 6
            U = pulses[j](x[..., j * per : (j + 1) * per]) @ (_layer(x[..., lo : lo + 6], U) @ U)
        return U

    return core_fn, n_core


def evaluate_drive_sequence(
    params, plan, gc: float, gg: float, n_slices: int, locals_=None, device=DEFAULT_DEVICE
) -> np.ndarray:
    """Unitary of a solved drive sequence; with ``locals_`` = (A1, B1, A2,
    B2), (A2 x B2) @ core @ (A1 x B1): the construction
    ``drive_sequence_for_target`` certifies."""
    core_fn, n_core = sequence_core(plan, gc, gg, n_slices)
    U = _eval_np(core_fn, np.asarray(params)[:n_core], resolve_device(device))
    if locals_ is not None:
        A1, B1, A2, B2 = (np.asarray(x) for x in locals_)
        U = np.kron(A2, B2) @ U @ np.kron(A1, B1)
    return U


def drive_sequence_for_target(
    target_u: np.ndarray,
    plan,
    gc: float = np.pi / 2,
    gg: float = 0.0,
    n_slices: int = 4,
    seed: int = 0,
    restarts: int = 32,
    device=DEFAULT_DEVICE,
):
    """Parallel-driven pulse SEQUENCE synthesis: pulse(t_1) [1q layer
    pulse(t_j)]* with exact outer 1Q locals, solved to certification depth
    (JAX trajectory.py:231-339). ``plan``: per-segment durations, e.g. [1.0,
    1.0] or [1.0, 0.5]. A Makhlin class fit of the core, the KAK sandwich's
    locals as seeds, two full polishes of 12 iterations, and where the
    certificate misses 1e-10 a direct full-parameter solve (Adam 600,
    phase residual) with the polished point as restart 0, the better of the
    two kept. Returns (params, certified loss, (A1, B1, A2, B2))."""
    from slam_decomposition_torch.opt import costs
    from slam_decomposition_torch.opt.gauss_newton import make_solver

    dev = resolve_device(device)
    core_fn, n_core = sequence_core(plan, gc, gg, n_slices)
    per = 2 + 2 * n_slices
    tgt = torch.as_tensor(np.asarray(target_u, dtype=np.complex128)[None], device=dev)
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, 2 * np.pi, (1, restarts, n_core))
    for j in range(len(plan)):  # physically scaled drive amplitudes
        x0[..., j * per + 2 : (j + 1) * per] = rng.uniform(-4.0, 4.0, (1, restarts, 2 * n_slices))
    solver = make_solver(
        core_fn, n_core, adam_iters=400, lm32_iters=16, lm_iters=16, residual="makhlin",
        final_cost_fn=costs.makhlin_functional_cost, device=dev,
    )
    bx, _ = solver(torch.as_tensor(x0, device=dev), tgt)
    params = bx[0].cpu().numpy()

    seed_full = np.concatenate([params, _locals_angles(*_sandwich(target_u, _eval_np(core_fn, params, dev)))])
    full_fn = _with_locals(core_fn, n_core)
    full = make_solver(full_fn, n_core + 12, device=dev)
    x = torch.as_tensor(seed_full, device=dev)[None]
    xf = full.polish(full.polish(x, tgt, iters=12), tgt, iters=12)[0].cpu().numpy()
    exact_loss = _exact_loss(target_u, _eval_np(full_fn, xf, dev))
    if exact_loss > 1e-10:
        # rescue: a direct full-parameter solve, the polished point as restart 0
        rescue = make_solver(full_fn, n_core + 12, adam_iters=600, lm32_iters=16, lm_iters=16, device=dev)
        rx0 = rng.uniform(-2 * np.pi, 2 * np.pi, (1, restarts, n_core + 12))
        rx0[0, 0] = xf
        cand = rescue(torch.as_tensor(rx0, device=dev), tgt)[0][0].cpu().numpy()
        cand_loss = _exact_loss(target_u, _eval_np(full_fn, cand, dev))
        if cand_loss < exact_loss:
            xf, exact_loss = cand, cand_loss
    loc = xf[n_core:]
    return xf[:n_core], exact_loss, tuple(_u3(loc[3 * i : 3 * i + 3]) for i in range(4))


def improved_cx(gc=np.pi / 2, gg=0.0, t=1.0, n_slices=4, **kw):
    """Parallel-driven CX on an iSwap-strength coupler: ONE driven
    application of duration t plus exact 1Q locals, solved to certification
    depth (``drive_pulse_for_target``'s keywords pass through)."""
    from slam_decomposition_torch.models.gates import CNOT

    return drive_pulse_for_target(CNOT.to_numpy(), gc, gg, t, n_slices, **kw)


def improved_swap_two_pulse(gc=np.pi / 2, gg=0.0, n_slices=4, **kw):
    """SWAP from TWO full-iSwap-time parallel-driven pulses with one interior
    1q layer, certified exact (the plan [1.0, 1.0];
    slam_decomposition_tpu/data/improved_swap_2pulse.json holds a solved
    instance)."""
    from slam_decomposition_torch.models.gates import SWAP

    return drive_sequence_for_target(SWAP.to_numpy(), [1.0, 1.0], gc=gc, gg=gg, n_slices=n_slices, **kw)


def improved_swap(gc=np.pi / 2, gg=0.0, n_slices=4, exact=False, seed=0, restarts=16, device=DEFAULT_DEVICE):
    """Parallel-driven SWAP: driven pulse(1.0) + 1q layer + driven pulse(0.5)
    + exact locals, 1.5 iSwap units of 2Q time. This plan is time-optimal
    but only asymptotically exact (~1e-5: the textbook SWAP needs a local
    layer inside the 1.0 pulse). ``exact=True`` solves the plan [0.5, 0.5,
    0.5] with the drives frozen at zero instead: three applications of one
    fixed sqiSwap-class gate, the plain u3 chain the kernels solve (one
    launch of each), exact to certification depth. Returns (params, loss,
    (A1, B1, A2, B2)); with ``exact``, params are the sequence's (drives and
    phases zero, the two interior layers)."""
    from slam_decomposition_torch.models.gates import SWAP, _const_gate
    from slam_decomposition_torch.models.templates import build_ansatz
    from slam_decomposition_torch.opt.gauss_newton import make_solver

    if not exact:
        return drive_sequence_for_target(
            SWAP.to_numpy(), [1.0, 0.5], gc=gc, gg=gg, n_slices=n_slices, seed=seed, restarts=restarts, device=device
        )
    dev = resolve_device(device)
    zero = np.zeros(n_slices)
    g = _const_gate("pd_sq_zero", 2, ham.smush_u(0.0, 0.0, gc, gg, zero, zero, t=0.5).numpy())
    a = build_ansatz([g, g, g])
    solver = make_solver(a.eval_fn, a.n_params, chain_gates=a.chain_gates, device=dev)
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(rng.uniform(0, 2 * np.pi, (1, restarts, a.n_params)), device=dev)
    tgt = torch.as_tensor(SWAP.to_numpy()[None], device=dev)
    bx, bf = solver(x0, tgt)
    x = bx[0].cpu().numpy()
    # template layers onto sequence params: drives and phases zero, interior
    # layers L_1, L_2; the exterior L_0, L_3 become the locals
    per = 2 + 2 * n_slices
    params = np.zeros(3 * per + 12)
    params[3 * per :] = x[6:18]
    return params, float(bf[0]), tuple(_u3(x[i : i + 3]) for i in (0, 3, 18, 21))
