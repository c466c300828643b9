"""Batched sqiSwap synthesis for the transpile layer (JAX
transpile/batch_synth.py).

`sqiswap_decompose` (transpile/kak.py) is exact but host-serial: one numpy
KAK + interleave solve per 2Q block. This module runs the same synthesis as
one batched device program per k-class: the f64 analytic init
(ops/kak_batch.make_analytic_init) seeds the f64 LM polish (the
``polish_chain`` kernel on CUDA, its plain version on the CPU), and the
host emits the same step format. Every emitted block is re-certified on the
host against the 1e-10 trace-infidelity bar that `sqiswap_decompose`
itself enforces; a lane that misses it (and every k <= 1 block, where
synthesis is trivial) takes the exact host routine, so the result contract
is unchanged.

The JAX package's TPU tiers are not copied: there is no f32 init padded to
256-lane chunks and no second f64 init on the CPU; with native f64 on the
device one tier places every lane, and the polish is launched once per
k-class.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.opt.gauss_newton import make_analytic_solver
from slam_decomposition_torch.opt.samplers import sqiswap_count_batch
from slam_decomposition_torch.transpile.kak import SQISWAP_M, sqiswap_decompose


def _u3_np_batch(t, p, l):
    """(...,) angle arrays -> (..., 2, 2) qiskit-convention U batch."""
    ct, st = np.cos(t / 2.0), np.sin(t / 2.0)
    out = np.empty(t.shape + (2, 2), dtype=complex)
    out[..., 0, 0] = ct
    out[..., 0, 1] = -np.exp(1j * l) * st
    out[..., 1, 0] = np.exp(1j * p) * st
    out[..., 1, 1] = np.exp(1j * (p + l)) * ct
    return out


def _params_to_steps_batch(xs: np.ndarray, k: int, Us: np.ndarray, atol: float) -> List:
    """Flat ansatz params (m, 6*(k+1)) -> a sqiswap_decompose step list per
    lane, or None where the emitted steps miss the trace-infidelity bar.
    One numpy pass builds every lane's u3 layers, chains them and certifies
    all traces; step-list emission for passing lanes is slicing of those
    layer arrays. The block's global phase is folded in as a ("phase", ...)
    step, as the host routine does, so steps_to_matrix(steps) reproduces U
    with phase. Lanes with non-finite params or traces fail (NaN compares
    false) and give None."""
    m = len(xs)
    if m == 0:
        return []
    with np.errstate(invalid="ignore"):
        x = np.asarray(xs, dtype=float).reshape(m, k + 1, 6)
        A = _u3_np_batch(x[..., 0], x[..., 1], x[..., 2])  # (m, k+1, 2, 2)
        Bm = _u3_np_batch(x[..., 3], x[..., 4], x[..., 5])
        L = np.einsum("mkab,mkcd->mkacbd", A, Bm).reshape(m, k + 1, 4, 4)
        V = L[:, 0]
        for layer in range(1, k + 1):
            V = np.einsum("ij,mjl->mil", SQISWAP_M, V)
            V = np.einsum("mij,mjl->mil", L[:, layer], V)
        tr = np.einsum("mij,mij->m", np.conj(V), Us)
        infid = 1.0 - np.abs(tr) / 4.0
        phases = np.angle(tr)
    out: List = []
    for i in range(m):
        if not (np.isfinite(infid[i]) and infid[i] <= atol):
            out.append(None)
            continue
        steps: List = [("phase", float(phases[i]))]
        for layer in range(k + 1):
            steps.append(("1q", (A[i, layer], Bm[i, layer])))
            if layer < k:
                steps.append(("sqiswap", None))
        out.append(steps)
    return out


def _product_steps_batch(Us: np.ndarray, atol: float):
    """Vectorized k=0 synthesis: each U is (within the k-assignment
    tolerance) e^{i phase} kron(l, r), recovered by the rank-1
    rearrangement in one numpy pass (the closed form of kak.py:83-94
    without the per-block SVD: the dominant row of the rearrangement is the
    right factor of a product gate). Returns a step list per block, or None
    where the product form misses the bar (a non-product block inside the
    identity-class tolerance band goes to the exact host routine)."""
    B = len(Us)
    # non-product blocks inside the k=0 band give near-zero dets/norms; the
    # NaN/inf infidelity is rejected below
    with np.errstate(invalid="ignore", divide="ignore"):
        R = Us.reshape(B, 2, 2, 2, 2).transpose(0, 1, 3, 2, 4).reshape(B, 4, 4)
        norms = (np.abs(R) ** 2).sum(axis=2)
        i0 = norms.argmax(axis=1)
        ar = np.arange(B)
        rvec = R[ar, i0]
        lvec = np.einsum("bij,bj->bi", R, rvec.conj()) / norms[ar, i0][:, None]
        l = lvec.reshape(B, 2, 2)
        r = rvec.reshape(B, 2, 2)
        dl = l[:, 0, 0] * l[:, 1, 1] - l[:, 0, 1] * l[:, 1, 0]
        dr = r[:, 0, 0] * r[:, 1, 1] - r[:, 0, 1] * r[:, 1, 0]
        l = l / np.sqrt(dl)[:, None, None]
        r = r / np.sqrt(dr)[:, None, None]
        V = np.einsum("bik,bjl->bijkl", l, r).reshape(B, 4, 4)
        tr = np.einsum("bij,bij->b", V.conj(), Us)
        infid = 1.0 - np.abs(tr) / 4.0
    phases = np.angle(tr)
    out = []
    for i in range(B):
        if np.isfinite(infid[i]) and infid[i] <= atol:
            out.append([("phase", float(phases[i])), ("1q", (l[i], r[i]))])
        else:
            out.append(None)
    return out


class _StageClock:
    """Adds the seconds since the last mark to ``times[stage]``; the device
    is synchronised before each clock read. Does nothing without ``times``."""

    def __init__(self, device: torch.device, times: Optional[dict]):
        self.device = device
        self.times = times
        self.last = self._now()

    def _now(self) -> float:
        if self.times is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, stage: str) -> None:
        if self.times is None:
            return
        now = self._now()
        self.times[stage] = self.times.get(stage, 0.0) + now - self.last
        self.last = now


def sqiswap_decompose_batch(
    Us: np.ndarray,
    atol: float = 1e-10,
    stats: Optional[dict] = None,
    device=DEFAULT_DEVICE,
    times: Optional[dict] = None,
) -> List[Tuple[list, int]]:
    """Batched `sqiswap_decompose` over a (B, 4, 4) block array.

    Returns a list of (steps, n) in block order, with the host routine's
    contract (steps reproduce each block to trace infidelity <= atol, phase
    included). The k in {2, 3} blocks of each class are synthesized in one
    call on ``device``: the analytic init, then one polish launch. k <= 1
    blocks and uncertified lanes use the exact host path.

    ``stats`` (if given) records {"device": blocks emitted from the device
    solve, "fallback": uncertified lanes re-done by the host routine,
    "trivial": k <= 1 blocks}; the three sum to B. The JAX package's
    "f64_rescue" key counted its second (CPU f64) tier, which the port does
    not have. ``times`` (if given) accumulates seconds per stage: "count",
    "init", "polish" (polish and the device certificate) and "emit" (host
    certification, step emission and every host-routine block). Runs on the
    card unless ``device`` names another.
    """
    device = resolve_device(device)
    clock = _StageClock(device, times)
    Us = np.asarray(Us, dtype=complex)
    B = len(Us)
    counts = np.atleast_1d(sqiswap_count_batch(Us, device=device))
    clock("count")
    results: List = [None] * B
    n_device = n_fallback = 0

    trivial_idx = np.where(counts <= 1)[0]
    zeros = trivial_idx[counts[trivial_idx] == 0]
    if len(zeros):
        for i, steps in zip(zeros, _product_steps_batch(Us[zeros], atol)):
            if steps is not None:
                results[i] = (steps, 0)
    for i in trivial_idx:
        if results[i] is None:
            results[i] = sqiswap_decompose(Us[i])
    clock("emit")

    for k in (2, 3):
        idx = np.where(counts == k)[0]
        if len(idx) == 0:
            continue
        solver = make_analytic_solver(k, device)
        tgt = torch.as_tensor(Us[idx]).to(device)
        x = solver.init_only(tgt)
        clock("init")
        x, loss = solver.repolish(x, tgt)
        xs, losses = x.cpu().numpy(), loss.cpu().numpy()
        clock("polish")
        # certify + emit the k-class in one vectorized pass, over the lanes
        # whose device certificate passed (a lane over the bar is re-done
        # by the host routine regardless)
        ok_idx = np.where(losses <= atol)[0]
        all_steps: List = [None] * len(idx)
        for j, s in zip(ok_idx, _params_to_steps_batch(xs[ok_idx], k, Us[idx[ok_idx]], atol)):
            all_steps[j] = s
        for j, i in enumerate(idx):
            if all_steps[j] is None:
                results[i] = sqiswap_decompose(Us[i])
                n_fallback += 1
            else:
                results[i] = (all_steps[j], k)
                n_device += 1
        clock("emit")

    if stats is not None:
        stats["device"] = n_device
        stats["fallback"] = n_fallback
        stats["trivial"] = len(trivial_idx)
    return results
