"""TemplateOptimizer: batched multi-start variational synthesis (JAX
opt/optimizer.py).

The four-object idiom of the JAX package: a basis (a function k -> Ansatz), an
objective, the optimizer, and the targets. A whole distribution of targets
is solved per template depth k, every target from ``training_restarts``
random starts at once, with a best-over-restarts reduction and a per-target
early exit over k.

Which solver runs (``TemplateOptimizer._solver_for``):

* ``method="auto"`` with the square or basic objective rides the phase
  residual, the reduced / Weyl / Makhlin objectives the Makhlin residual,
  both through ``gauss_newton.make_solver``: a plain u3 chain of depth 1..79
  under the square objective takes the three CUDA kernels, everything else
  the general solver in plain PyTorch;
* ``method="gauss_newton"`` takes the phase residual for an objective
  without one, and with a cost ceiling too (which that path ignores, as the
  JAX package's does);
* any other objective, a cost ceiling (``constraint_max_cost``) under
  ``method="auto"``, or ``method="lbfgs"`` takes the batched L-BFGS
  (``minimize.lbfgs``), the ceiling as an exterior penalty.

Random starts come from a ``torch.Generator`` on the CPU seeded by ``seed``
and are then moved, so a result does not depend on the device. Only the
targets still unsolved at a depth are solved there, in chunks of
``chunk_size`` targets that bound memory; no chunk is padded.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from slam_decomposition_torch import config
from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.models.templates import Ansatz
from slam_decomposition_torch.ops import weyl
from slam_decomposition_torch.opt import costs as cost_lib
from slam_decomposition_torch.opt.gauss_newton import make_solver
from slam_decomposition_torch.opt.minimize import lbfgs
from slam_decomposition_torch.utils import profiling

# targets per solver call: bounds the device memory of one call (at 5
# restarts 81920 lanes; the general path's Adam keeps every intermediate of
# eval_fn for the reverse pass)
CHUNK = 16384
# the quartic Makhlin landscape needs a longer warm start and more LM steps
# than the phase residual (the JAX package's tuning)
MAKHLIN_ITERS = dict(adam_iters=250, lm32_iters=16, lm_iters=10)
MAKHLIN_FAMILY = ("square_reduced", "basic_reduced", "makhlin_functional", "makhlin_euclidean", "weyl_euclidean")


@dataclasses.dataclass
class SynthesisResult:
    """Per-target outcome."""

    success: np.ndarray  # (B,) bool
    loss: np.ndarray  # (B,)
    params: np.ndarray  # (B, n_max) padded
    cycles: np.ndarray  # (B,) chosen k
    n_params: np.ndarray  # (B,) valid length of params


class TemplateOptimizer:
    def __init__(
        self,
        basis: Union[Ansatz, Callable[[int], Ansatz]],
        objective: Union[str, Callable] = "square",
        success_threshold: Optional[float] = None,
        training_restarts: Optional[int] = None,
        max_iters: Optional[int] = None,
        spanning_range: Optional[Sequence[int]] = None,
        seed: int = 0,
        override_fail: bool = False,
        constraint_max_cost: Optional[float] = None,
        penalty_weight: float = 10.0,
        use_callback: bool = False,
        method: str = "auto",
        preseed: bool = False,
        preseed_key: Optional[str] = None,
        chunk_size: Optional[int] = None,
        device=DEFAULT_DEVICE,
    ):
        """``basis``: an Ansatz, or a function k -> Ansatz tried over
        ``spanning_range`` (default 1..5) with per-target early exit.
        ``objective``: a name in ``costs.COSTS`` or a function (U, tgt) ->
        cost. ``method``: "auto" (Adam + LM where the objective has a
        residual, else L-BFGS), "gauss_newton" or "lbfgs". ``use_callback``
        records the Adam and LM loss histories per depth. ``preseed`` keeps
        solved decompositions by Weyl coordinate and seeds restart 0 from
        the nearest one. Runs on the card unless ``device`` names another."""
        self.device = resolve_device(device)
        if isinstance(basis, Ansatz):
            fixed = basis
            self.builder = lambda k: fixed
            spanning_range = spanning_range or [fixed.k]
        else:
            self.builder = basis  # k -> Ansatz (the JAX package's name)
        self.basis = self.builder
        self.spanning_range = list(spanning_range or range(1, 6))
        self.objective = cost_lib.COSTS[objective] if isinstance(objective, str) else objective
        self.success_threshold = config.success_threshold if success_threshold is None else success_threshold
        self.training_restarts = config.training_restarts if training_restarts is None else training_restarts
        self.max_iters = config.max_opt_iters if max_iters is None else max_iters
        self.seed = seed
        self.chunk_size = chunk_size
        self.override_fail = override_fail
        self.constraint_max_cost = constraint_max_cost
        self.penalty_weight = penalty_weight
        self.use_callback = use_callback
        self.method = method
        self.preseed_store = None
        if preseed:
            from slam_decomposition_torch.opt.preseed import PreseedStore

            self.preseed_store = PreseedStore.load(preseed_key or self._default_preseed_key())
        self.training_loss: list = []  # per call: final losses
        self.training_history: list = []  # per k: (B, R, iters) Adam losses
        self.training_history_lm: list = []  # per k: (B, lm_iters) polish ||r||^2
        self.coordinate_list: list = []
        self.solver_paths: dict = {}  # k -> "kernels" | "general" | "lbfgs"
        self.k_seconds: dict = {}  # k -> host seconds of the last call's solve at that depth
        self.lbfgs_stats: list = []  # per L-BFGS call: {"evals", "syncs", "iters"}
        self._solver_cache: dict = {}
        self._history = ([], [])  # the current depth's (Adam, LM) histories, per chunk

    # ------------------------------------------------------------------

    def _default_preseed_key(self) -> str:
        """A store key from the template's content, the same in every
        process: the ansatz of the smallest k evaluated at a fixed probe,
        rounded to 8 decimals, hashed."""
        a = self.builder(min(self.spanning_range))
        U = a.eval_fn(torch.linspace(0.1, 1.7, a.n_params, dtype=torch.float64)).numpy()
        payload = (  # + 0.0 turns -0.0 into 0.0: the same bytes for the same matrix
            (np.round(U.real, 8) + 0.0).tobytes()
            + (np.round(U.imag, 8) + 0.0).tobytes()
            + f"{a.n_qubits}_{a.k}_{a.n_params}_{self.spanning_range}".encode()
        )
        return f"preseed_{hashlib.sha1(payload).hexdigest()[:16]}"

    def _residual_for(self):
        """(residual, final_cost_fn) of the Adam + LM path for this
        objective, or (None, None) where only L-BFGS serves. As in the JAX
        package (its optimizer.py:153-173), ``method="gauss_newton"`` always
        takes the Adam + LM path, on the phase residual where the objective
        has none of its own or a cost ceiling is set; that path ignores the
        ceiling."""
        if self.method == "gauss_newton" and self.constraint_max_cost is not None:
            return "phase", None
        if self.constraint_max_cost is not None or self.method not in ("auto", "gauss_newton"):
            return None, None
        if self.objective is cost_lib.COSTS["square"]:
            return "phase", None
        if self.objective is cost_lib.COSTS["basic"]:
            return "phase", self.objective
        if any(self.objective is cost_lib.COSTS[name] for name in MAKHLIN_FAMILY):
            return "makhlin", self.objective
        if self.method == "gauss_newton":
            return "phase", None
        return None, None

    def _solver_for(self, k: int, ansatz: Ansatz):
        """solve(x0s (m, R, n), tgt (m, d, d)) -> (x (m, n), f (m,)) on the
        optimizer's device for the depth-k ansatz, and the name of its path."""
        if k in self._solver_cache:
            return self._solver_cache[k]
        lower = ansatz.lower if ansatz.use_bounds else None
        upper = ansatz.upper if ansatz.use_bounds else None
        residual, final_cost = self._residual_for()
        if residual is not None:
            base = make_solver(
                ansatz.eval_fn, ansatz.n_params, lower=lower, upper=upper, residual=residual,
                final_cost_fn=final_cost, chain_gates=ansatz.chain_gates, device=self.device,
                **(MAKHLIN_ITERS if residual == "makhlin" else {}),
            )

            def solve(x0s, tgt):
                if not self.use_callback:
                    return base.solve(x0s, tgt)
                xs, fs, hist, lm_hist = base.with_history(x0s, tgt)
                self._history[0].append(hist.cpu().numpy())
                self._history[1].append(lm_hist.cpu().numpy())
                return xs, fs

            out = (solve, base.path)
        else:
            out = (self._lbfgs_solver(ansatz, lower, upper), "lbfgs")
        self._solver_cache[k] = out
        return out

    def _lbfgs_solver(self, ansatz: Ansatz, lower, upper):
        objective, cost_fn = self.objective, ansatz.cost_fn
        ceiling, weight = self.constraint_max_cost, self.penalty_weight
        bounds = [None if b is None else torch.as_tensor(b, dtype=torch.float64, device=self.device) for b in (lower, upper)]

        def solve(x0s, tgt):
            m, R, n = x0s.shape
            lanes_t = tgt.repeat_interleave(R, dim=0)

            def loss(x):
                val = objective(ansatz.eval_fn(x), lanes_t)
                if ceiling is not None and cost_fn is not None:
                    # exterior penalty for circuit_cost(x) <= ceiling
                    val = val + weight * torch.clamp(cost_fn(x) - ceiling, min=0.0) ** 2
                return val

            res = lbfgs(
                loss, x0s.reshape(m * R, n), max_iters=self.max_iters, f_tol=self.success_threshold * 0.5,
                g_tol=1e-14, lower=bounds[0], upper=bounds[1],
            )
            self.lbfgs_stats.append({"evals": res.n_evals, "syncs": res.n_syncs, "iters": int(res.n_iters.sum())})
            f = res.f.view(m, R)
            best = torch.argmin(f, dim=1)
            rows = torch.arange(m, device=f.device)
            return res.x.view(m, R, n)[rows, best], f[rows, best]

        return solve

    def _init_params(self, gen: torch.Generator, ansatz: Ansatz, batch: int, restarts: int) -> torch.Tensor:
        """(batch, restarts, n) f64 uniform in the ansatz's box, on the CPU
        (the span ``optimizer.starts``)."""
        with profiling.span("optimizer.starts"):
            lo = torch.as_tensor(ansatz.lower, dtype=torch.float64)
            hi = torch.as_tensor(ansatz.upper, dtype=torch.float64)
            u = torch.rand((batch, restarts, ansatz.n_params), generator=gen, dtype=torch.float64)
            return lo + u * (hi - lo)

    # ------------------------------------------------------------------

    def approximate_from_distribution(
        self,
        targets,
        spanning_ranges: Optional[Sequence[Sequence[int]]] = None,
    ) -> SynthesisResult:
        """Solve a batch of targets, (B, d, d) complex numpy or tensor (or
        one (d, d) target). ``spanning_ranges`` optionally gives each target
        its own list of k (its exact monodromy range, say); the default is
        the shared spanning range with per-target early exit."""
        tgt = torch.as_tensor(targets)
        if tgt.ndim == 2:
            tgt = tgt[None]
        tgt = tgt.to(device=self.device, dtype=torch.complex128)
        B = tgt.shape[0]
        ks = sorted(set(self.spanning_range))
        per_target_ks = None
        if spanning_ranges is not None:
            per_target_ks = [list(r) for r in spanning_ranges]
            ks = sorted(set(k for r in per_target_ks for k in r))

        target_coords = None
        if self.preseed_store is not None or self.use_callback:
            target_coords = weyl.c1c2c3(tgt).cpu().numpy()

        n_max = max(self.builder(k).n_params for k in ks)
        best_loss = np.full(B, np.inf)
        best_x = np.zeros((B, n_max))
        best_k = np.full(B, -1, dtype=int)
        best_np = np.zeros(B, dtype=int)
        solved = np.zeros(B, dtype=bool)

        gen = torch.Generator()
        gen.manual_seed(self.seed)
        chunk = self.chunk_size or CHUNK
        for k in ks:
            active = ~solved
            if per_target_ks is not None:
                active = active & np.array([k in r for r in per_target_ks])
            if not active.any():
                continue
            t0 = time.perf_counter()
            ansatz = self.builder(k)
            solver, self.solver_paths[k] = self._solver_for(k, ansatz)
            x0s = self._init_params(gen, ansatz, B, self.training_restarts)
            if self.preseed_store is not None and len(self.preseed_store):
                seeds, ok = self.preseed_store.seeds_for(target_coords, ansatz.n_params, cycles=k, temperature=1.0)
                x0s[torch.as_tensor(ok), 0, :] = torch.as_tensor(seeds[ok])
            idx = np.where(active)[0]
            self._history = ([], [])
            out = []
            for s in range(0, len(idx), chunk):  # every chunk is launched before any is read
                part = torch.as_tensor(idx[s : s + chunk])
                out.append(solver(x0s[part].to(self.device), tgt[part.to(self.device)]))
            xs = torch.cat([x for x, _ in out]).cpu().numpy()
            fs = torch.cat([f for _, f in out]).cpu().numpy()  # waits for the device
            self.k_seconds[k] = time.perf_counter() - t0
            if self._history[0]:
                self.training_history.append(np.concatenate(self._history[0]))
                self.training_history_lm.append(np.concatenate(self._history[1]))
            improve = fs < best_loss[idx]
            won = idx[improve]
            best_loss[won] = fs[improve]
            best_k[won] = k
            best_np[won] = ansatz.n_params
            best_x[won, : ansatz.n_params] = xs[improve]
            solved[idx] |= fs <= self.success_threshold

        if self.use_callback:
            self.coordinate_list.append(target_coords)

        # keep the solved decompositions for later preseeding
        if self.preseed_store is not None:
            solved_idx = np.where(best_loss <= self.success_threshold)[0]
            if len(solved_idx):
                self.preseed_store.add(
                    target_coords[solved_idx], best_x[solved_idx], best_k[solved_idx], best_loss[solved_idx]
                )
                self.preseed_store.save()

        success = best_loss <= self.success_threshold
        if not success.all() and not self.override_fail:
            raise ValueError(
                f"{int((~success).sum())}/{B} targets failed to converge below "
                f"{self.success_threshold} (worst loss {float(best_loss.max()):.3e}). Increase "
                "restarts/spanning range or set override_fail=True."
            )
        self.training_loss.append(best_loss)
        return SynthesisResult(success=success, loss=best_loss, params=best_x, cycles=best_k, n_params=best_np)

    def approximate_target_U(self, target_U) -> SynthesisResult:
        """One target."""
        return self.approximate_from_distribution(np.asarray(target_U)[None])

    # ------------------------------------------------------------------

    def cost_from_distribution(self, targets, mixed_template=None):
        """Total polytope cost over a distribution without fitting 1Q
        parameters (JAX optimizer.py:442-451). Needs a coverage-backed
        template (``coverage.mixed.MixedOrderBasisTemplate``)."""
        if mixed_template is None:
            raise ValueError(
                "pass a MixedOrderBasisTemplate: this cost needs a coverage-backed template"
            )
        return mixed_template.cost_from_distribution(targets)
