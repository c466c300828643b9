"""The main flow: the timed region of `pipeline.decompose_haar`, generalised
over the basis, built only from the port's public functions.

One batch of B targets goes through:

1. the depth of each target from the coverage set
   (`coverage.monodromy_ks_batch`), then max(k, first depth);
2. the targets bucketed by depth;
3. each bucket solved in chunks of exactly `chunk` targets x `restarts`
   starts (`opt.gauss_newton.make_solver` for `build_ansatz(cycle_gates(
   [basis], k))`: Adam, the f32 LM and the f64 polish, which certifies).
   The last chunk of a bucket is filled by cycling the bucket's own
   targets, as `decompose_haar` does. Starts are uniform in [0, 2 pi), drawn
   on the device from the flow's own `torch.Generator`;
4. each target keeps its best answer over every solve it took part in;
5. up to `rescue_rounds` rounds re-solve the targets still above the
   threshold one depth deeper than their last solve, capped at the last
   depth (for sqiSwap: `decompose_haar`'s rescue at k = 3);
6. each target's parameters at the depth of its best answer are gathered on
   the device and copied to the host, with its certified cost.

`decompose_haar` itself is not the entry: it draws its own targets, returns
no parameters, and warms itself up inside every call.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.opt.gauss_newton import make_solver

# the bench flow's schedule (JAX bench.py:88-91): Adam steps, f32 LM and f64
# polish iterations
ADAM_ITERS, LM32_ITERS, POLISH_ITERS = 100, 8, 6


def port_gate(spec: dict):
    """The port's Gate for a configuration's gate entry."""
    if spec["gate"] == "riswap":
        return gates.riswap(spec["alpha"])
    if spec["gate"] == "conversion_gain":
        return gates.conversion_gain_gate(spec["phi_c"], spec["phi_g"], spec["gc"], spec["gg"], spec["t"])
    raise ValueError(f"unknown gate kind {spec['gate']!r}")


@dataclasses.dataclass
class BatchOut:
    """What one batch answers, on the host: per target its depth from the
    coverage set (`ks`), the depth of its best answer (`depth`), that
    answer's certified square cost (`cost`, inf where no solve answered) and
    its parameters (`x[depth][row[i]]`); `answered`, the targets certified
    at or under the threshold."""

    ks: np.ndarray
    depth: np.ndarray
    cost: np.ndarray
    x: dict
    row: np.ndarray
    answered: int

    def params(self, i: int):
        d = int(self.depth[i])
        return self.x[d][self.row[i]] if d in self.x else None

    def sample(self, pick: np.ndarray) -> dict:
        """The answers for the targets ``pick``, as the judge takes them."""
        return {"ks": self.ks[pick], "depth": self.depth[pick], "cost": self.cost[pick],
                "x": [self.params(i) for i in pick]}


class Flow:
    def __init__(self, config: dict, traffic: dict, device: torch.device, start_seed: int, spans):
        self.device = device
        self.spans = spans
        self.chunk = traffic["chunk"]
        self.restarts, self.rounds = traffic["restarts"], traffic["rescue_rounds"]
        self.k_min, self.k_max = config["depths"]
        self.thresh = float(config["threshold"])
        basis = port_gate(config["basis"])
        self.coverage = gate_set_to_coverage(port_gate(config.get("coverage_gate") or config["basis"]), device=device)
        self.solvers, self.chain_gates = {}, {}
        for k in range(self.k_min, self.k_max + 1):
            a = build_ansatz(cycle_gates([basis], k))
            self.chain_gates[k] = torch.as_tensor(a.chain_gates, dtype=torch.complex128, device=device)
            s = make_solver(a.eval_fn, a.n_params, adam_iters=ADAM_ITERS, lm_iters=POLISH_ITERS,
                            lm32_iters=LM32_ITERS, chain_gates=a.chain_gates, device=device)
            if s.path != "kernels":
                raise RuntimeError(f"depth {k} takes the {s.path} path, not the chain kernels")
            self.solvers[k] = s
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(start_seed)
        self.launches = None  # a list of (kernel, k, lanes, iterations) while it is set
        self.depths_run = set()

    # ---------------------------------------------------------------- solves

    def _chunks(self, idx):
        """``idx`` in chunks of exactly ``chunk``, the last filled by cycling
        its own targets."""
        out = []
        for a in range(0, len(idx), self.chunk):
            part = idx[a : a + self.chunk]
            out.append(part if len(part) == self.chunk else np.resize(part, self.chunk))
        return out

    def _solve(self, T, jobs):
        """Solve each (k, targets) job on T at depth k, the targets' indices
        sent to the device in one copy: (their indices on the device, [(k, x
        (chunk, n) f64, cost (chunk,) f64)] on the device, not waited for)."""
        dev_idx = torch.as_tensor(np.concatenate([p for _, p in jobs]), device=self.device)
        out = []
        for j, (k, _) in enumerate(jobs):
            s = self.solvers[k]
            tgt = T[dev_idx[j * self.chunk : (j + 1) * self.chunk]]
            u = torch.rand((self.chunk, self.restarts, s.n_params), generator=self.gen, device=self.device,
                           dtype=torch.float64)
            x, cost = s.solve(u * (2 * math.pi), tgt)
            out.append((k, x, cost))
            self.depths_run.add(k)
            if self.launches is not None:
                lanes = self.chunk * self.restarts
                self.launches += [("adam", k, lanes, ADAM_ITERS), ("lm", k, lanes, LM32_ITERS),
                                  ("polish", k, self.chunk, POLISH_ITERS)]
        return dev_idx, out

    def _pass(self, T, idx, depth, best, records):
        """Solve targets ``idx`` at ``depth[idx]`` and keep each target's best
        answer: the least cost over its lanes, on the device (the lowest lane
        among equal costs; a NaN never wins), then against its best so far."""
        jobs = [(int(k), part) for k in np.unique(depth[idx]) for part in self._chunks(idx[depth[idx] == k])]
        if not jobs:
            return
        tgt, pending = self._solve(T, jobs)
        costs = torch.cat([c for *_, c in pending])
        costs = torch.where(torch.isnan(costs), math.inf, costs)
        B, L = T.shape[0], costs.shape[0]
        least = torch.full((B,), math.inf, dtype=costs.dtype, device=self.device)
        least.scatter_reduce_(0, tgt, costs, "amin")
        lanes = torch.where(costs == least[tgt], torch.arange(L, device=self.device), L)
        first = torch.full((B,), L, dtype=lanes.dtype, device=self.device).scatter_reduce_(0, tgt, lanes, "amin")
        least, first = least.cpu().numpy(), first.cpu().numpy()
        win = (first < L) & (least < best["cost"])
        best["cost"][win] = least[win]
        best["rec"][win] = len(records) + first[win] // self.chunk
        best["lane"][win] = first[win] % self.chunk
        records += [(k, x) for k, x, _ in pending]

    # ---------------------------------------------------------------- a batch

    def run_batch(self, T: torch.Tensor) -> BatchOut:
        B = T.shape[0]
        with self.spans("ks"):
            ks = monodromy_ks_batch(self.coverage, T)
        depth = np.maximum(ks, self.k_min)
        best = {"cost": np.full(B, np.inf), "rec": np.full(B, -1), "lane": np.zeros(B, dtype=np.int64)}
        records = []
        with self.spans("solve"):
            self._pass(T, np.arange(B), depth, best, records)
        with self.spans("rescue"):
            for _ in range(self.rounds):
                stuck = np.where(~(best["cost"] <= self.thresh))[0]
                if len(stuck) == 0:
                    break
                depth[stuck] = np.minimum(depth[stuck] + 1, self.k_max)
                self._pass(T, stuck, depth, best, records)
        with self.spans("gather"):
            return self._gather(ks, best, records)

    def _gather(self, ks, best, records) -> BatchOut:
        B = len(ks)
        rec_depth = np.array([k for k, _ in records] + [0])
        out_depth = rec_depth[best["rec"]]  # rec -1: no answer, depth 0
        row = np.zeros(B, dtype=np.int64)
        xs = {}
        for d in np.unique(out_depth[best["rec"] >= 0]):
            d = int(d)
            recs = [j for j, (k, _) in enumerate(records) if k == d]
            offset = np.zeros(len(records), dtype=np.int64)
            offset[recs] = np.cumsum([0] + [records[j][1].shape[0] for j in recs[:-1]])
            idx = np.where((best["rec"] >= 0) & (out_depth == d))[0]
            rows = torch.as_tensor(offset[best["rec"][idx]] + best["lane"][idx], device=self.device)
            xs[d] = torch.cat([records[j][1] for j in recs])[rows].cpu().numpy()
            row[idx] = np.arange(len(idx))
        return BatchOut(ks=ks, depth=out_depth, cost=best["cost"], x=xs, row=row,
                        answered=int((best["cost"] <= self.thresh).sum()))

    # ---------------------------------------------------------------- set-up

    def warm(self, T: torch.Tensor, start_seed: int) -> None:
        """One batch on ``T``, then one chunk at each depth from the least
        that batch assigned to the last that it did not reach, from starts of
        a generator of their own; the window's generator is left as it was."""
        window_gen, self.gen = self.gen, torch.Generator(device=self.device)
        self.gen.manual_seed(start_seed)
        out = self.run_batch(T)
        least = int(max(out.ks.min(), self.k_min))
        for k in range(least, self.k_max + 1):
            if k not in self.depths_run:
                self._solve(T, [(k, np.arange(self.chunk) % T.shape[0])])
        self.gen = window_gen
