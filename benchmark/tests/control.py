"""The control and the planted faults of the judgement, as solver wrappers
that `harness.run` takes (``overrides={"solver_wrap": ...}``).

- `F32Certified`: the control. The program's own f32 path certifies: the
  solver's ranking pass (Adam, the f32 LM) and each target's best start,
  whose f32 ||r||^2 becomes the certificate; the f64 polish is skipped.
  The configuration states float64 certification, so this is the nearest
  precision below it.
- `StateUnchanged`: the solve hands back each target's first start as it
  came in, with the certificate of the real solve.
- `HalfLeftOut`: the second half of each chunk's targets is not solved;
  they get their first start and the certificate of the first half's.
- `AnswerAltered`: the first target of each chunk gets its first parameter
  moved by 1e-3 after the solve, its certificate kept.
"""

from __future__ import annotations

import torch

from slam_decomposition_torch.opt.gauss_newton import certificate


class _Wrapped:
    def __init__(self, solver):
        self.solver = solver
        self.n_params = solver.n_params
        self.path = solver.path


class F32Certified(_Wrapped):
    def solve(self, x0s, tgt):
        xs, fs = self.solver.rank(x0s, tgt)
        best = torch.argmin(fs, dim=1)
        rows = torch.arange(xs.shape[0], device=xs.device)
        return xs[rows, best].double(), certificate(fs[rows, best].double())


class StateUnchanged(_Wrapped):
    def solve(self, x0s, tgt):
        _, cost = self.solver.solve(x0s, tgt)
        return x0s[:, 0].clone(), cost


class HalfLeftOut(_Wrapped):
    def solve(self, x0s, tgt):
        h = x0s.shape[0] // 2
        x, cost = self.solver.solve(x0s[:h].contiguous(), tgt[:h].contiguous())
        rest = x0s.shape[0] - h
        return torch.cat([x, x0s[h:, 0]]), torch.cat([cost, cost[torch.arange(rest, device=cost.device) % h]])


class AnswerAltered(_Wrapped):
    def solve(self, x0s, tgt):
        x, cost = self.solver.solve(x0s, tgt)
        x = x.clone()
        x[0, 0] += 1e-3
        return x, cost


FAULTS = {"state_unchanged": StateUnchanged, "half_left_out": HalfLeftOut, "answer_altered": AnswerAltered}
