"""The controls and the planted faults of the judgement: solver wrappers
that `harness.run` takes for the main flow (``overrides={"solver_wrap":
...}``), flow wrappers for the ks flow (``overrides={"flow_wrap": ...}``).

The main flow:

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

The ks flow:

- `KsF32Reference`: the control. The reference takes the program's place
  and assigns each target its depth in float32 (complex64 eigenphases),
  the precision below the float64 that the configuration states.
- `KsRaised`: the first target of each batch gets its depth raised by 1.
- `KsMissing`: the first target of each batch gets no depth (-1).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.flows.ks import KsOut
from benchmark.reference import ks as ks_reference
from benchmark.reference.coverage import config_coverage
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


class KsF32Reference:
    def __init__(self, config: dict):
        self.coverage = config_coverage(config)

    def warm(self, T, start_seed):
        pass

    def run_batch(self, T):
        return KsOut(ks_reference.depths(self.coverage, T.cpu().numpy().astype(np.complex64)))


class _KsAltered:
    def __init__(self, flow):
        self.flow = flow

    def warm(self, T, start_seed):
        self.flow.warm(T, start_seed)

    def run_batch(self, T):
        ks = self.flow.run_batch(T).ks.copy()
        self.alter(ks)
        return KsOut(ks)


class KsRaised(_KsAltered):
    @staticmethod
    def alter(ks):
        ks[0] += 1


class KsMissing(_KsAltered):
    @staticmethod
    def alter(ks):
        ks[0] = -1


KS_FAULTS = {"ks_raised": KsRaised, "ks_missing": KsMissing}


def overrides(flow: str, config: dict) -> dict:
    """The `harness.run` overrides that put a flow's control in place."""
    if flow == "ks":
        return {"flow_wrap": lambda _: KsF32Reference(config)}
    return {"solver_wrap": F32Certified}
